"""The card's idle time put down to the program's own spans.

The program records spans at its layer boundaries (``repro_torch.spans``:
``codesign.*``, ``ga.*``, ``trainer.*``, ``model.*``), on the same
``time.perf_counter`` clock as the harness's spans and, through the marker
kernel, the profiler's device records (``tracing.Trace``).  Each instant of
the traced part in which no kernel ran goes to the innermost program span
open then, or to none.  Innermost is the shortest, the rule by which
``Trace.breakdown`` names a gap: for nested spans it is the one that
started last, and spans of two threads that overlap without nesting get
one answer from both.  One sweep over the sorted span edges and idle
intervals does it: a traced search holds hundreds of thousands of kernels
and thousands of spans.

``GROUPS`` names the spans each per-layer metric reads; every span the
program records is in one group, or is a root, whose own share is what its
stages leave uncovered.
"""

from __future__ import annotations

import heapq

from cardbench.tracing import merged

__all__ = ["PROGRAM", "ROOTS", "GROUPS", "program_spans", "idle_intervals", "idle_by_span",
           "idle_share_pct"]

PROGRAM = ("codesign.", "ga.", "trainer.", "model.")  # the program's span names begin so
ROOTS = ("codesign.search", "model.prefill")
GROUPS = {
    "idle_evaluator_setup_pct": ("codesign.build", "trainer.capture"),
    "idle_row_prep_pct": ("trainer.draw", "trainer.stage"),
    "idle_launch_pct": ("trainer.enqueue",),
    "idle_ga_pct": ("ga.variation", "ga.plan", "ga.commit", "codesign.decode", "codesign.area"),
    "idle_layers_pct": ("model.layer", "model.head"),
    "idle_model_inputs_pct": ("model.inputs",),
}


def program_spans(items) -> list[tuple[str, float, float]]:
    """The program's spans among ``(name, t0, t1)`` items (the harness's left out)."""
    return [(n, a, b) for n, a, b in items if n.startswith(PROGRAM)]


def idle_intervals(kernels, t0: float, t1: float) -> list[tuple[float, float]]:
    """The sorted stretches of [t0, t1] in which none of ``kernels``
    (``(name, start, end)``) ran."""
    out, at = [], t0
    for a, b in merged([(max(a, t0), min(b, t1)) for _, a, b in kernels if b > t0 and a < t1]):
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if t1 > at:
        out.append((at, t1))
    return out


def idle_by_span(spans, kernels, t0: float, t1: float) -> tuple[dict[str, float], float]:
    """``({span name: idle seconds}, idle seconds under no span)`` over [t0, t1].

    ``spans`` are ``(name, start, end)``; the two parts add up to the idle
    total of :func:`idle_intervals`.
    """
    # a span that closes at t ends before one that opens at t
    edges = sorted([(a, 1, i) for i, (_, a, b) in enumerate(spans) if b > a]
                   + [(b, 0, i) for i, (_, a, b) in enumerate(spans) if b > a])
    is_open = [False] * len(spans)
    heap: list[tuple[float, str, int]] = []  # (length, name, index): innermost on top
    by_name: dict[str, float] = {}
    none = 0.0
    e = 0

    def apply(edge) -> None:
        _, opens, i = edge
        is_open[i] = bool(opens)
        if opens:
            name, a, b = spans[i]
            heapq.heappush(heap, (b - a, name, i))

    def credit(dt: float) -> None:
        nonlocal none
        while heap and not is_open[heap[0][2]]:
            heapq.heappop(heap)
        if heap:
            name = spans[heap[0][2]][0]
            by_name[name] = by_name.get(name, 0.0) + dt
        else:
            none += dt

    for a, b in idle_intervals(kernels, t0, t1):
        while e < len(edges) and edges[e][0] <= a:
            apply(edges[e])
            e += 1
        at = a
        while e < len(edges) and edges[e][0] < b:
            credit(edges[e][0] - at)
            at = edges[e][0]
            apply(edges[e])
            e += 1
        credit(b - at)
    return by_name, none


def idle_share_pct(run, names) -> float | None:
    """The idle time put down to the program spans ``names``, as a share of
    the traced part's length; None without a trace or without such a span."""
    trace = run.trace
    if trace.t0 is None or trace.window_s <= 0:
        return None
    spans = program_spans(run.spans.items)
    if not any(n in names for n, _, _ in spans):
        return None
    by_name, _ = idle_by_span(spans, trace.kernels, trace.t0, trace.t1)
    return 100.0 * sum(by_name.get(n, 0.0) for n in names) / trace.window_s
