"""The harness's own spans and the profiler over the traced part of a window.

Spans are kept in memory, one ``(name, start, end)`` on the host's
``time.perf_counter`` clock a call the harness makes into a layer of the
program.  With ``--trace 1`` the profiler records the device's kernels
from the window's start until the first unit boundary after the cell's
``trace_seconds`` (the driver calls :meth:`Trace.boundary`); the device is
synchronised first, so every kernel launched inside the traced part is in
it.  A short traced part keeps the profiler's records (a co-design step
is a hundred small kernels, 0.25 ms in all) to what can be read back
within the run's time.
"""

from __future__ import annotations

import contextlib
import time

__all__ = ["Spans", "Trace", "merged", "union_s"]


class Spans:
    """Host-clock spans ``(name, t0, t1)`` of the harness's calls."""

    def __init__(self):
        self.items: list[tuple[str, float, float]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.items.append((name, t0, time.perf_counter()))

    def within(self, t0: float, t1: float, names=None) -> list[tuple[str, float, float]]:
        return [(n, a, b) for n, a, b in self.items
                if b > t0 and a < t1 and (names is None or n in names)]


def merged(intervals) -> list[tuple[float, float]]:
    """The union of ``(start, end)`` intervals as disjoint sorted intervals."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def union_s(intervals, t0: float, t1: float) -> float:
    """Seconds of [t0, t1] that the intervals cover."""
    return sum(max(0.0, min(b, t1) - max(a, t0)) for a, b in merged(intervals))


class Trace:
    """The profiler over the first ``seconds`` of a window (off unless ``on``)."""

    def __init__(self, torch, on: bool, seconds: float):
        self.torch, self.on, self.seconds = torch, on, seconds
        self.prof = None
        self.t0 = self.t1 = None
        self.kernels: list[tuple[str, float, float]] = []  # name, host start, host end
        self.active = False
        self.pause = (0.0, 0.0)  # host clock: stopping and reading the profiler

    def start(self) -> None:
        if not self.on:
            return
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        # a marker kernel ties the profiler's clock to the host's
        self._mark = time.perf_counter()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        self.active = True

    def boundary(self) -> None:
        """Called between units of work: ends the traced part once it is long enough."""
        if self.active and time.perf_counter() - self.t0 >= self.seconds:
            self.stop()

    def stop(self) -> None:
        if not self.active:
            return
        self.torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()
        self.active = False
        self._read()
        self.pause = (self.t1, time.perf_counter())

    def paused_s(self, t0: float, t1: float) -> float:
        """Seconds of [t0, t1] the harness spent stopping and reading the profiler:
        a rate over a window the trace ended inside leaves them out."""
        return max(0.0, min(self.pause[1], t1) - max(self.pause[0], t0))

    def _read(self) -> None:
        cuda = self.torch.autograd.DeviceType.CUDA
        # the raw records: building the profiler's event tree would take
        # minutes for the hundreds of thousands of kernels of a traced part
        events = [(e.name(), e.start_ns(), e.duration_ns())
                  for e in self.prof.profiler.kineto_results.events()
                  if e.device_type() == cuda]
        marks = [s for n, s, _ in events if "spin_kernel" in n or "sleep" in n.lower()]
        if not marks:
            raise RuntimeError("the profiler recorded no marker kernel: no device trace")
        offset = self._mark - min(marks) * 1e-9
        self.kernels = [(n, s * 1e-9 + offset, (s + d) * 1e-9 + offset)
                        for n, s, d in events
                        if "spin_kernel" not in n and "sleep" not in n.lower()]
        self.prof = None

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_s(self) -> float:
        return union_s([(a, b) for _, a, b in self.kernels], self.t0, self.t1)

    def kernel_s(self, match: str) -> tuple[int, float]:
        """(launches, summed seconds) of the kernels whose name holds ``match``."""
        hits = [b - a for n, a, b in self.kernels if match in n]
        return len(hits), sum(hits)

    def breakdown(self, spans: Spans, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps, each named by the innermost harness span open at its middle."""
        by_name: dict[str, float] = {}
        for n, a, b in self.kernels:
            by_name[n[:120]] = by_name.get(n[:120], 0.0) + (b - a)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = merged([(max(a, self.t0), min(b, self.t1)) for _, a, b in self.kernels
                       if b > self.t0 and a < self.t1])
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        named = []
        for a, b in gaps[:top]:
            mid = 0.5 * (a + b)
            open_ = [(s1 - s0, n) for n, s0, s1 in spans.items if s0 <= mid <= s1]
            named.append([min(open_)[1] if open_ else "host", b - a])
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}
