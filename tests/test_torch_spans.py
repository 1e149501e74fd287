"""The port's span recorder (``repro_torch.spans``), the spans the search and
the prefill record, and the benchmark's idle attribution over them, on the CPU.

* Off (the default) records nothing and hands out one shared no-op context.
* On: spans nest in time inside their root, ``take`` clears; threads record
  their own spans, each inside its own thread's enclosing span.
* A tiny ``run_codesign`` records every stage under one ``codesign.search``,
  and its front, accuracies and counters are bit-equal to the same search
  with the recorder off; a tiny VLM ``prefill`` records one ``model.inputs``,
  a ``model.layer`` a layer and one ``model.head`` under one
  ``model.prefill``, with logits bit-equal on and off.
* ``cardbench.attribution``: the innermost rule on hand-made timelines and
  against a brute-force walk (the shortest open span, ``Trace.breakdown``'s
  rule), and the idle shares of ``attribution.GROUPS`` on synthetic runs.
"""

import dataclasses
import sys
import threading
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import spans  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import codesign  # noqa: E402
from repro_torch.models import build_model, init_cache, transformer  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from cardbench import attribution  # noqa: E402
from cardbench.tracing import Spans, Trace, union_s  # noqa: E402

SEARCH_STAGES = {"codesign.build", "ga.variation", "ga.plan", "ga.commit", "codesign.decode",
                 "codesign.area", "trainer.draw", "trainer.stage", "trainer.enqueue"}
TINY = dict(dataset="seeds", pop_size=4, n_generations=2, max_steps=8, step_scale=0.1,
            device="cpu")


@pytest.fixture(autouse=True)
def _recorder_off():
    """Each test starts and ends with the recorder off and empty."""
    spans.disable()
    spans.take()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    spans.disable()
    spans.take()


def _recorded(fn):
    """``fn()`` with the recorder on: (its result, the spans it recorded)."""
    spans.enable()
    try:
        out = fn()
    finally:
        spans.disable()
    return out, spans.take()


def _inside(s, p) -> bool:
    return p.t0 <= s.t0 <= s.t1 <= p.t1


def _parent(s, got):
    """The shortest other span around ``s`` in time, or None at a root."""
    around = [p for p in got if p is not s and _inside(s, p)]
    return min(around, key=lambda p: p.t1 - p.t0) if around else None


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

def test_off_records_nothing_and_shares_one_context():
    a, b = spans.span("codesign.search"), spans.span("model.layer")
    assert a is b
    with a:
        with spans.span("model.head"):
            pass

    @spans.spanned("ga.plan")
    def plan(x):
        return x + 1

    assert plan(1) == 2 and plan.__name__ == "plan"
    assert spans.take() == []


def test_nesting_roots_and_take_clears():
    def work():
        with spans.span("outer"):
            with spans.span("mid"):
                with spans.span("inner"):
                    pass
            with spans.span("mid"):
                pass
        with spans.span("second"):
            pass

    _, got = _recorded(work)
    assert [s.name for s in got] == ["inner", "mid", "mid", "outer", "second"]
    inner, mid1, mid2, outer, second = got
    assert all(s.t0 <= s.t1 and isinstance(s, tuple) and len(s) == 3 for s in got)
    assert _parent(outer, got) is None and _parent(second, got) is None
    assert outer.t1 <= second.t0
    assert _parent(inner, got) is mid1 and _parent(mid1, got) is outer
    assert _parent(mid2, got) is outer and mid1.t1 <= mid2.t0
    assert spans.take() == []


def test_spanned_records_each_call_and_passes_errors_on():
    @spans.spanned("ga.commit")
    def commit(fail):
        if fail:
            raise ValueError("no")
        return "ok"

    def work():
        assert commit(False) == "ok"
        with pytest.raises(ValueError):
            commit(True)

    _, got = _recorded(work)
    assert [s.name for s in got] == ["ga.commit", "ga.commit"]
    assert got[0].t1 <= got[1].t0


def test_span_open_at_disable_still_closes():
    spans.enable()
    with spans.span("outer"):
        spans.disable()
        with spans.span("after"):
            pass
    got = spans.take()
    assert [s.name for s in got] == ["outer"]


def test_threads_keep_their_own_parents():
    """More threads than cores, a short switch interval: every inner span lies
    inside an outer span of its own thread, and no span is lost."""
    n_threads, n_iter = 16, 200
    names = [(f"outer{k}", f"inner{k}") for k in range(n_threads)]
    start = threading.Barrier(n_threads)

    def worker(k):
        outer, inner = names[k]
        start.wait(timeout=30)
        for _ in range(n_iter):
            with spans.span(outer):
                with spans.span(inner):
                    pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    spans.enable()
    try:
        threads = [threading.Thread(target=worker, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        spans.disable()
    got = spans.take()
    assert len(got) == 2 * n_threads * n_iter
    for outer, inner in names:
        inners = sorted((s for s in got if s.name == inner), key=lambda s: s.t0)
        outers = sorted((s for s in got if s.name == outer), key=lambda s: s.t0)
        assert len(inners) == len(outers) == n_iter
        assert all(_inside(i, o) for i, o in zip(inners, outers))
        assert all(a.t1 <= b.t0 for a, b in zip(outers, outers[1:]))


# ---------------------------------------------------------------------------
# the search's spans
# ---------------------------------------------------------------------------

def _front(res) -> dict:
    hist = [{k: v for k, v in h.items() if k not in ("eval_s", "gen_s")} for h in res.history]
    return dict(masks=res.front_masks, cats=res.front_cats, acc=res.front_acc,
                area=res.front_area, power=res.front_power, conv_acc=res.conv_acc,
                n_evaluations=res.n_evaluations, n_memo_hits=res.n_memo_hits, history=hist)


@pytest.mark.parametrize("async_pipeline", [False, True])
def test_search_spans_under_one_root_and_bits_unchanged(async_pipeline):
    cfg = codesign.CodesignConfig(**TINY, async_pipeline=async_pipeline)
    off = _front(codesign.run_codesign(cfg))
    res, got = _recorded(lambda: codesign.run_codesign(cfg))
    on = _front(res)
    for k in off:
        if isinstance(off[k], np.ndarray):
            np.testing.assert_array_equal(on[k], off[k])
        else:
            assert on[k] == off[k], k
    root = got[-1]
    assert root.name == "codesign.search"
    assert [s for s in got if _parent(s, got) is None] == [root]
    names = {s.name for s in got}
    assert names == SEARCH_STAGES | {"codesign.search"}  # no capture: the CPU runs no graph
    # no stage nests in another: each is the root's own child
    assert all(_parent(s, got) is root for s in got[:-1])
    # every stage is in exactly one of the benchmark's groups
    grouped = [n for g in attribution.GROUPS.values() for n in g]
    assert len(grouped) == len(set(grouped)) and SEARCH_STAGES <= set(grouped)
    count = {n: sum(s.name == n for s in got) for n in names}
    # setup and two generations: a variation and a plan each; a commit of the
    # pool and a selection each
    assert count["ga.variation"] == count["ga.plan"] == 3 and count["ga.commit"] == 6
    # each evaluator call draws once, stages twice (rows, then parameters) and
    # enqueues twice (the steps and test forward, then the copy out)
    assert count["trainer.draw"] >= 2
    assert count["trainer.stage"] == count["trainer.enqueue"] == 2 * count["trainer.draw"]


# ---------------------------------------------------------------------------
# the prefill's spans
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def vlm():
    cfg = dataclasses.replace(registry.reduced(registry.get("internvl2-26b")), n_layers=3)
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(4)
    tokens = torch.randint(0, cfg.vocab_size, (2, 5), generator=gen)
    patches = torch.rand((2, cfg.frontend_len, cfg.d_model), generator=gen)
    return cfg, model, params, tokens, patches


def test_prefill_spans_and_bits_unchanged(vlm):
    cfg, model, params, tokens, patches = vlm
    with torch.inference_mode():
        logits, cache = model.prefill(params, tokens, patches)
        (logits_on, cache_on), got = _recorded(lambda: model.prefill(params, tokens, patches))
    assert torch.equal(logits_on, logits)
    assert all(torch.equal(cache_on[k], cache[k]) for k in cache)
    assert [s.name for s in got] == (["model.inputs"] + ["model.layer"] * cfg.n_layers
                                     + ["model.head", "model.prefill"])
    root = got[-1]
    assert all(_parent(s, got) is root for s in got[:-1])
    assert all(a.t1 <= b.t0 for a, b in zip(got[:-2], got[1:-1]))
    assert {s.name for s in got} <= {n for g in attribution.GROUPS.values() for n in g} | {
        root.name}


def test_decode_step_records_nothing(vlm):
    cfg, model, params, tokens, patches = vlm
    cache = init_cache(model, 2, 16, "cpu")
    with torch.inference_mode():
        _, got = _recorded(lambda: model.decode_step(params, tokens[:, 0], cache,
                                                     torch.zeros(2, dtype=torch.int64)))
    assert got == []


def test_forward_and_remat_backward_record_one_span_a_layer(vlm):
    """``forward`` has no ``model.prefill`` root; a checkpointed recompute in
    the backward records no second ``model.layer``."""
    cfg, model, params, tokens, patches = vlm
    assert cfg.remat
    leaf = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}

    def step():
        logits = transformer.forward(leaf, tokens, cfg, patches, train=True)
        logits.float().square().mean().backward()

    _, got = _recorded(step)
    assert [s.name for s in got] == (["model.inputs"] + ["model.layer"] * cfg.n_layers
                                     + ["model.head"])
    assert all(a.t1 <= b.t0 for a, b in zip(got, got[1:]))
    assert leaf["wq"].grad is not None


# ---------------------------------------------------------------------------
# the benchmark's idle attribution
# ---------------------------------------------------------------------------

def _brute(spans_, kernels, t0, t1):
    """Each elementary stretch between any two edges, walked on its own."""
    cuts = sorted({t0, t1, *(x for _, a, b in kernels for x in (a, b)),
                   *(x for _, a, b in spans_ for x in (a, b))})
    cuts = [c for c in cuts if t0 <= c <= t1]
    by, none = {}, 0.0
    for a, b in zip(cuts, cuts[1:]):
        mid = 0.5 * (a + b)
        if any(ka <= mid <= kb for _, ka, kb in kernels):
            continue
        open_ = [(sb - sa, n) for n, sa, sb in spans_ if sa <= mid <= sb and sb > sa]
        if open_:
            name = min(open_)[1]
            by[name] = by.get(name, 0.0) + (b - a)
        else:
            none += b - a
    return by, none


def test_attribution_innermost_by_hand():
    kernels = [("k", 1.0, 2.0), ("k", 6.0, 7.0)]
    spans_ = [("R", 0.5, 9.0), ("C", 2.5, 5.0), ("G", 3.0, 4.0)]
    by, none = attribution.idle_by_span(spans_, kernels, 0.0, 10.0)
    assert by == pytest.approx({"R": 4.0, "C": 1.5, "G": 1.0})
    assert none == pytest.approx(1.5)
    idle = sum(b - a for a, b in attribution.idle_intervals(kernels, 0.0, 10.0))
    assert idle == pytest.approx(8.0) == sum(by.values()) + none
    # two threads' spans overlap without nesting: the shorter one holds the
    # overlap, whichever started last, as Trace.breakdown names a gap
    for spans_ in ([("A", 0.0, 6.0), ("B", 3.0, 10.0)], [("B", 0.0, 7.5), ("A", 3.0, 10.0)]):
        by, none = attribution.idle_by_span(spans_, kernels, 0.0, 10.0)
        short, long_ = sorted(spans_, key=lambda s: s[2] - s[1])
        assert by[short[0]] == pytest.approx(short[2] - short[1] - 1.0)
        assert sum(by.values()) + none == pytest.approx(8.0) and none == 0.0


@pytest.mark.parametrize("seed", range(6))
def test_attribution_matches_brute_force(seed):
    rng = np.random.default_rng(seed)
    t0, t1 = 1.0, 21.0
    kernels = []
    for _ in range(int(rng.integers(0, 40))):
        a = float(rng.uniform(0.0, 22.0))
        kernels.append(("k", a, a + float(rng.exponential(0.3))))
    spans_ = []
    for _ in range(int(rng.integers(0, 30))):
        a = float(rng.uniform(0.0, 22.0))
        spans_.append((f"s{int(rng.integers(0, 6))}", a, a + float(rng.exponential(3.0))))
    by, none = attribution.idle_by_span(spans_, kernels, t0, t1)
    want_by, want_none = _brute(spans_, kernels, t0, t1)
    assert set(by) == set(want_by)
    for n in by:
        assert by[n] == pytest.approx(want_by[n], abs=1e-9)
    assert none == pytest.approx(want_none, abs=1e-9)
    busy = union_s([(a, b) for _, a, b in kernels], t0, t1)
    assert sum(by.values()) + none == pytest.approx((t1 - t0) - busy, abs=1e-9)


def _run(kernels, items, t0=0.0, t1=10.0):
    trace = Trace(None, False, 0.0)
    trace.t0, trace.t1, trace.kernels = t0, t1, kernels
    run = types.SimpleNamespace(trace=trace, spans=Spans())
    run.spans.items.extend(items)
    return run


# idle [0, 4], [5, 7], [8, 10]: build 1, variation 0.5, plan 0.5, decode 0.25,
# draw 0.5, stage 0.25, capture 0.75, enqueue 0.25, area 0.5, commit 0.5, the
# root itself 3
SEARCH_RUN = ([("k", 4.0, 5.0), ("k", 7.0, 8.0)], [
    ("search", 0.0, 10.0), ("codesign.search", 0.0, 10.0), ("codesign.build", 0.0, 1.0),
    ("ga.variation", 1.0, 1.5), ("ga.plan", 1.5, 2.0), ("codesign.decode", 2.0, 2.25),
    ("evaluator.dispatch", 2.2, 4.6), ("trainer.draw", 2.25, 2.75), ("trainer.stage", 2.75, 3.0),
    ("trainer.capture", 3.0, 3.75), ("trainer.enqueue", 3.75, 4.5),
    ("codesign.area", 4.5, 5.5), ("evaluator.resolve", 5.5, 6.0), ("ga.commit", 6.0, 6.5)])
# idle [0, 2], [3, 3.2], [4, 4.5], [9, 10]: inputs 1, layers 0.2 + 0.5, head 0.2,
# the root itself 0.3, none 1.5
PREFILL_RUN = ([("k", 2.0, 3.0), ("k", 3.2, 4.0), ("k", 4.5, 9.0)], [
    ("prefill", 0.9, 9.6), ("model.prefill", 1.0, 9.5), ("model.inputs", 1.0, 2.5),
    ("model.layer", 2.5, 3.5), ("model.layer", 3.5, 4.6), ("model.head", 4.6, 9.2),
    ("first_token", 9.6, 9.9)])
GROUPS = [
    (SEARCH_RUN, "idle_evaluator_setup_pct", 17.5),
    (SEARCH_RUN, "idle_row_prep_pct", 7.5),
    (SEARCH_RUN, "idle_ga_pct", 22.5),
    (PREFILL_RUN, "idle_layers_pct", 9.0),
    (PREFILL_RUN, "idle_model_inputs_pct", 10.0),
    (SEARCH_RUN, "idle_launch_pct", 2.5),
]


def test_every_group_is_checked():
    assert sorted(m for _, m, _ in GROUPS) == sorted(attribution.GROUPS)


@pytest.mark.parametrize("timeline,metric,want", GROUPS)
def test_idle_share_of_a_span_group(timeline, metric, want):
    names = attribution.GROUPS[metric]
    kernels, items = timeline
    run = _run(kernels, items)
    assert attribution.idle_share_pct(run, names) == pytest.approx(want)
    harness_only = _run(kernels, [s for s in items if not s[0].startswith(attribution.PROGRAM)])
    assert attribution.idle_share_pct(harness_only, names) is None
    untraced = _run(kernels, items)
    untraced.trace.t0 = None
    assert attribution.idle_share_pct(untraced, names) is None


@pytest.mark.parametrize("timeline,root,left", [(SEARCH_RUN, "codesign.search", 3.0),
                                                 (PREFILL_RUN, "model.prefill", 0.3)])
def test_groups_never_sum_above_the_idle_share(timeline, root, left):
    kernels, items = timeline
    run = _run(kernels, items)
    total = 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
    shares = [attribution.idle_share_pct(run, attribution.GROUPS[m])
              for t, m, _ in GROUPS if t is timeline]
    assert 0.0 <= sum(shares) <= total
    by, _ = attribution.idle_by_span(attribution.program_spans(items), kernels, 0.0, 10.0)
    assert by[root] == pytest.approx(left)
