"""The port's island model and async drivers against the reference, and its island evaluator.

The GA engines are NumPy in both packages, so under one objective the
port's single-population drivers (``run``, ``run_async``) and island
drivers (sequential, stacked, async) must equal the reference's bit for
bit: memo contents and insertion order, counters, histories without
times, migrations and fronts; and every island driver must equal the
sequential one.  Through ``run_codesign`` both packages' evaluators are
replaced by one deterministic NumPy objective (``_torch_shared``).  The
port's real island evaluator is held against per-island calls of its
population evaluator on the CPU.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from _torch_shared import (  # noqa: E402
    assert_same_codesign,
    assert_same_memo,
    patch_evaluators,
    untimed,
)

from repro.core import codesign as jcodesign  # noqa: E402
from repro.core import nsga2 as jnsga2  # noqa: E402
from repro.data import uci_synth  # noqa: E402
from repro_torch.core import codesign, nsga2, qat, trainer  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are tiny, and the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _objective(masks, cats):
    """Bit-count trade-off plus a categorical term, pure in the genome."""
    h = masks.shape[1] // 2
    return np.stack([masks[:, :h].mean(1) + 0.01 * cats[:, 0],
                     1.0 - masks[:, h:].mean(1)], 1)


def _dispatching(objective, log=None):
    """A dispatch callback that evaluates at resolve time and logs what it saw."""
    def dispatch(masks, cats):
        if log is not None:
            log.append((masks.copy(), cats.copy()))
        return lambda: objective(masks, cats)
    return dispatch


def _stacked(objective):
    def stacked(batches):
        return [objective(m, c) if m.shape[0] else None for m, c in batches]
    return stacked


def _assert_same_out(got, want):
    for k in ("masks", "cats", "objs", "all_objs"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("n_evaluations", "n_memo_hits", "n_deferred"):
        assert got[k] == want[k], k
    assert untimed(got["history"]) == untimed(want["history"])
    if "migrations" in want:
        assert got["migrations"] == want["migrations"]
        assert [untimed(h) for h in got["island_history"]] == [
            untimed(h) for h in want["island_history"]]


@pytest.mark.parametrize("driver,memoize", [
    ("run", True), ("run", False), ("run_async", True), ("run_async", False),
])
def test_single_population_drivers_equal_reference(driver, memoize):
    outs, engines = [], []
    for mod in (nsga2, jnsga2):
        cfg = mod.NSGA2Config(pop_size=8, n_generations=5, seed=11, memoize=memoize)
        ga = mod.NSGA2(24, (3, 4), _objective, cfg)
        out = ga.run() if driver == "run" else ga.run_async(_dispatching(_objective))
        outs.append(out)
        engines.append(ga)
    _assert_same_out(*outs)
    assert_same_memo(engines[0].memo, engines[1].memo)
    # the async driver is the synchronous loop, bit for bit
    sync = nsga2.NSGA2(24, (3, 4), _objective,
                       nsga2.NSGA2Config(pop_size=8, n_generations=5, seed=11, memoize=memoize))
    _assert_same_out(outs[0], sync.run())


ISLANDS = dict(num_islands=3, migration_interval=2, migration_size=2)


def _island_driver(mod, kind, topology="ring", log=None):
    cfg = mod.NSGA2Config(pop_size=6, n_generations=5, seed=2)
    icfg = mod.IslandConfig(topology=topology, stacked=kind == "stacked",
                            async_pipeline=kind == "async", **ISLANDS)
    return mod.IslandNSGA2(
        20, (3, 2), _objective, cfg, icfg,
        stacked_evaluate=_stacked(_objective) if kind == "stacked" else None,
        dispatch_evaluate=_dispatching(_objective, log) if kind == "async" else None,
    )


@pytest.mark.parametrize("kind", ["sequential", "stacked", "async"])
@pytest.mark.parametrize("topology", ["ring", "none"])
def test_island_drivers_equal_reference_and_sequential(kind, topology):
    port, ref = _island_driver(nsga2, kind, topology), _island_driver(jnsga2, kind, topology)
    got, want = port.run(), ref.run()
    _assert_same_out(got, want)
    assert_same_memo(port.memo, ref.memo)
    assert untimed(port.agg_history) == untimed(ref.agg_history)
    seq = _island_driver(nsga2, "sequential", topology)
    _assert_same_out(got, seq.run())
    assert_same_memo(port.memo, seq.memo)
    if topology == "ring":
        assert got["migrations"], "no migration wave ran"


def test_async_driver_dispatches_every_island_before_resolving():
    log = []
    driver = _island_driver(nsga2, "async", log=log)
    resolved = []
    inner = driver._dispatch_fn

    def dispatch(m, c):
        resolve = inner(m, c)

        def counted():
            resolved.append(len(log))
            return resolve()
        return counted

    driver._dispatch_fn = dispatch
    driver.run()
    # the first commit of each wave happens after the whole wave was dispatched
    assert resolved and max(resolved) == len(log)
    assert resolved[0] >= 2


def test_dispatch_pool_defers_the_commit():
    ga = nsga2.NSGA2(20, (3, 2), _objective, nsga2.NSGA2Config(pop_size=6, seed=1))
    masks, cats = ga.setup_begin()
    resolve = ga.dispatch_pool(masks, cats, _dispatching(_objective))
    assert ga.n_evaluations == 0 and not ga.memo
    objs = resolve()
    assert ga.n_evaluations == len(ga.memo) > 0
    np.testing.assert_array_equal(objs, _objective(masks, cats))


def test_plan_and_commit_halves_equal_reference():
    rng = np.random.default_rng(3)
    masks = rng.uniform(size=(12, 20)) < 0.5
    masks[5] = masks[2]  # a repeat within the pool
    cats = rng.integers(0, 2, (12, 2))
    cats[5] = cats[2]
    claimed = set(nsga2.genome_keys(masks[3:4], cats[3:4]))
    want = _objective(masks, cats)
    for mod in (nsga2, jnsga2):
        ga = mod.NSGA2(20, (3, 2), _objective, mod.NSGA2Config(pop_size=6))
        ga.commit_plan(*ga.plan_unseen(masks[:2], cats[:2]), want[:2])
        keys, unseen = ga.plan_unseen(masks, cats, set(claimed))
        # rows 0-1 are memo hits, 3 is claimed, 5 repeats 2
        assert list(unseen.values()) == [2, 4, 6, 7, 8, 9, 10, 11]
        # the pool that claimed row 3 commits first, as in a driver's island order
        ga.commit_plan(*ga.plan_unseen(masks[3:4], cats[3:4]), want[3:4])
        idx = list(unseen.values())
        np.testing.assert_array_equal(ga.commit_plan(keys, unseen, want[idx]), want)
        assert (ga.n_evaluations, ga.n_memo_hits) == (2 + 1 + 8, 4)


def test_island_config_validation_equals_reference():
    cases = [dict(num_islands=0), dict(migration_interval=0), dict(migration_size=-1),
             dict(topology="star"), dict(stacked=True, async_pipeline=True), dict()]
    for kw in cases:
        errs = []
        for mod in (nsga2, jnsga2):
            try:
                mod.IslandConfig(**kw)
                errs.append(None)
            except ValueError as e:
                errs.append(str(e))
        assert errs[0] == errs[1], kw
    for kind in ("stacked", "async"):
        with pytest.raises(ValueError, match="memoize"):
            nsga2.IslandNSGA2(20, (3, 2), _objective, nsga2.NSGA2Config(memoize=False),
                              nsga2.IslandConfig(stacked=kind == "stacked",
                                                 async_pipeline=kind == "async"))


def test_unported_engine_hooks_raise():
    """The hybrid hooks and the screen stage, once refused, now run as the reference's.

    Nothing of the engine raises ``NotImplementedError`` any more: a warm
    start, a refiner and out-of-band scoring on both packages' engines give
    the same memo, counters, histories and front.
    """
    assert not hasattr(nsga2, "NOT_PORTED")
    rng = np.random.default_rng(5)
    warm_m, warm_c = rng.uniform(size=(3, 20)) < 0.5, rng.integers(0, 2, (3, 2))
    cfg = nsga2.NSGA2Config(pop_size=8, n_generations=3, seed=2)

    def refine(m, c):  # a pure function of the genomes: flips each member's first bit
        m = m.copy()
        m[:, 0] = ~m[:, 0]
        return m, c

    out = []
    for mod in (nsga2, jnsga2):
        ga = mod.NSGA2(20, (3, 2), _objective, dataclasses.replace(cfg))
        objs = ga.score_pool(warm_m, warm_c)
        assert ga.seed_warm(warm_m, warm_c) == 3
        ga.set_refiner(refine, every=2, top_k=2)
        res = ga.run()
        out.append((objs, ga.memo, ga.n_evaluations, ga.n_memo_hits, res))
    (objs, memo, n_ev, n_hit, res), (jobjs, jmemo, jn_ev, jn_hit, jres) = out
    np.testing.assert_array_equal(objs, jobjs)
    assert_same_memo(memo, jmemo)
    assert (n_ev, n_hit) == (jn_ev, jn_hit)
    assert untimed(res["history"]) == untimed(jres["history"])
    for k in ("masks", "cats", "objs"):
        np.testing.assert_array_equal(res[k], jres[k])
    for ctor in (nsga2.NSGA2, nsga2.IslandNSGA2):
        assert ctor(20, (3, 2), _objective, screen=lambda ctx: None) is not None


CODESIGN = dict(dataset="seeds", pop_size=6, n_generations=4, max_steps=20, step_scale=0.1,
                num_islands=3, migration_interval=2, migration_size=1)


@pytest.mark.parametrize("drivers", [
    {}, {"stacked_islands": True}, {"async_pipeline": True},
    {"num_islands": 1}, {"num_islands": 1, "async_pipeline": True},
    {"memoize": False, "num_islands": 1},
])
def test_codesign_drivers_equal_reference(monkeypatch, drivers):
    patch_evaluators(monkeypatch)
    kw = {**CODESIGN, **drivers}
    got = codesign.run_codesign(codesign.CodesignConfig(**kw, device="cpu"))
    want = jcodesign.run_codesign(jcodesign.CodesignConfig(**kw))
    assert_same_codesign(got, want)
    seq = codesign.run_codesign(codesign.CodesignConfig(
        **{**kw, "stacked_islands": False, "async_pipeline": False}, device="cpu"))
    assert_same_codesign(got, seq)


# -- the port's island evaluator on its real trainer -------------------------------


def _data():
    X, y, spec = uci_synth.load("seeds")
    return (*uci_synth.stratified_split(X, y, 0.7, 0),
            qat.MLPConfig((spec.n_features, spec.hidden, spec.n_classes)))


def _batch(n, seed, C=7):
    rng = np.random.default_rng(seed)
    masks = rng.uniform(size=(n, C, 16)) < rng.uniform(0.2, 1.0, (n, 1, 1))
    masks[:, :, 0] = True
    return (masks, rng.choice([8.0, 6.0], n).astype(np.float32),
            rng.choice([4.0, 3.0], n).astype(np.float32),
            rng.choice([16, 64], n).astype(np.int32), rng.choice([60, 120], n).astype(np.int32),
            rng.choice([0.05, 0.1], n).astype(np.float32),
            rng.integers(0, 2**31 - 1, n).astype(np.int32))


def test_island_evaluator_equals_per_island_calls():
    *data, mcfg = _data()
    ecfg = trainer.EvalConfig(max_steps=12, block_steps=5)
    pop = trainer.make_population_evaluator(*data, mcfg, ecfg, device="cpu")
    isl = trainer.make_island_evaluator(*data, mcfg, ecfg, num_islands=3, device="cpu")
    batches = [_batch(3, 1), _batch(0, 2), _batch(6, 3)]  # island 1 ships nothing
    got = isl(batches)
    assert [a.shape for a in got] == [(3,), (0,), (6,)]
    for b, a in zip(batches, got):
        if b[0].shape[0]:
            np.testing.assert_array_equal(a, pop(*b))
    resolve = isl.dispatch(batches)
    for a, b in zip(resolve(), got):
        np.testing.assert_array_equal(a, b)
    assert [a.shape for a in isl([_batch(0, 4)] * 3)] == [(0,)] * 3
    with pytest.raises(ValueError, match="island batches"):
        isl(batches[:2])
    rebuilt = isl.rebuild(1)
    np.testing.assert_array_equal(rebuilt(batches)[2], got[2])
    with pytest.raises(ValueError, match="n_devices"):
        isl.rebuild(2)


def test_stacked_codesign_on_the_real_trainer_equals_sequential():
    kw = dict(dataset="seeds", pop_size=4, n_generations=2, max_steps=10, step_scale=0.1,
              num_islands=2, migration_interval=1, migration_size=1, device="cpu")
    seq = codesign.run_codesign(codesign.CodesignConfig(**kw))
    for extra in ({"stacked_islands": True}, {"async_pipeline": True}):
        assert_same_codesign(codesign.run_codesign(
            dataclasses.replace(codesign.CodesignConfig(**kw), **extra)), seq)
