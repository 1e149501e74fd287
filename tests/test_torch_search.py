"""The port's genome codec, area proxy, NSGA-II and co-design loop against the reference.

These parts are NumPy in both packages and copied into the port, so with
the same inputs (or the same objective callback) they must agree exactly:
decoded genomes, area costs, fronts, memo contents and insertion order,
counters.  The co-design loop itself trains on the port's QAT path, so it
is held to the reference's search-level assertions (``tests/test_codesign.py``),
not to its bits.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import area as jarea  # noqa: E402
from repro.core import chromosome as jchrom  # noqa: E402
from repro.core import codesign as jcodesign  # noqa: E402
from repro.core import nsga2 as jnsga2  # noqa: E402
from repro_torch.configs import printed_mlp  # noqa: E402
from repro_torch.core import area, chromosome, codesign, nsga2  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are tiny, and the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _genomes(P=40, C=7, seed=0):
    rng = np.random.default_rng(seed)
    masks = rng.uniform(size=(P, C * 16)) < rng.uniform(0.1, 1.0, (P, 1))
    cats = np.stack([rng.integers(0, c, P) for c in chromosome.CAT_CARDINALITIES], 1)
    return masks, cats


def test_decode_and_area_equal_reference():
    masks, cats = _genomes()
    got = chromosome.decode_batch(masks, cats, 7, 4)
    want = jchrom.decode_batch(masks, cats, 7, 4)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert chromosome.n_mask_bits(21, 4) == jchrom.n_mask_bits(21, 4)
    assert chromosome.cat_cardinalities() == jchrom.cat_cardinalities(("adc",), 2)
    for include_ladder in (False, True):
        for g, w in zip(area.adc_cost_batch(got["masks"], 4, include_ladder=include_ladder),
                        jarea.adc_cost_batch(got["masks"], 4, include_ladder=include_ladder)):
            np.testing.assert_array_equal(g, w)
    for C in (4, 7, 21):
        assert area.conventional_cost(C, 4) == jarea.conventional_cost(C, 4)
    np.testing.assert_array_equal(
        codesign._genome_seeds(masks, cats), jcodesign._genome_seeds(masks, cats)
    )


def _objective(masks, cats):
    """The analytic objective of the reference's pipeline tests (test_evalpipe.py)."""
    masks = np.asarray(masks, bool)
    bits = masks.sum(axis=1).astype(np.float64)
    cat0 = np.asarray(cats, np.int64)[:, 0].astype(np.float64)
    return np.stack([bits + cat0, masks.shape[1] - bits], axis=1)


def _zdt_like(masks, cats):
    """The bit-count trade-off of the reference's test_nsga2.py, plus a categorical term."""
    h = masks.shape[1] // 2
    return np.stack([masks[:, :h].mean(1) + 0.01 * cats[:, 0],
                     1.0 - masks[:, h:].mean(1)], 1)


@pytest.mark.parametrize("objective,n_bits,cards,memoize", [
    (_objective, 12, (3, 2), True),
    (_zdt_like, 32, (5, 5, 4, 4, 4), True),
    (_zdt_like, 32, (5, 5, 4, 4, 4), False),
])
def test_nsga2_bit_equal_to_reference(objective, n_bits, cards, memoize):
    calls = {"port": [], "ref": []}

    def counted(name):
        def f(m, c):
            calls[name].append((m.copy(), c.copy()))
            return objective(m, c)
        return f

    outs = []
    for mod, name in ((nsga2, "port"), (jnsga2, "ref")):
        cfg = mod.NSGA2Config(pop_size=10, n_generations=6, seed=4, memoize=memoize)
        ga = mod.NSGA2(n_bits, cards, counted(name), cfg)
        outs.append((ga, ga.run()))
    (pga, pout), (jga, jout) = outs
    for k in ("masks", "cats", "objs", "all_objs"):
        np.testing.assert_array_equal(pout[k], jout[k], err_msg=k)
    assert (pout["n_evaluations"], pout["n_memo_hits"]) == (jout["n_evaluations"],
                                                            jout["n_memo_hits"])
    assert list(pga.memo) == list(jga.memo)  # same keys, same insertion order
    for k in jga.memo:
        np.testing.assert_array_equal(pga.memo[k], jga.memo[k])
    assert len(calls["port"]) == len(calls["ref"])
    for (pm, pc), (jm, jc) in zip(calls["port"], calls["ref"]):
        np.testing.assert_array_equal(pm, jm)
        np.testing.assert_array_equal(pc, jc)
    timing = {"eval_s", "gen_s", "deferred"}
    for p, j in zip(pout["history"], jout["history"]):
        assert {k: v for k, v in p.items() if k not in timing} == {
            k: v for k, v in j.items() if k not in timing
        }


def test_nsga2_helpers_equal_reference():
    rng = np.random.default_rng(2)
    objs = rng.uniform(size=(50, 2))
    for a, b in zip(nsga2.fast_non_dominated_sort(objs), jnsga2.fast_non_dominated_sort(objs)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(nsga2.crowding_distance(objs), jnsga2.crowding_distance(objs))
    assert nsga2.hypervolume_2d(objs, (1.1, 1.1)) == jnsga2.hypervolume_2d(objs, (1.1, 1.1))
    masks, cats = _genomes(5)
    assert nsga2.genome_keys(masks, cats) == jnsga2.genome_keys(masks, cats)


@pytest.fixture(scope="module")
def seeds_result():
    # 150 steps, the reference's own short trainer test (test_codesign.py):
    # at 60 steps the conventional baseline of either package lands
    # anywhere in 0.33-0.71 (4 seeds each, measured), short of the
    # learnability bar below.
    cfg = codesign.CodesignConfig(
        dataset="seeds", pop_size=8, n_generations=2, max_steps=150, device="cpu"
    )
    return codesign.run_codesign(cfg)


def test_codesign_front_is_nonempty_and_pruned(seeds_result):
    r = seeds_result
    assert r.front_acc.size >= 1
    assert (r.front_area > 0).all()
    assert r.front_area.min() < 0.8 * r.conv_area
    assert r.front_masks[:, :, 0].all()
    assert r.n_evaluations > 0 and r.n_memo_hits > 0
    assert len(r.history) == 2


def test_codesign_baseline_accuracy_is_learnable(seeds_result):
    """Conventional-ADC QAT must actually learn (paper range 80-95%)."""
    assert seeds_result.conv_acc > 0.70


def test_gains_report_within_budget(seeds_result):
    g = codesign.gains_at_budget(seeds_result, 0.10)
    assert g["area_gain"] >= 1.0
    assert g["power_gain"] >= 1.0
    assert g["acc"] >= seeds_result.conv_acc - 0.10 - 1e-9
    ref = jcodesign.gains_at_budget(seeds_result, 0.10)  # same report function
    assert {k: v for k, v in g.items() if k not in ("mask", "cats")} == {
        k: v for k, v in ref.items() if k not in ("mask", "cats")
    }


def test_configs_and_memo_fingerprint():
    full = printed_mlp.codesign_config("cardio", full=True)
    jfull = jcodesign.CodesignConfig(dataset="cardio", pop_size=24, n_generations=16,
                                     step_scale=1.0, max_steps=600)
    for k in ("dataset", "pop_size", "n_generations", "step_scale", "max_steps", "adc_bits"):
        assert getattr(full, k) == getattr(jfull, k), k
    assert full.device is None  # the card by default
    fp = full.memo_fingerprint()
    assert fp.pop("backend") == "torch"
    assert fp == jfull.memo_fingerprint()
    assert set(printed_mlp.PAPER_DATASETS) == set(
        ("balance", "breast_cancer", "cardio", "mammographic", "seeds", "vertebral3")
    )
    with pytest.raises(ValueError):
        codesign.run_codesign(codesign.CodesignConfig(pop_size=1, device="cpu"))
