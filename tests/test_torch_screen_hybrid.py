"""The port's surrogate screen, relaxed formulation and gradient/GA hybrid against the reference.

The screen stage's host logic (``evalpipe.resolve_decision``, the screen's
split given its predictions, the engines' deferred side table) is NumPy in
both packages and must agree exactly.  The surrogate's ensemble fit is
fp32 Adam in another order of summation, held at a stated tolerance from
the reference's own member draws.  The relaxed forward pass and its
gradients are held at a stated fp32 tolerance; the descents harden their
logits with an argmax, so from carried draws the hardened genomes are held
to a measured bound of genes that may differ.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_shared import assert_same_memo, untimed  # noqa: E402

from repro.core import chromosome as jchrom  # noqa: E402
from repro.core import evalpipe as jevalpipe  # noqa: E402
from repro.core import hybrid as jhybrid  # noqa: E402
from repro.core import nsga2 as jnsga2  # noqa: E402
from repro.core import qat as jqat  # noqa: E402
from repro.core import relaxed as jrelaxed  # noqa: E402
from repro.core import surrogate as jsurrogate  # noqa: E402
from repro.data import uci_synth  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import evalpipe, hybrid, nsga2, qat, relaxed, surrogate  # noqa: E402

# The surrogate's predictions after 150 Adam steps from the reference's
# member draws (measured max gap 2.9e-7 absolute on objectives up to 0.84).
PREDICT_TOL = dict(rtol=0, atol=1e-5)
# relaxed_forward's logits and gradients: fp32 sums in another order and
# the steep comparator sigmoid (measured max gap 1.5e-8 on logits, 2.4e-6
# on gradients up to 19, 1.2e-7 relative).
RELAXED_TOL = dict(rtol=1e-5, atol=1e-6)
# Hardened genes of the warm start and the refiner from carried draws: the
# descents run in fp32 in another order, and a logit within an ulp of 0
# (or of its rival) could harden either way.  Measured: every gene equal
# (warm starts of 12 and 30 steps, 12 and 15 genomes; 4 refined members).
GENE_DIFF_FRAC = 0.02

N_BITS, CARDS = 20, (3, 2)


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


def _genomes(P, seed):
    rng = np.random.default_rng(seed)
    masks = rng.uniform(size=(P, N_BITS)) < rng.uniform(0.2, 0.8, (P, 1))
    cats = np.stack([rng.integers(0, c, P) for c in CARDS], 1).astype(np.int64)
    return masks, cats


def _memo(P=48, seed=0):
    masks, cats = _genomes(P, seed)
    objs = _objective(masks, cats)
    return {k: o for k, o in zip(nsga2.genome_keys(masks, cats), objs)}


# -- the screen stage --------------------------------------------------------------

def _ctx(mod, must=()):
    masks, cats = _genomes(8, 3)
    keys = nsga2.genome_keys(masks, cats)
    return mod.ScreenContext(masks=masks, cats=cats, keys=keys,
                             unseen={k: i for i, k in enumerate(keys)}, memo={},
                             must_train=frozenset(keys[i] for i in must)), keys


@pytest.mark.parametrize("case", ["valid", "reordered", "invented", "overlap", "dropped",
                                  "must_deferred"])
def test_resolve_decision_equals_reference(case):
    out = []
    for mod in (evalpipe, jevalpipe):
        ctx, keys = _ctx(mod, must=(1,))
        train = {k: i for i, k in enumerate(keys) if i % 2}
        deferred = {k: np.full(2, i, np.float64) for i, k in enumerate(keys) if not i % 2}
        if case == "reordered":
            train = dict(reversed(list(train.items())))
        elif case == "invented":
            train[b"nope"] = 99
        elif case == "overlap":
            train[keys[0]] = 0
        elif case == "dropped":
            deferred.pop(keys[0])
        elif case == "must_deferred":
            deferred[keys[1]] = np.zeros(2)
            train.pop(keys[1])
        try:
            got = mod.resolve_decision(ctx, mod.ScreenDecision(train, deferred, {"t": 1}))
            out.append((list(got.train.items()), sorted(got.deferred), got.telemetry))
        except ValueError as e:
            out.append(str(e))
    assert out[0] == out[1]
    assert isinstance(out[0], str) == (case not in ("valid", "reordered"))
    plan = evalpipe.PoolPlan(keys=[b"a", b"b", b"c"], train={b"c": 2, b"a": 0})
    np.testing.assert_array_equal(plan.train_indices(), jevalpipe.PoolPlan(
        keys=[b"a", b"b", b"c"], train={b"c": 2, b"a": 0}).train_indices())


def _reference_members(cfg, n_feat, n_out):
    """The reference's member draws: ``_init_params`` under split(PRNGKey(seed), E)."""
    keys = jax.random.split(jax.random.PRNGKey(cfg.seed), cfg.ensemble)
    sizes = (n_feat, cfg.hidden, cfg.hidden, n_out)
    stacked = jax.vmap(lambda k: jsurrogate._init_params(k, sizes))(keys)
    return [{k: torch.from_numpy(np.array(v)) for k, v in layer.items()} for layer in stacked]


def _screens(monkeypatch, **kw):
    cfg = surrogate.SurrogateConfig(device="cpu", **kw)
    jcfg = jsurrogate.SurrogateConfig(**kw)
    port = surrogate.SurrogateScreen(N_BITS, CARDS, cfg)
    ref = jsurrogate.SurrogateScreen(N_BITS, CARDS, jcfg)
    monkeypatch.setattr(port, "init_ensemble", lambda n_out: _reference_members(
        jcfg, N_BITS + len(CARDS), n_out))
    return port, ref


def test_surrogate_predictions_match_reference_from_its_draws(monkeypatch):
    port, ref = _screens(monkeypatch)
    memo = _memo()
    np.testing.assert_array_equal(port.features_from_keys(list(memo)),
                                  ref.features_from_keys(list(memo)))
    port._refit(memo)
    ref._refit(memo)
    np.testing.assert_array_equal(port._y_mean, ref._y_mean)
    np.testing.assert_array_equal(port._y_std, ref._y_std)
    masks, cats = _genomes(16, 9)
    for g, w in zip(port.predict(masks, cats), ref.predict(masks, cats)):
        np.testing.assert_allclose(g, w, **PREDICT_TOL)
    assert port._fit_rows == ref._fit_rows == len(memo)


def test_screen_decisions_equal_given_equal_predictions(monkeypatch):
    port, ref = _screens(monkeypatch, min_rows=8)
    memo = _memo()
    rng = np.random.default_rng(4)

    def predict(masks, cats):  # one prediction for both screens
        objs = _objective(masks, cats)
        return objs + rng.normal(0, 0.05, objs.shape), np.abs(rng.normal(0, 0.1, objs.shape))

    decisions = []
    for screen, mod in ((port, evalpipe), (ref, jevalpipe)):
        rng = np.random.default_rng(4)
        screen._y_mean, screen._y_std = np.zeros(2), np.full(2, 0.2)
        screen._fit_rows = len(memo)  # the fit is skipped: it is the predictions that count
        screen.predict = predict
        masks, cats = _genomes(12, 5)
        keys = nsga2.genome_keys(masks, cats)
        out = []
        for must in ((), (2, 7)):
            ctx = mod.ScreenContext(masks=masks, cats=cats, keys=keys,
                                    unseen={k: i for i, k in enumerate(keys)}, memo=memo,
                                    must_train=frozenset(keys[i] for i in must))
            d = screen(ctx)
            out.append((list(d.train.items()), {k: v.tolist() for k, v in d.deferred.items()},
                        d.telemetry))
        decisions.append(out)
    assert decisions[0] == decisions[1]
    assert decisions[0][0][1], "the screen deferred nothing: the test would show nothing"


def _run(mod, screen=None, n_generations=6, refiner=None, **cfg):
    ga = mod.NSGA2(N_BITS, CARDS, _objective, mod.NSGA2Config(
        pop_size=12, n_generations=n_generations, seed=3, **cfg), screen=screen)
    if refiner is not None:
        ga.set_refiner(refiner, every=1)
    return ga, ga.run()


def _same_search(a, b):
    (ga, res), (gb, rb) = a, b
    assert_same_memo(ga.memo, gb.memo)
    assert (ga.n_evaluations, ga.n_memo_hits, ga.n_deferred) == (
        gb.n_evaluations, gb.n_memo_hits, gb.n_deferred)
    assert untimed(res["history"]) == untimed(rb["history"])
    for k in ("masks", "cats", "objs"):
        np.testing.assert_array_equal(res[k], rb[k])


def test_cold_screened_search_is_the_unscreened_one(monkeypatch):
    """Below ``min_rows`` the screen trains every planned row: bit for bit the plain search."""
    port, ref = _screens(monkeypatch, min_rows=10**6)
    plain = _run(nsga2)
    _same_search(_run(nsga2, port), plain)
    _same_search(_run(jnsga2, ref), plain)
    assert {r["gate"] for r in port.telemetry} <= {"cold", "final"}


def test_screened_search_trains_the_final_generation(monkeypatch):
    port, _ = _screens(monkeypatch, min_rows=16)
    ga, res = _run(nsga2, port)
    assert ga.n_deferred > 0 and any(h["deferred"] for h in res["history"][:-1])
    assert res["history"][-1]["deferred"] == 0 and port.telemetry[-1]["gate"] == "final"
    # the reported front is exact: every member's objectives are the memo's, trained
    for k, o in zip(nsga2.genome_keys(res["masks"], res["cats"]), res["objs"]):
        np.testing.assert_array_equal(ga.memo[k], o)
    np.testing.assert_array_equal(_objective(res["masks"], res["cats"]), res["objs"])


def _defer_all_but_must(mod):
    ep = evalpipe if mod is nsga2 else jevalpipe

    def screen(ctx):
        return ep.ScreenDecision(
            train={k: i for k, i in ctx.unseen.items() if k in ctx.must_train},
            deferred={k: np.full(2, 9.0) for k in ctx.unseen if k not in ctx.must_train})
    return screen


def test_must_train_flags_survive_state_dict():
    """Deferred rows ride in the state: a restored engine trains them when next planned."""
    out = []
    for mod in (nsga2, jnsga2):
        ga = mod.NSGA2(N_BITS, CARDS, _objective, mod.NSGA2Config(pop_size=8, n_generations=4,
                                                                  seed=1),
                       screen=_defer_all_but_must(mod))
        ga.setup()
        ga.step()
        assert ga._deferred and ga.n_deferred > 0
        st = ga.state_dict()
        assert "deferred_keys" in st["arrays"]
        back = mod.NSGA2(N_BITS, CARDS, _objective, ga.cfg, screen=_defer_all_but_must(mod))
        back.set_state(st)
        assert list(back._deferred) == list(ga._deferred)
        for k in ga._deferred:
            np.testing.assert_array_equal(back._deferred[k], ga._deferred[k])
        # planned again, a deferred key trains (must_train) and leaves the side table
        key = next(iter(back._deferred))
        arr = np.frombuffer(key, np.uint8)
        masks = arr[:N_BITS].astype(bool)[None]
        cats = np.ascontiguousarray(arr[N_BITS:]).view(np.int64)[None]
        plan = back.plan_pool(masks, cats)
        assert list(plan.train) == [key] and not plan.deferred
        back.commit_pool(plan, _objective(masks, cats))
        assert key not in back._deferred and key in back.memo
        out.append((st["arrays"]["deferred_keys"], st["arrays"]["deferred_objs"]))
    for g, w in zip(*out):
        np.testing.assert_array_equal(g, w)


def test_refined_child_equal_to_parent_costs_no_rows():
    """A refinement wave whose children equal their parents trains nothing more.

    From the same state one generation with and one without a refiner that
    returns its parents: the same rows trained, the same memo; the refined
    children are memo hits.
    """
    runs = []
    for refiner in (None, lambda m, c: (m.copy(), c.copy())):
        ga = nsga2.NSGA2(N_BITS, CARDS, _objective, nsga2.NSGA2Config(pop_size=12, seed=3))
        if refiner is not None:
            ga.set_refiner(refiner, every=1, top_k=4)
        ga.setup()
        ga.step()
        runs.append(ga)
    plain, same = runs
    assert same.n_evaluations == plain.n_evaluations
    assert_same_memo(same.memo, plain.memo)
    assert same.n_memo_hits > plain.n_memo_hits  # the refined children, answered free
    # and with a moving refiner, both packages' engines stay one search
    def flip(m, c):
        m = m.copy()
        m[:, -1] = ~m[:, -1]
        return m, c
    _same_search(_run(nsga2, n_generations=4, refiner=flip),
                 _run(jnsga2, n_generations=4, refiner=flip))


# -- the relaxed formulation ------------------------------------------------------------

def test_anneal_tau_matches_reference():
    for steps, a, b in ((30, 2.0, 0.2), (800, 2.0, 0.2), (7, 1.5, 0.5), (1, 2.0, 0.2)):
        for t in range(steps):
            np.testing.assert_allclose(float(relaxed.anneal_tau(t, steps, a, b)),
                                       float(jrelaxed.anneal_tau(float(t), steps, a, b)),
                                       rtol=1e-7, atol=0)
        assert float(relaxed.anneal_tau(steps - 1, steps, a, b)) == pytest.approx(b, rel=1e-6)


def _seeds():
    X, y, spec = uci_synth.load("seeds")
    X_tr, y_tr, X_te, y_te = uci_synth.stratified_split(X, y, 0.7, 0)
    return X_tr, y_tr, X_te, y_te, (spec.n_features, spec.hidden, spec.n_classes)


@pytest.mark.parametrize("axes", [("adc",), ("adc", "act"), ("adc", "wprec"),
                                  ("adc", "act", "wprec")], ids=",".join)
def test_relaxed_forward_and_gradients_match_reference(axes):
    X_tr, y_tr, _, _, sizes = _seeds()
    x = X_tr[:48].astype(np.float32)
    R, C, nl = 3, sizes[0], len(sizes) - 1
    rng = np.random.default_rng(len(axes))
    jcfg = jqat.MLPConfig(sizes)
    jp = jax.vmap(lambda k: jqat.init_mlp(k, jcfg))(jax.random.split(jax.random.PRNGKey(1), R))
    th = rng.normal(0, 1.0, (R, C, 15)).astype(np.float32)
    ph = rng.normal(0, 1.0, (R, nl - 1, 4)).astype(np.float32)
    ps = rng.normal(0, 1.0, (R, nl, 4)).astype(np.float32)
    G = rng.normal(size=(R, x.shape[0], sizes[-1])).astype(np.float32)
    tau = relaxed.anneal_tau(11, 30, 2.0, 0.2)

    def jf(p, t, f, s, g):
        out = jrelaxed.relaxed_forward(p, t, f, s, jnp.asarray(x), jrelaxed.anneal_tau(
            11.0, 30, 2.0, 0.2), jcfg, axes)[0]
        return jnp.sum(out * g), out

    (_, jout), jg = jax.vmap(jax.value_and_grad(jf, argnums=(0, 1, 2, 3), has_aux=True))(
        jp, th, ph, ps, G)
    params = params_from_jax({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    leaves = [*params.values()] + [torch.from_numpy(a) for a in (th, ph, ps)]
    for t in leaves:
        t.requires_grad_(True)
    out = relaxed.relaxed_forward(params, *leaves[-3:], torch.from_numpy(x), tau,
                                  qat.MLPConfig(sizes), axes)[0]
    (out * torch.from_numpy(G)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **RELAXED_TOL)
    for k in params:
        np.testing.assert_allclose(params[k].grad.numpy(), np.asarray(jg[0][k]), err_msg=k,
                                   **RELAXED_TOL)
    for name, t, j in zip(("theta", "phi", "psi"), leaves[-3:], jg[1:]):
        if t.grad is None:  # an axis that is off: its logits are unused
            assert not np.asarray(j).any(), name
        else:
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), err_msg=name,
                                       **RELAXED_TOL)


@pytest.mark.parametrize("axes", [("adc",), ("adc", "act", "wprec")], ids=",".join)
def test_harden_is_exact(axes):
    rng = np.random.default_rng(7)
    for n_layers in (2, 3):
        for i in range(5):
            th = rng.normal(size=(7, 15)).astype(np.float32)
            th[0, :3] = 0.0  # a logit at 0 stays dropped
            ph = rng.normal(size=(max(n_layers - 1, 1), 4)).astype(np.float32)
            ps = rng.normal(size=(n_layers, 4)).astype(np.float32)
            ps[0] = 1.0  # ties: the first choice, as np.argmax
            base = None if i % 2 else rng.integers(0, 3, 5)
            for g, w in zip(hybrid.harden(th, ph, ps, axes, n_layers, base),
                            jhybrid.harden(th, ph, ps, axes, n_layers, base)):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="base_cats"):
        hybrid.harden(th, ph, ps, axes, 2, np.zeros(4, np.int64))


def _reference_restart_draws(cfg, mlp_cfg, C):
    """The reference warm start's initial state of each restart (hybrid.py:258-270)."""
    n = 1 << mlp_cfg.adc_bits
    nl = len(mlp_cfg.layer_sizes) - 1
    jcfg = jqat.MLPConfig(mlp_cfg.layer_sizes, adc_bits=mlp_cfg.adc_bits)

    def one(key):
        kp, kt, ka, kw = jax.random.split(key, 4)
        p = jqat.init_mlp(kp, jcfg)
        th = 0.5 * jax.random.normal(kt, (C, n - 1))
        ph = jnp.zeros((max(nl - 1, 1), len(jchrom.ACT_APPROX_CHOICES))).at[:, 0].set(0.5)
        ph = ph + 0.25 * jax.random.normal(ka, ph.shape)
        ps = jnp.zeros((nl, len(jchrom.WPREC_CHOICES))).at[:, 0].set(0.5)
        ps = ps + 0.25 * jax.random.normal(kw, ps.shape)
        return p, th, ph, ps

    p, th, ph, ps = jax.vmap(one)(jax.random.split(jax.random.PRNGKey(cfg.seed), cfg.n_restarts))
    to = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return {k: to(v) for k, v in p.items()}, to(th), to(ph), to(ps)


def _reference_member_params(seeds, mlp_cfg):
    jcfg = jqat.MLPConfig(mlp_cfg.layer_sizes, adc_bits=mlp_cfg.adc_bits)
    p = jax.vmap(lambda s: jqat.init_mlp(jax.random.PRNGKey(s), jcfg))(
        jnp.asarray(np.asarray(seeds, np.uint32)))
    return {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def _gene_diff(got, want):
    (gm, gc), (wm, wc) = got, want
    assert gm.shape == wm.shape and gc.shape == wc.shape
    return ((gm != wm).sum() + (gc != wc).sum()) / (gm.size + gc.size)


AXES3 = ("adc", "act", "wprec")


def test_warm_start_matches_reference_from_carried_draws(monkeypatch):
    X_tr, y_tr, _, _, sizes = _seeds()
    monkeypatch.setattr(hybrid, "_restart_draws", _reference_restart_draws)
    cfg = hybrid.HybridConfig(grad_steps=12, n_restarts=3)
    jcfg = jhybrid.HybridConfig(grad_steps=12, n_restarts=3)
    got = hybrid.warm_start_genomes(X_tr, y_tr, sizes, 4, AXES3, cfg, device="cpu")
    want = jhybrid.warm_start_genomes(X_tr, y_tr, sizes, 4, AXES3, jcfg)
    assert got[0].shape[0] >= 1
    assert _gene_diff(got, want) <= GENE_DIFF_FRAC


def test_refiner_matches_reference_and_is_deterministic(monkeypatch):
    X_tr, y_tr, _, _, sizes = _seeds()
    monkeypatch.setattr(hybrid, "_member_params", _reference_member_params)
    cfg = hybrid.HybridConfig(grad_steps=10)
    jcfg = jhybrid.HybridConfig(grad_steps=10)
    rng = np.random.default_rng(2)
    P = 4
    masks = rng.uniform(size=(P, sizes[0] * 16)) < 0.5
    cards = jchrom.cat_cardinalities(AXES3, 2)
    cats = np.stack([rng.integers(0, c, P) for c in cards], 1).astype(np.int64)
    refine = hybrid.make_refiner(X_tr, y_tr, sizes, 4, AXES3, cfg, device="cpu")
    got = refine(masks, cats)
    want = jhybrid.make_refiner(X_tr, y_tr, sizes, 4, AXES3, jcfg)(masks, cats)
    assert _gene_diff(got, want) <= GENE_DIFF_FRAC
    np.testing.assert_array_equal(got[1][:, :5], cats[:, :5])  # the base genes stay
    again = refine(masks, cats)
    for g, a in zip(got, again):
        np.testing.assert_array_equal(g, a)
    # a member refines to the same genome alone as in the batch
    alone = refine(masks[2:3], cats[2:3])
    np.testing.assert_array_equal(alone[0][0], got[0][2])
    np.testing.assert_array_equal(alone[1][0], got[1][2])
    empty = refine(masks[:0], cats[:0])
    assert empty[0].shape == (0, masks.shape[1])


def test_train_relaxed_genome_runs_and_hardens():
    """The relaxed ablation end to end on the CPU: hardened genes re-evaluated exactly."""
    X_tr, y_tr, X_te, y_te, sizes = _seeds()
    cfg = relaxed.RelaxedConfig(steps=8)
    out = relaxed.train_relaxed_genome(X_tr, y_tr, X_te, y_te, sizes, cfg, device="cpu")
    assert out["mask"].shape == (sizes[0], 16) and out["mask"][:, 0].all()
    assert out["act_sel"].shape == (1,) and out["wprec"].shape == (2,)
    assert 0.0 <= out["acc"] <= 1.0 and out["area_cm2"] > 0
    hard, acc, a = relaxed.train_relaxed(X_tr, y_tr, X_te, y_te, sizes, dataclasses.replace(
        cfg, steps=4), device="cpu")
    assert hard.shape == (sizes[0], 16) and 0.0 <= acc <= 1.0 and a > 0
