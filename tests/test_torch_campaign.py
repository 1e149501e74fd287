"""The port's campaign, co-design config and population trainer against the reference.

Under one deterministic objective (``_torch_shared``: both packages'
evaluators replaced, which also routes round the reference's sharding
fault under JAX 0.9.0) ``run_campaign`` of the two packages gives the same
gains, table, fronts and counters, times aside; a rerun over the same
``memo_dir`` trains zero rows.  ``validate()`` rejects exactly what the
reference rejects, and the options the port lacks raise
``NotImplementedError`` naming their ROADMAP item.

On the port's real trainer, on the CPU: training in blocks of S steps
through static buffers is bit-equal to the per-step loop, a bucket-padded
call equals its unpadded rows, ``dispatch()`` then ``resolve()`` equals
the blocking call, and a CUDA graph asked for on the CPU raises.
"""

import dataclasses
import math
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from _torch_shared import assert_same_codesign, patch_evaluators  # noqa: E402

from repro.core import campaign as jcampaign  # noqa: E402
from repro.core import codesign as jcodesign  # noqa: E402
from repro.data import uci_synth  # noqa: E402
from repro_torch.core import campaign, codesign, qat, trainer  # noqa: E402
from repro_torch.launch import campaign as cli  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are tiny, and the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the validation matrix ----------------------------------------------------------

OVERRIDES = [
    dict(), dict(memoize=False), dict(num_islands=4, stacked_islands=True),
    dict(num_islands=4, async_pipeline=True), dict(async_pipeline=True, memoize=False),
    dict(surrogate=True), dict(surrogate=True, num_islands=2, stacked_islands=True),
    dict(resume=True, checkpoint_dir="ck"), dict(migration_topology="none", num_islands=3),
    dict(genome_axes="adc,act,wprec"), dict(surrogate_explore_frac=0.0),
    dict(surrogate_explore_frac=1.0), dict(hybrid_warm_frac=0.5), dict(hybrid_refine_every=2),
    dict(surrogate=True, memoize=False), dict(stacked_islands=True, memoize=False),
    dict(stacked_islands=True, async_pipeline=True),
    dict(async_pipeline=True, num_islands=2, memoize=False), dict(resume=True),
    dict(checkpoint_every=0), dict(checkpoint_every=-3), dict(num_islands=0),
    dict(num_islands=-1), dict(migration_interval=0), dict(migration_size=-1),
    dict(migration_topology="star"), dict(pop_size=1), dict(n_generations=-1),
    dict(surrogate_min_rows=0), dict(surrogate_explore_frac=-0.1),
    dict(surrogate_explore_frac=1.5), dict(genome_axes="act"), dict(genome_axes="adc,bogus"),
    dict(hybrid_warm_frac=1.5), dict(hybrid_refine_every=-1), dict(hybrid_grad_steps=0),
    dict(hybrid_warm_frac=0.2, memoize=False),
]


def _verdict(make):
    try:
        make().validate()
        return None
    except ValueError as e:
        return str(e)


@pytest.mark.parametrize("overrides", OVERRIDES, ids=lambda o: ",".join(o) or "defaults")
def test_validate_matrix_equals_reference(overrides):
    got = _verdict(lambda: codesign.CodesignConfig(**overrides))
    assert got == _verdict(lambda: jcodesign.CodesignConfig(**overrides))
    fields = {f.name for f in dataclasses.fields(campaign.CampaignConfig)}
    kw = {k: v for k, v in overrides.items() if k in fields}
    assert _verdict(lambda: campaign.CampaignConfig(datasets=("seeds",), **kw)) == _verdict(
        lambda: jcampaign.CampaignConfig(datasets=("seeds",), **kw))


def test_campaign_validation_and_fingerprints():
    for ds in ((), ("seeds", "nope")):
        assert _verdict(lambda: campaign.CampaignConfig(datasets=ds)) == _verdict(
            lambda: jcampaign.CampaignConfig(datasets=ds)) is not None
    fields = {f.name for f in dataclasses.fields(jcampaign.CampaignConfig)}
    assert fields | {"device"} == {f.name for f in dataclasses.fields(campaign.CampaignConfig)}
    ours, ref = campaign.CampaignConfig(), jcampaign.CampaignConfig()
    assert {k: getattr(ours, k) for k in fields} == {k: getattr(ref, k) for k in fields}
    for kw in (dict(), dict(surrogate=True, surrogate_min_rows=40), dict(hybrid_warm_frac=0.5),
               dict(genome_axes="adc,act")):
        fp = codesign.CodesignConfig(**kw).search_fingerprint()
        assert fp.pop("backend") == "torch"
        assert fp == jcodesign.CodesignConfig(**kw).search_fingerprint()


@pytest.mark.parametrize("overrides,item", [
    (dict(genome_axes="adc,act"), "item 6"), (dict(surrogate=True), "item 7"),
    (dict(hybrid_warm_frac=0.25), "item 7"), (dict(hybrid_refine_every=3), "item 7"),
])
def test_unported_options_raise(overrides, item):
    cfg = codesign.CodesignConfig(**overrides, device="cpu")
    assert cfg.validate() is cfg
    with pytest.raises(NotImplementedError, match=item):
        codesign.run_codesign(cfg)
    with pytest.raises(NotImplementedError, match=item):
        campaign.run_campaign(campaign.CampaignConfig(datasets=("seeds",), device="cpu",
                                                      **overrides))


def test_service_backend_raises():
    with pytest.raises(NotImplementedError, match="item 8"):
        codesign.make_service_backend(codesign.CodesignConfig(device="cpu"))


@pytest.mark.parametrize("flags,item", [
    (["--genome-axes", "adc,wprec"], "item 6"), (["--surrogate"], "item 7"),
    (["--hybrid-warm-frac", "0.5"], "item 7"), (["--hybrid-refine-every", "2"], "item 7"),
])
def test_cli_unported_flags_raise(monkeypatch, flags, item):
    monkeypatch.setattr(sys, "argv", ["campaign", "--quick", "--device", "cpu", *flags])
    with pytest.raises(NotImplementedError, match=item):
        cli.main()


def test_cli_rejects_what_validate_rejects(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["campaign", "--stacked-islands", "--async-pipeline"])
    with pytest.raises(SystemExit):
        cli.main()


# -- campaigns under one objective ---------------------------------------------------

SMALL = dict(datasets=("seeds", "balance", "vertebral3"), pop_size=6, n_generations=3,
             step_scale=0.1, max_steps=40)


@pytest.mark.parametrize("drivers", [
    {}, {"memoize": False}, {"num_islands": 2, "migration_interval": 1},
    {"num_islands": 3, "stacked_islands": True, "migration_interval": 2},
    {"num_islands": 2, "async_pipeline": True}, {"async_pipeline": True},
    {"use_fused_kernel": True},
])
def test_campaign_equals_reference(monkeypatch, drivers):
    patch_evaluators(monkeypatch)
    got = campaign.run_campaign(campaign.CampaignConfig(**SMALL, **drivers, device="cpu"))
    want = jcampaign.run_campaign(jcampaign.CampaignConfig(**SMALL, **drivers))
    assert list(got.results) == list(want.results)
    for ds in want.results:
        assert_same_codesign(got.results[ds], want.results[ds])
        g, w = got.gains[ds], want.gains[ds]
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    for k in ("n_evaluations", "n_memo_hits", "n_deferred", "mean_area_gain", "mean_power_gain"):
        assert getattr(got, k) == getattr(want, k), k
    # the table, times aside (each package's own wall clock)
    assert got.table == jcampaign.format_gains_table(want.gains, got.wall_s, want.results)
    assert campaign.format_gains_table(got.gains) == jcampaign.format_gains_table(want.gains)
    assert "paper: x11.2" in got.table


def test_memo_dir_rerun_trains_zero_rows(monkeypatch, tmp_path):
    patch_evaluators(monkeypatch)
    cfg = campaign.CampaignConfig(**SMALL, memo_dir=str(tmp_path), device="cpu")
    first = campaign.run_campaign(cfg)
    again = campaign.run_campaign(cfg)
    assert first.n_evaluations > 0 and again.n_evaluations == 0
    assert again.n_memo_hits == first.n_evaluations + first.n_memo_hits
    for ds in cfg.datasets:
        np.testing.assert_array_equal(again.results[ds].front_acc, first.results[ds].front_acc)
        np.testing.assert_array_equal(again.results[ds].front_masks,
                                      first.results[ds].front_masks)
    # a memo is one dataset's: another config's fingerprint is refused
    with pytest.raises(ValueError, match="refusing"):
        campaign.run_campaign(dataclasses.replace(cfg, max_steps=41))


def test_cli_prints_the_gains_table(monkeypatch, capsys):
    patch_evaluators(monkeypatch)
    monkeypatch.setattr(sys, "argv", ["campaign", "--quick", "--datasets", "seeds,cardio",
                                      "--islands", "2", "--device", "cpu"])
    cli.main()
    out = capsys.readouterr().out
    for s in ("seeds", "cardio", "MEAN", "total QAT rows trained", "2 islands"):
        assert s in out


# -- the population trainer on the CPU ------------------------------------------------


def _data(name="seeds"):
    X, y, spec = uci_synth.load(name)
    return (*uci_synth.stratified_split(X, y, 0.7, 0),
            qat.MLPConfig((spec.n_features, spec.hidden, spec.n_classes)))


def _rows(C, P, seed):
    rng = np.random.default_rng(seed)
    masks = rng.uniform(size=(P, C, 16)) < rng.uniform(0.2, 1.0, (P, 1, 1))
    masks[:, :, 0] = True
    return (masks, rng.choice([8.0, 6.0, 4.0], P).astype(np.float32),
            rng.choice([4.0, 3.0, 5.0], P).astype(np.float32),
            rng.choice([16, 64, 128], P).astype(np.int32),
            rng.choice([1, 60], P).astype(np.int32),
            rng.choice([0.05, 0.1, 0.02], P).astype(np.float32),
            rng.integers(0, 2**31 - 1, P).astype(np.int32))


def _per_step_loop(X_tr, y_tr, X_te, y_te, mcfg, cfg, rows, params0, idx):
    """The port's eager loop before the blocks: one step at a time, no static buffers."""
    masks, wb, ab, bs, ep, lr = rows
    X_tr, X_te = torch.as_tensor(X_tr), torch.as_tensor(X_te)
    y_tr, y_te = torch.as_tensor(y_tr, dtype=torch.int64), torch.as_tensor(y_te,
                                                                         dtype=torch.int64)
    masks, P = torch.as_tensor(masks), masks.shape[0]
    wb, ab = torch.as_tensor(wb), torch.as_tensor(ab)
    bs = torch.as_tensor(bs, dtype=torch.int64)
    t = torch.arange(cfg.max_steps, dtype=torch.float32)
    lrs, gates = [], []
    for b, e, r in zip(bs.tolist(), ep.tolist(), lr.tolist()):
        b32, e32, r32 = (torch.tensor(v, dtype=torch.float32) for v in (b, e, r))
        budget = torch.clamp(torch.clamp(e32 * torch.ceil(X_tr.shape[0] / b32) * cfg.step_scale,
                                         min=1.0), max=float(cfg.max_steps))
        lrs.append(r32 * 0.5 * (1.0 + torch.cos(math.pi * torch.clamp(t / budget, max=1.0))))
        gates.append((t < budget).to(torch.float32))
    lr_sched, gate = torch.stack(lrs), torch.stack(gates)
    w = (torch.arange(cfg.max_batch) < bs[:, None]).to(torch.float32)
    denom = torch.clamp(w.sum(-1), min=1.0)
    params = {k: v.detach().clone().requires_grad_(True) for k, v in params0.items()}
    vel = {k: torch.zeros_like(v) for k, v in params.items()}
    for step in range(cfg.max_steps):
        it = idx[:, step]
        logits = qat.mlp_forward(params, X_tr[it], mcfg, masks, wb, ab)
        loss = ((w * qat.cross_entropy(logits, y_tr[it])) / denom[:, None]).sum()
        grads = torch.autograd.grad(loss, list(params.values()))
        with torch.no_grad():
            for (k, p), g in zip(params.items(), grads):
                shape = (P,) + (1,) * (p.ndim - 1)
                vel[k] = cfg.momentum * vel[k] - lr_sched[:, step].view(shape) * g
                p.add_(gate[:, step].view(shape) * vel[k])
    with torch.no_grad():
        acc = qat.accuracy(qat.mlp_forward(params, X_te.expand(P, -1, -1), mcfg, masks, wb, ab),
                           y_te.expand(P, -1))
    return acc, {k: v.detach() for k, v in params.items()}


@pytest.mark.parametrize("block_steps", [1, 5, 7, 23, 40])
def test_blocks_equal_the_per_step_loop(block_steps):
    """S = 7 leaves a tail block of 2 steps; S >= max_steps is one block."""
    *data, mcfg = _data()
    cfg = trainer.EvalConfig(max_steps=23, block_steps=block_steps)
    rows = _rows(7, 5, seed=1)
    params0, idx = trainer.draw_rows(rows[6], cfg, mcfg, data[0].shape[0])
    acc, params = trainer.make_row_program(*data, mcfg, cfg, device="cpu")(*rows[:6], params0, idx)
    want_acc, want = _per_step_loop(*data, mcfg, cfg, rows[:6], params0, idx)
    assert torch.equal(acc, want_acc)
    for k in want:
        assert torch.equal(params[k], want[k]), k


def test_bucket_padding_equals_the_unpadded_rows():
    *data, mcfg = _data()
    rows = _rows(7, 5, seed=2)
    out = {}
    for granule in (1, 4, 8):  # buckets of 5, 8 and 8 rows
        cfg = trainer.EvalConfig(max_steps=12, block_steps=5, pad_granule=granule)
        params0, idx = trainer.draw_rows(rows[6], cfg, mcfg, data[0].shape[0])
        run = trainer.make_row_program(*data, mcfg, cfg, device="cpu")
        out[granule] = run(*rows[:6], params0, idx)
        assert out[granule][0].shape == (5,)
        assert run.stats["calls"] == 1
    for granule in (4, 8):
        assert torch.equal(out[granule][0], out[1][0])
        for k in out[1][1]:
            assert torch.equal(out[granule][1][k], out[1][1][k])


def test_dispatch_then_resolve_equals_evaluate():
    *data, mcfg = _data()
    ev = trainer.make_population_evaluator(*data, mcfg, trainer.EvalConfig(max_steps=10),
                                           device="cpu")
    a, b = _rows(7, 3, seed=3), _rows(7, 6, seed=4)
    ra, rb = ev.dispatch(*a), ev.dispatch(*b)  # two calls in flight, resolved in turn
    np.testing.assert_array_equal(rb(), ev(*b))
    np.testing.assert_array_equal(ra(), ev(*a))
    assert ev.stats["calls"] == 4
    np.testing.assert_array_equal(ev.rebuild(1)(*a), ra())


def test_graph_needs_the_card_and_inputs_are_checked():
    *data, mcfg = _data()
    with pytest.raises(ValueError, match="CUDA graphs"):
        trainer.make_row_program(*data, mcfg, trainer.EvalConfig(), device="cpu", graph=True)
    with pytest.raises(ValueError, match="CUDA graphs"):
        trainer.make_population_evaluator(*data, mcfg, device="cpu", graph=True)
    with pytest.raises(ValueError, match="block_steps"):
        trainer.make_row_program(*data, mcfg, trainer.EvalConfig(block_steps=0), device="cpu")
    with pytest.raises(ValueError, match="n_devices"):
        trainer.make_population_evaluator(*data, mcfg, device="cpu", n_devices=2)
    cfg = trainer.EvalConfig(max_steps=4)
    run = trainer.make_row_program(*data, mcfg, cfg, device="cpu")
    rows = _rows(7, 2, seed=5)
    params0, idx = trainer.draw_rows(rows[6], cfg, mcfg, data[0].shape[0])
    with pytest.raises(ValueError, match="idx"):
        run(*rows[:6], params0, idx[:, :3])
    # graph=False on the CPU is the plain loop too
    plain = trainer.make_row_program(*data, mcfg, cfg, device="cpu", graph=False)
    assert torch.equal(plain(*rows[:6], params0, idx)[0], run(*rows[:6], params0, idx)[0])
