"""The fused QAT step's kernels on the card (each test skips without a CUDA device).

    python3 -m pytest -q -m card tests    # on a machine with an NVIDIA H100

``ops.qat_step`` launches qat_step_prep, K2, qat_step_head, K3 and
qat_step_update; ``trainer._chain_step`` runs the chain of plain ops they
replace (K2/K3 inside it).  On the card the two give the same bits: over a
block of steps at P = 24 and P = 5, and through whole graphed row programs;
a row trained alone equals the same row in a batch; a replay adds one
launch of each step kernel a step.
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_qat_step import STEPS, bucket, clone, dataset, rows, same  # noqa: E402

from repro_torch.core import qat, trainer  # noqa: E402
from repro_torch.kernels.fused_qat import ops, ref  # noqa: E402

MOMENTUM = trainer.EvalConfig().momentum
STEP_KEYS = ("qat_step_prep", "qat_step_head", "qat_step_update")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the step's kernels run on the card only")
    from repro_torch import resolve_device

    return resolve_device("cuda")  # fp32 matmuls: TF32 off


@pytest.mark.card
@pytest.mark.parametrize("name, sizes, P, B", [
    ("cardio", None, 24, 128), ("cardio", None, 5, 128), ("balance", None, 24, 128),
    ("breast_cancer", None, 8, 128),
    # the head's other batch-sum paths: a (B, red_cols) table, a lane's 32 values
    ("cardio", None, 24, 100), ("cardio", None, 8, 16), ("seeds", None, 8, 512),
    # the head's generic instance: widths read at run time, any depth
    ("seeds", (7, 4, 6, 3), 8, 128), ("seeds", (7, 3, 3, 5, 3), 8, 100), ("seeds", (7, 3), 8, 128),
    ("seeds", (7, 5, 2), 8, 128)])
def test_kernels_equal_plain_step(card, name, sizes, P, B):
    X_tr, y_tr, own = dataset(name, card)
    sizes = sizes or own
    y_tr = y_tr % sizes[-1]
    mcfg, s = bucket(sizes, P, X_tr.shape[0], seed=P, device=card, max_batch=B)
    fused, plain, emul = clone(s), clone(s), clone(s)
    k2_k3 = (ops.fused_forward, ops.fused_backward)
    for j in range(STEPS):
        ops.qat_step(X_tr, y_tr, fused, j, MOMENTUM)
        trainer._chain_step(X_tr, y_tr, mcfg, MOMENTUM, plain, j)
        ref.qat_step(X_tr, y_tr, emul, j, MOMENTUM, first_layer=k2_k3)
    torch.cuda.synchronize()
    assert same(plain, emul), "the written-out backward parts from autograd on the card"
    assert same(fused, plain)


@pytest.mark.card
def test_row_alone_equals_row_in_batch(card):
    X_tr, y_tr, sizes = dataset("cardio", card)
    mcfg, s = bucket(sizes, 24, X_tr.shape[0], seed=3, device=card)
    batch = clone(s)
    for j in range(STEPS):
        ops.qat_step(X_tr, y_tr, batch, j, MOMENTUM)
    for p in (0, 11, 23):
        alone = rows(s, slice(p, p + 1))
        for j in range(STEPS):
            ops.qat_step(X_tr, y_tr, alone, j, MOMENTUM)
        assert same(alone, rows(batch, slice(p, p + 1))), p


def _rows(P: int, seed: int):
    import numpy as np

    from repro_torch.data import uci_synth

    X, y, spec = uci_synth.load("cardio")
    data = uci_synth.stratified_split(X, y, 0.7, 0)
    rng = np.random.default_rng(seed)
    masks = rng.uniform(size=(P, spec.n_features, 16)) < rng.uniform(0.2, 1.0, (P, 1, 1))
    masks[:, :, 0] = True
    row = (masks, rng.choice([8.0, 6.0, 4.0], P).astype(np.float32),
           rng.choice([4.0, 3.0, 5.0], P).astype(np.float32),
           rng.choice([16, 64, 128], P).astype(np.int32),
           rng.choice([1, 3, 120], P).astype(np.int32),
           rng.choice([0.05, 0.1, 0.02], P).astype(np.float32))
    seeds = rng.integers(0, 2**31 - 1, P)
    return data, qat.MLPConfig((spec.n_features, spec.hidden, spec.n_classes)), row, seeds


@pytest.mark.card
@pytest.mark.parametrize("P", [24, 5])
def test_graphed_program_equals_plain_chain(card, monkeypatch, P):
    """Whole row programs replayed from graphs, the fused step's and the plain
    chain's (ops.qat_step swapped for trainer._chain_step while its graphs
    are captured): the same accuracies and parameters.  P = 5 pads to bucket 8."""
    data, mcfg, row, seeds = _rows(P, seed=P)
    cfg = trainer.EvalConfig(max_steps=60)
    params0, idx = trainer.draw_rows(seeds, cfg, mcfg, data[0].shape[0])
    fused = trainer.make_row_program(*data, mcfg, cfg, device=card)
    chain = trainer.make_row_program(*data, mcfg, cfg, device=card)
    acc, params = fused(*row, params0, idx)
    with monkeypatch.context() as m:
        m.setattr(ops, "qat_step", lambda X, y, s, j, mom: trainer._chain_step(X, y, mcfg, mom,
                                                                               s, j))
        acc_c, params_c = chain(*row, params0, idx)
    acc_r, params_r = chain(*row, params0, idx)  # replayed, the swap undone
    assert torch.equal(acc, acc_c) and torch.equal(acc, acc_r)
    for k in params:
        assert torch.equal(params[k], params_c[k]) and torch.equal(params[k], params_r[k]), k
    assert fused.stats["fused_calls"] == fused.stats["calls"] == 1


@pytest.mark.card
def test_replay_adds_one_launch_of_each_step_kernel(card):
    data, mcfg, row, seeds = _rows(8, seed=1)
    cfg = trainer.EvalConfig(max_steps=20)
    params0, idx = trainer.draw_rows(seeds, cfg, mcfg, data[0].shape[0])
    run = trainer.make_row_program(*data, mcfg, cfg, device=card)
    ops.reset_launch_counts()
    run(*row, params0, idx)  # warm-up steps and a capture, then two replays
    torch.cuda.synchronize()
    warm = trainer.WARMUP_STEPS
    assert run.stats["captures"] == 1 and run.stats["replays"] == 2
    assert ops.LAUNCHES == {**{k: 20 + warm for k in STEP_KEYS},
                            "fused_qat_forward": 21 + warm, "fused_qat_backward": 20 + warm}
    ops.reset_launch_counts()
    run(*row, params0, idx)
    assert ops.LAUNCHES == {**{k: 20 for k in STEP_KEYS},
                            "fused_qat_forward": 21, "fused_qat_backward": 20}
