"""The fused QAT training step on the CPU: its plain version, its plans, its counters.

``kernels.fused_qat.ops.qat_step`` runs a population's training step as five
launches on the card (K2, K3 and three kernels around them); on a CPU
tensor it takes ``ref.qat_step``, the same step in plain ops with its
backward written out as the kernels compute it.  These tests hold the
trainer's chain of ``core.qat`` ops and autograd (``trainer._chain_step``)
to the step ``core.trainer._train_block`` ran before
(``_torch_qat_step.todays_chain``), and ``ref.qat_step`` to that chain, bit
for bit, over a block of steps at every dataset's topology.  The kernels
themselves are held to the chain on the card
(``tests/test_torch_qat_step_card.py``).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from _torch_qat_step import STEPS, bucket, clone, dataset, same, todays_chain  # noqa: E402

from repro_torch.core import qat, trainer  # noqa: E402
from repro_torch.data import uci_synth  # noqa: E402
from repro_torch.kernels.fused_qat import ops, ref  # noqa: E402

DATASETS = sorted(uci_synth.DATASETS)
MOMENTUM = trainer.EvalConfig().momentum


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are tiny, and the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", DATASETS)
def test_plain_step_equals_todays_chain(name):
    """The trainer's chain (tables made once) and the CPU wrapper are the
    earlier ``_train_block`` chain, bit for bit."""
    X_tr, y_tr, sizes = dataset(name)
    mcfg, s = bucket(sizes, 6, X_tr.shape[0], seed=1)
    a, b, c = clone(s), clone(s), clone(s)
    todays_chain(X_tr, y_tr, mcfg, MOMENTUM, a, STEPS)
    for j in range(STEPS):
        trainer._chain_step(X_tr, y_tr, mcfg, MOMENTUM, b, j)
        ops.qat_step(X_tr, y_tr, c, j, MOMENTUM)  # the CPU wrapper: ref.qat_step
    assert same(a, b) and same(a, c)
    assert not torch.equal(a.params["w0"], s.params["w0"])  # it trained


def _topology(name):
    spec = uci_synth.DATASETS[name]
    return name, (spec.n_features, spec.hidden, spec.n_classes)


@pytest.mark.parametrize("name, sizes", [_topology(n) for n in DATASETS]
                         + [("seeds", (7, 4, 6, 3)), ("seeds", (7, 3, 3, 5, 3)), ("seeds", (7, 3))],
                         ids=DATASETS + ["two_hidden", "three_hidden", "no_hidden"])
def test_written_out_backward_equals_autograd(name, sizes):
    """The kernels' backward, written out in plain ops (``ref.qat_step``),
    equals the chain's autograd over a block."""
    X_tr, y_tr, _ = dataset(name)
    y_tr = y_tr % sizes[-1]
    mcfg, s = bucket(sizes, 5, X_tr.shape[0], seed=2)
    a, b = clone(s), clone(s)
    for j in range(STEPS):
        trainer._chain_step(X_tr, y_tr, mcfg, MOMENTUM, a, j)
        ref.qat_step(X_tr, y_tr, b, j, MOMENTUM)
    assert same(a, b)
    assert ref.layer_sizes(s.params) == tuple(sizes)


def test_step_takes_plain_buffers():
    """``ops.qat_step`` reads only ``ops.StepBuffers``: a bare one holding a
    bucket's tensors trains as the bucket does."""
    X_tr, y_tr, sizes = dataset("cardio")
    _, s = bucket(sizes, 4, X_tr.shape[0], seed=8)
    a, b = clone(s), clone(s)
    fields = [f.name for f in dataclasses.fields(ops.StepBuffers)]
    bare = ops.StepBuffers(**{k: getattr(b, k) for k in fields})
    assert type(bare) is ops.StepBuffers and not hasattr(bare, "masks")
    for j in range(STEPS):
        ops.qat_step(X_tr, y_tr, a, j, MOMENTUM)
        ops.qat_step(X_tr, y_tr, bare, j, MOMENTUM)
    assert same(a, b)


def test_kernel_package_imports_no_trainer():
    """The step's kernels take ``ops.StepBuffers``: ``kernels.fused_qat`` imports
    neither ``core.qat`` nor the trainer."""
    import subprocess
    import sys

    code = ("import sys, repro_torch.kernels.fused_qat.ops; "
            "print(sorted(m for m in sys.modules if m.startswith('repro_torch.core')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout
    assert eval(out) == ["repro_torch.core", "repro_torch.core.adc", "repro_torch.core.sums"]


def test_activation_gradient_at_the_rails():
    """relu -> clip01 -> quantize_uniform: nothing at or below 0, half at exactly 1,
    nothing above, the whole gradient between, NaN passed on; as autograd."""
    u = torch.tensor([-1.0, -0.0, 0.0, 1e-30, 0.3, 1.0, 1.5, float("nan")], requires_grad=True)
    out = qat.quantize_uniform(qat.clip01(torch.relu(u)), torch.tensor(4.0))
    ga = torch.tensor([1.0, 2.0, 3.0, 1e-45, 4.0, 5.0, 6.0, 7.0])
    (want,) = torch.autograd.grad(out, u, ga)
    got = ref._act_backward(u.detach(), ga)
    assert torch.equal(got, want)
    assert got.tolist() == [0.0, 0.0, 0.0, ga[3].item(), 4.0, 2.5, 0.0, 7.0]


@pytest.mark.parametrize("name", DATASETS)
def test_plans_take_every_dataset(name):
    spec = uci_synth.DATASETS[name]
    sizes = (spec.n_features, spec.hidden, spec.n_classes)
    for P in (1, 24, 240):
        prep, head = ops.prep_plan(P, 128, sizes), ops.head_plan(P, 128, sizes)
        upd = ops.update_plan(P, sizes)
        n_w = sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))
        assert prep.grid_x * prep.threads >= 128 * sizes[0] + n_w > (prep.grid_x - 1) * prep.threads
        assert upd.grid_x * upd.threads >= n_w + sum(sizes[1:]) > (upd.grid_x - 1) * upd.threads
        assert head.red_cols == 0  # B = 128: a warp a batch sum
        assert head.shared_bytes <= ops.MAX_SHARED_BYTES
    # weights 5x3 + 3 | z1, a1 (128 x 5 each) | d1, d2 (128 x 5, 128 x 3) | dce, labels
    cardio = ops.head_plan(24, 128, (21, 5, 3))
    assert cardio.red_cols == 0 and cardio.shared_bytes == 4 * (18 + 128 * (10 + 8 + 2))
    for B, cols in ((100, 23), (16, 23), (512, 0), (64, 0)):
        # other batches sum through a (B, red_cols) table: dw1, db1, db0 are 23 sums
        assert ops.head_plan(24, B, (21, 5, 3)).red_cols == cols, B


def test_every_dataset_takes_a_compiled_head():
    """The six datasets' (hidden, classes) have a head instance whose widths are
    known at compile time (``ops.HEAD_WIDTHS``, the kernel's dispatch)."""
    got = {(spec.hidden, spec.n_classes) for spec in uci_synth.DATASETS.values()}
    assert got <= set(ops.HEAD_WIDTHS)


def test_plans_raise_past_one_block():
    sizes = (21, 5, 3)
    with pytest.raises(ValueError, match="shared memory"):
        ops.head_plan(24, 128, (21, 32, 3))  # a row's activations outgrow one block
    with pytest.raises(ValueError, match="shared memory"):
        ops.head_plan(24, 4096, sizes)
    with pytest.raises(ValueError, match="at most 32"):
        ops.head_plan(24, 8, (21, 5, 33))
    for plan in (lambda s: ops.prep_plan(24, 128, s), lambda s: ops.head_plan(24, 128, s),
                 lambda s: ops.update_plan(24, s)):
        with pytest.raises(ValueError, match="layers"):
            plan((21, 5, 5, 5, 5, 3))
        with pytest.raises(ValueError, match="grid limit"):
            ops.prep_plan(ops.MAX_ROWS + 1, 128, sizes)
        with pytest.raises(ValueError, match="empty"):
            plan((21, 0, 3))
    ops.head_plan(24, 128, (21, 5, 5, 5, 3))  # MAX_LAYERS layers fit


def _rows(n_features: int, P: int, seed: int):
    rng = np.random.default_rng(seed)
    masks = rng.uniform(size=(P, n_features, 16)) < 0.6
    masks[:, :, 0] = True
    return (masks, rng.choice([8.0, 6.0, 4.0], P).astype(np.float32),
            rng.choice([4.0, 3.0, 5.0], P).astype(np.float32),
            rng.choice([16, 64, 128], P).astype(np.int32),
            rng.choice([60, 120], P).astype(np.int32),
            rng.choice([0.05, 0.1, 0.02], P).astype(np.float32),
            rng.integers(0, 2**31 - 1, P).astype(np.int32))


def test_fused_calls_count_adc_only_calls():
    X, y, spec = uci_synth.load("seeds")
    data = uci_synth.stratified_split(X, y, 0.7, 0)
    mcfg = qat.MLPConfig((spec.n_features, spec.hidden, spec.n_classes))
    cfg = trainer.EvalConfig(max_steps=12)
    rows = _rows(spec.n_features, 5, seed=3)
    adc = trainer.make_population_evaluator(*data, mcfg, cfg, device="cpu")
    three = trainer.make_population_evaluator(
        *data, mcfg, dataclasses.replace(cfg, genome_axes=("adc", "act", "wprec")), device="cpu")
    for _ in range(2):
        adc(*rows)
        three(*rows, np.zeros((5, 1), np.int64), np.full((5, 2), 8.0, np.float32))
    assert adc.stats["calls"] == adc.stats["fused_calls"] == 2
    assert three.stats["calls"] == 2 and three.stats["fused_calls"] == 0
    assert set(adc.stats) == {"calls", "captures", "warmup_steps", "replays", "fused_calls"}


def test_tables_made_once_a_call(monkeypatch):
    """``make_tables`` runs once a call, into the bucket's buffers, not once a step."""
    X, y, spec = uci_synth.load("seeds")
    data = uci_synth.stratified_split(X, y, 0.7, 0)
    mcfg = qat.MLPConfig((spec.n_features, spec.hidden, spec.n_classes))
    made = []

    def counted(fn):
        def wrapped(*a, **k):
            made.append(fn)
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(trainer, "make_tables", counted(trainer.make_tables))
    monkeypatch.setattr(ops, "make_tables", counted(ops.make_tables))
    for axes in (("adc",), ("adc", "act", "wprec")):
        made.clear()
        cfg = trainer.EvalConfig(max_steps=25, genome_axes=axes)
        run = trainer.make_population_evaluator(*data, mcfg, cfg, device="cpu")
        extra = () if axes == ("adc",) else (np.zeros((4, 1), np.int64),
                                             np.full((4, 2), 6.0, np.float32))
        run(*_rows(spec.n_features, 4, seed=5), *extra)
        run(*_rows(spec.n_features, 3, seed=6), *extra)
        assert len(made) == 2, axes  # one a call: none in the 25 steps or the test forward


def test_cpu_step_launches_nothing():
    X_tr, y_tr, sizes = dataset("cardio")
    mcfg, s = bucket(sizes, 4, X_tr.shape[0], seed=7)
    before = dict(ops.LAUNCHES)
    ops.qat_step(X_tr, y_tr, s, 0, MOMENTUM)
    assert ops.LAUNCHES == before
    assert {"qat_step_prep", "qat_step_head", "qat_step_update"} <= set(ops.LAUNCHES)
    with pytest.raises(ValueError, match="unsupported device"):  # no path, no fallback
        ops.qat_step(X_tr.to("meta"), y_tr, s, 0, MOMENTUM)
