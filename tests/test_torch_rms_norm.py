"""The norm kernel's wrapper, plan and order of summation on the CPU, and where
the transformer sends its norms.

* ``launch_plan`` covers every row and every 16-byte vector of a row once,
  at widths 128, 1024, 6144 and 8192, for 1 to 2M rows, in bf16 and fp32;
  it raises on a width the kernel cannot take.
* ``ref.rms_norm_emulation`` (the kernel's fp32 order) agrees with
  ``layers.rms_norm`` within the card test's tolerance
  (``tests/_torch_rms_norm.py``), with and without the residual.
* On the CPU the wrapper is ``layers.rms_norm`` bit for bit, and
  ``x + layers.rms_norm(o)`` in the residual form; it launches nothing.
* Routing: tensors that say they are on CUDA (a subclass whose ``is_cuda``
  is True) send every norm of a served ``forward``, ``prefill`` and
  ``decode_step`` to the wrapper (a stub that counts ``LAUNCHES``): 193 a
  K-EXAONE prefill at its 48 layers (96 with the residual), 97 an internvl2
  one; the loss path (``train=True``) sends none, and neither does a
  DTensor activation (fake CUDA DTensors in a subprocess).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_dist import last_json, run_py  # noqa: E402
from _torch_rms_norm import check_close  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels.rms_norm import ops, ref  # noqa: E402
from repro_torch.models import build_model, transformer  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

WIDTHS = (128, 1024, 6144, 8192)
ROWS = (1, 2, 31, 63, 64, 65, 255, 257, 4096, 32768, 262144, 2 * 1024 * 1024)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("d", WIDTHS)
def test_launch_plan_covers_every_row_and_vector_once(d, itemsize):
    per_vec = 16 // itemsize
    for rows in ROWS:
        p = ops.launch_plan(rows, d, itemsize)
        assert p.nvec == d // per_vec
        assert p.tpr & (p.tpr - 1) == 0 and p.tpr <= ops.MAX_THREADS_PER_ROW
        assert 1 <= p.vpt <= ops.MAX_VPT and p.block <= ops.MAX_THREADS_PER_ROW
        # vectors: lane t's j-th is t + j * tpr, kept below nvec
        lane, j = np.meshgrid(np.arange(p.tpr), np.arange(p.vpt), indexing="ij")
        v = (lane + j * p.tpr).ravel()
        hits = np.bincount(v[v < p.nvec], minlength=p.nvec)
        assert (hits == 1).all()
        # rows: block b's thread t holds row b * rows_per_block + t // tpr
        held = (np.arange(p.grid)[:, None] * p.rows_per_block
                + np.arange(p.rows_per_block)[None, :]).ravel()
        assert (np.bincount(held[held < rows], minlength=rows) == 1).all()
        assert (held >= rows).sum() < p.rows_per_block  # only the last block idles


def test_launch_plan_shapes_of_the_served_widths():
    wide = ops.launch_plan(32768, 6144, 2)  # ln1, ln2, final_norm: a block a row
    assert (wide.tpr, wide.vpt, wide.rows_per_block, wide.grid) == (256, 3, 1, 32768)
    head = ops.launch_plan(32768 * 64, 128, 2)  # q_norm: 64 rows a block
    assert (head.tpr, head.vpt, head.rows_per_block, head.grid) == (4, 4, 64, 32768)


@pytest.mark.parametrize("rows, d, itemsize", [(4, 12, 2), (4, 6, 4), (4, 8 * 8 * 513, 2),
                                               (0, 128, 2), (4, 0, 2)])
def test_launch_plan_refuses_what_the_kernel_cannot_take(rows, d, itemsize):
    with pytest.raises(ValueError):
        ops.launch_plan(rows, d, itemsize)


# ---------------------------------------------------------------------------
# the kernel's order of summation, emulated
# ---------------------------------------------------------------------------

def _inputs(shape, dtype, seed, spread=3.0):
    g = torch.Generator().manual_seed(seed)
    d = shape[-1]
    # rows of unlike scales, as hidden states have
    x = torch.randn(shape, generator=g) * torch.exp(spread * torch.rand(shape[:-1] + (1,),
                                                                        generator=g))
    scale = 1 + 0.2 * torch.randn(d, generator=g)
    res = 4 * torch.randn(shape, generator=g)
    return x.to(dtype), scale.to(dtype), res.to(dtype)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(4096, 128), (257, 1024), (1024, 6144), (300, 8192),
                                   (2, 64, 8, 128)])
def test_emulated_order_matches_layers_rms_norm(shape, dtype, residual):
    x, scale, res = _inputs(shape, dtype, seed=shape[0] + shape[-1])
    r = res if residual else None
    got = ref.rms_norm_emulation(x, scale, 1e-5, r)
    check_close(got, x, scale, 1e-5, r)


def test_emulation_walks_the_kernels_tree():
    # a row whose fp32 sum depends on the order: 2^24 from element 0 (lane 0)
    # and four ones in elements 4-7 (lane 1's first vector).  In index order
    # each one is lost against 2^24; the kernel sums lane 1's ones first and
    # meets lane 0 in the butterfly, where 2^24 + 4 is exact
    d = 8192
    x = torch.zeros(1, d, dtype=torch.float32)
    x[0, 0], x[0, 4:8] = 2.0 ** 12, 1.0
    p = ops.launch_plan(1, d, 4)
    assert (p.tpr, p.vpt, p.nvec) == (512, 4, 2048)
    sq = x.square().numpy()[0]
    assert np.cumsum(sq, dtype=np.float32)[-1] == 2.0 ** 24
    y = ref.rms_norm_emulation(x, torch.ones(d), 0.0)
    var = torch.tensor((2.0 ** 24 + 4) / d, dtype=torch.float32)  # exact in fp32
    assert torch.equal(y, x * torch.rsqrt(var))


# ---------------------------------------------------------------------------
# the wrapper on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(3, 6144), (2, 5, 8, 128), (7, 1024), (1, 16)])
def test_cpu_wrapper_is_layers_rms_norm_bit_for_bit(shape, dtype):
    x, scale, res = _inputs(shape, dtype, seed=7)
    before = dict(ops.LAUNCHES)
    assert torch.equal(ops.rms_norm(x, scale, 1e-6), L.rms_norm(x, scale, 1e-6))
    assert torch.equal(ops.rms_norm(x, scale, 1e-5, res), res + L.rms_norm(x, scale, 1e-5))
    assert ops.LAUNCHES == before


@pytest.mark.parametrize("case", ["scale_width", "residual_shape", "dtype", "scale_dtype",
                                  "int", "scalar"])
def test_wrapper_refuses_what_it_does_not_take(case):
    x, scale, res = _inputs((4, 128), torch.bfloat16, seed=1)
    args = {"scale_width": (x, scale[:64], None), "residual_shape": (x, scale, res[:2]),
            "dtype": (x.half(), scale.half(), None), "scale_dtype": (x, scale.float(), None),
            "int": (x.to(torch.int32), scale.to(torch.int32), None),
            "scalar": (x[0, 0], scale, None)}[case]
    with pytest.raises((ValueError, TypeError)):
        ops.rms_norm(args[0], args[1], 1e-6, args[2])


# ---------------------------------------------------------------------------
# routing in models/transformer.py
# ---------------------------------------------------------------------------

class _CudaLooking(torch.Tensor):
    """A CPU tensor that says it is on CUDA, so ``transformer.norm`` takes its
    CUDA branch."""

    @property
    def is_cuda(self):
        return True


@pytest.fixture
def counted(monkeypatch):
    """The wrapper replaced by its plain version, counting as the kernel does."""
    ops.reset_launch_counts()

    def stub(x, scale, eps=1e-6, residual=None):
        ops.LAUNCHES["rms_norm"] += 1
        ops.LAUNCHES["rms_norm_residual"] += residual is not None
        return ref.rms_norm_ref(x, scale, eps, residual)

    monkeypatch.setattr(ops, "rms_norm", stub)
    yield ops.LAUNCHES
    ops.reset_launch_counts()


def _model(arch, n_layers):
    cfg = dataclasses.replace(registry.reduced(registry.get(arch)), n_layers=n_layers)
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0))
    return cfg, model, params


def _inputs_of(cfg, S=12):
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (1, S), generator=g)
    patches = None
    if cfg.family == "vlm":
        patches = torch.rand((1, cfg.frontend_len, cfg.d_model), generator=g)
    return tokens, patches


@pytest.mark.parametrize("arch, per_call, residual", [
    ("k-exaone-236b-a23b", 193, 96),   # ln1 + ln2 (both residual), q_norm, k_norm; final
    ("internvl2-26b", 97, 0),          # ln1, ln2 (pre-norm); final
    ("yi-9b", 97, 0),
])
def test_served_norms_take_the_wrapper(counted, arch, per_call, residual):
    cfg, model, params = _model(arch, 48)
    tokens, patches = _inputs_of(cfg)
    looks = {k: v.as_subclass(_CudaLooking) for k, v in params.items()}
    with torch.inference_mode():
        served, cache = transformer.prefill(looks, tokens, cfg, patches)
        assert counted == {"rms_norm": per_call, "rms_norm_residual": residual}
        assert bool(torch.isfinite(served).all())
        ops.reset_launch_counts()
        kv = torch.full((1,), tokens.shape[1] + (cfg.frontend_len if patches is not None
                                                 else 0), dtype=torch.int32)
        full = {n: torch.zeros((t.shape[0], 1, kv.item() + 2, *t.shape[3:]), dtype=t.dtype)
                if not n.endswith("_win") else t.clone() for n, t in cache.items()}
        for n in ("k", "v"):
            full[n][:, :, : kv.item()] = cache[n]
        transformer.decode_step(looks, tokens[:, 0], full, kv, cfg)
        assert counted == {"rms_norm": per_call, "rms_norm_residual": residual}


@pytest.mark.parametrize("arch", ["k-exaone-236b-a23b", "internvl2-26b"])
def test_loss_path_takes_layers_rms_norm(counted, arch):
    cfg, model, params = _model(arch, 4)
    tokens, patches = _inputs_of(cfg)
    leaves = {k: v.as_subclass(_CudaLooking).detach().requires_grad_() for k, v in params.items()}
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    if patches is not None:
        batch["patch_embeds"] = patches
    loss = model.loss_fn(leaves, batch)
    torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    with torch.no_grad():
        transformer.forward(leaves, tokens, cfg, patches, train=True)
    assert counted == {"rms_norm": 0, "rms_norm_residual": 0}


ROUTES = r"""
import json
import torch, torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.kernels.rms_norm import ops
from repro_torch.models import transformer

dist.init_process_group("fake", rank=0, world_size=4, store=FakeStore())
calls = []

def stub(x, scale, eps=1e-6, residual=None):
    calls.append([type(x).__name__, list(x.shape), residual is not None])
    return torch.empty_like(x)

ops.rms_norm = stub
out = {}
mesh = DeviceMesh("cuda", torch.arange(4).reshape(2, 2), mesh_dim_names=("data", "model"))
with FakeTensorMode(), torch.no_grad():
    x = torch.empty((4, 16, 64), dtype=torch.bfloat16, device="cuda")
    s = torch.empty((64,), dtype=torch.bfloat16, device="cuda")
    xl = torch.empty((2, 16, 64), dtype=torch.bfloat16, device="cuda")
    dx = DTensor.from_local(xl, mesh, [Shard(0), Replicate()], run_check=False)
    ds = DTensor.from_local(s, mesh, [Replicate(), Replicate()], run_check=False)
    for name, fn in {
        "plain": lambda: transformer.norm(x, s, 1e-6),
        "plain_residual": lambda: transformer.norm(x, s, 1e-6, residual=x),
        "plain_train": lambda: transformer.norm(x, s, 1e-6, train=True),
        "dtensor": lambda: transformer.norm(dx, ds, 1e-6),
        "dtensor_residual": lambda: transformer.norm(dx, ds, 1e-6, residual=dx),
    }.items():
        calls.clear()
        y = fn()
        out[name] = {"calls": list(calls), "type": type(y).__name__}
print(json.dumps(out))
"""


def test_dtensor_activations_never_reach_the_wrapper():
    got = last_json(run_py(ROUTES, timeout=120))
    assert got["plain"]["calls"] == [["FakeTensor", [4, 16, 64], False]]
    assert got["plain_residual"]["calls"] == [["FakeTensor", [4, 16, 64], True]]
    assert got["plain_train"]["calls"] == []
    assert got["dtensor"] == {"calls": [], "type": "DTensor"}
    assert got["dtensor_residual"] == {"calls": [], "type": "DTensor"}
