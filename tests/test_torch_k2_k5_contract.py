"""K5's kv_len contract and K2's launch plan, on the CPU.

K5 (``kernels/decode_attn``): ``decode_attention(q, k, v, kv_len=None)``
takes None as the full cache, as the JAX package's wrapper does, and reads
nothing of kv_len on the host.  A row with ``kv_len <= 0`` has no position
and is NaN in the plain version (as in the reference's), in the emulation of
the kernels' split-and-merge, and through the CPU wrapper; the other rows of
the batch are computed as usual.  Tolerance against the JAX package: the
fp32 bound of ``tests/test_torch_attention.py`` (rtol = atol = 2e-5).

K2 (``kernels/fused_qat/csrc/fused_qat.cu``) runs on the launch that
``fused_qat.ops.forward_plan`` plans from shapes alone; the tests walk each
plan as the kernel does and check that it covers every (sample, channel) of
a row and every (sample, unit) output exactly once, within the block's
limits.  The CPU wrapper's forward is held against the Pallas ``_fwd_kernel``
in interpret mode at rtol = atol = 1e-6, the reference's own fused-vs-unfused
bound.  Inputs come from a seed with numpy.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.decode_attn import ops as jda  # noqa: E402
from repro.kernels.fused_qat import fused_qat as jfq  # noqa: E402
from repro.kernels.pruned_quant import ref as jpq  # noqa: E402
from repro_torch.kernels.decode_attn import ops as da  # noqa: E402
from repro_torch.kernels.decode_attn import ref as dref  # noqa: E402
from repro_torch.kernels.fused_qat import ops as fq  # noqa: E402
from repro_torch.kernels.pruned_quant.ref import make_tables  # noqa: E402

FP32 = dict(rtol=2e-5, atol=2e-5)
K2_TOL = dict(rtol=1e-6, atol=1e-6)
N_BITS = 4
SCALE = 1.0 / (1 << N_BITS)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are tiny, and the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _decode_inputs(B, Hq, Hkv, S, d, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in ((B, Hq, d), (B, S, Hkv, d), (B, S, Hkv, d)))


# ---------------------------------------------------------------------------
# K5: kv_len=None and empty rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 8, 4, 96, 64), (3, 4, 4, 200, 32)])
def test_decode_kv_len_none_is_the_full_cache(shape):
    B, Hq, Hkv, S, d = shape
    q, k, v = _decode_inputs(*shape)
    got = da.decode_attention(*map(torch.from_numpy, (q, k, v)))
    full = da.decode_attention(*map(torch.from_numpy, (q, k, v)),
                               torch.full((B,), S, dtype=torch.int32))
    want = jda.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None,
                                use_pallas=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)
    assert torch.equal(got, full)


def _with_empty_rows(S):
    """kv_len of a batch of four: an empty row, a ragged one, a negative one, a full one."""
    return torch.tensor([0, S // 3, -1, S], dtype=torch.int32)


@pytest.mark.parametrize("impl", ["ref", "wrapper", "split_emulation"])
def test_decode_empty_row_is_nan_and_leaves_the_others(impl):
    B, Hq, Hkv, S, d = 4, 8, 2, 160, 64
    q, k, v = map(torch.from_numpy, _decode_inputs(B, Hq, Hkv, S, d, seed=3))
    kv_len = _with_empty_rows(S)
    n_split, chunk = da.split_plan(B, Hkv, S)
    assert n_split > 1  # empty rows meet the merge of several partials
    fn = {"ref": dref.decode_attention_ref, "wrapper": da.decode_attention,
          "split_emulation": lambda *a: dref.decode_attention_split_emulation(
              *a, n_split, chunk)}[impl]
    out = fn(q, k, v, kv_len)
    empty = kv_len <= 0
    assert bool(out[empty].isnan().all())
    assert bool(out[~empty].isfinite().all())
    # the same batch with those rows given positions: the other rows' bits stay
    filled = torch.where(empty, torch.tensor(S, dtype=torch.int32), kv_len)
    torch.testing.assert_close(out[~empty], fn(q, k, v, filled)[~empty], rtol=0, atol=0)
    # and the other rows alone, within the fp32 bound (einsum may block a
    # smaller batch otherwise)
    keep = torch.nonzero(~empty).flatten()
    torch.testing.assert_close(out[keep], fn(q[keep], k[keep], v[keep], kv_len[keep]), **FP32)


def test_decode_split_emulation_empty_row_with_one_split():
    """n_split = 1: the row's one chunk is empty, and the merge gives NaN."""
    B, Hq, Hkv, S, d = 4, 4, 4, 64, 32
    q, k, v = map(torch.from_numpy, _decode_inputs(B, Hq, Hkv, S, d, seed=4))
    kv_len = _with_empty_rows(S)
    n_split, chunk = da.split_plan(B, Hkv, S)
    assert n_split == 1
    out = dref.decode_attention_split_emulation(q, k, v, kv_len, n_split, chunk)
    want = dref.decode_attention_ref(q, k, v, kv_len)
    assert bool(out[kv_len <= 0].isnan().all())
    torch.testing.assert_close(out[kv_len > 0], want[kv_len > 0], **FP32)


def test_decode_empty_row_matches_the_reference_plain_version():
    """The reference's plain version gives the same NaN rows and the same others."""
    B, Hq, Hkv, S, d = 4, 8, 2, 96, 64
    q, k, v = _decode_inputs(B, Hq, Hkv, S, d, seed=5)
    kv_len = _with_empty_rows(S)
    got = da.decode_attention(*map(torch.from_numpy, (q, k, v)), kv_len).numpy()
    want = np.asarray(jda.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           jnp.asarray(kv_len.numpy()), use_pallas=False))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got[1::2], want[1::2], **FP32)


def test_decode_wrapper_reads_nothing_on_the_host(monkeypatch):
    """A CPU kv_len with a 0 in it no longer raises, and the checks read no
    value of kv_len: reading one back raises here."""
    q = torch.zeros(2, 4, 16)
    k = torch.zeros(2, 8, 2, 16)
    kv_len = torch.tensor([3, 0], dtype=torch.int32)
    out = da.decode_attention(q, k, k, kv_len)
    assert bool(out[1].isnan().all()) and bool(out[0].isfinite().all())

    def no_host_read(*_a, **_k):
        raise AssertionError("kv_len was read on the host")

    for name in ("item", "tolist", "__int__", "__bool__", "min", "max"):
        monkeypatch.setattr(torch.Tensor, name, no_host_read)
    assert da._check(q, k, k, kv_len) == (2, 8, 2, 2, 16)
    assert da._check(q, k, k, None) == (2, 8, 2, 2, 16)


# ---------------------------------------------------------------------------
# K2: the launch plan, and the CPU forward against Pallas
# ---------------------------------------------------------------------------

def _walk(plan, P, B, C, F):
    """Count what each block's threads touch, as the kernel indexes: element
    t of the tile in the comparator stage, output t in the matmul stage."""
    elems = np.zeros((P, B, C), np.int64)
    outs = np.zeros((P, B, F), np.int64)
    t = np.arange(plan.threads)
    for p in range(P):
        for bx in range(plan.grid_x):
            b0 = bx * plan.tile
            rows = min(plan.tile, B - b0)
            assert rows >= 1
            e = t[t < rows * C]
            np.add.at(elems[p], (b0 + e // C, e % C), 1)
            o = t[t < rows * F]
            np.add.at(outs[p], (b0 + o // F, o % F), 1)
    return elems, outs


@pytest.mark.parametrize("C", [4, 5, 6, 7, 9, 21])
@pytest.mark.parametrize("B", [1, 7, 128, 129, 638])
def test_forward_plan_covers_every_element_and_output_once(B, C):
    P, F, T = 2, 5 if C == 21 else 3, 15
    plan = fq.forward_plan(P, B, C, F, T)
    assert plan.threads <= fq.MAX_THREADS and plan.threads % 32 == 0
    assert plan.threads >= plan.tile * max(C, F)
    assert plan.shared_bytes <= fq.MAX_SHARED_BYTES
    assert plan.shared_bytes == 4 * (2 * C * T + C * F + plan.tile * C)
    elems, outs = _walk(plan, P, B, C, F)
    assert (elems == 1).all() and (outs == 1).all()


def test_forward_plan_fills_the_card_at_the_training_shape():
    plan = fq.forward_plan(24, 128, 21, 5, 15)
    assert plan.grid_x * 24 >= 96
    assert plan.tile == fq.TILE


@pytest.mark.parametrize("tile", [8, 16, 32])
def test_forward_plan_candidate_tiles(tile, monkeypatch):
    """The tiles phase 3 of chip_smoke.py times (it sets TILE) all cover a row once."""
    monkeypatch.setattr(fq, "TILE", tile)
    plan = fq.forward_plan(3, 638, 21, 5, 15)
    assert plan.tile == tile and plan.grid_x == -(-638 // tile)
    elems, outs = _walk(plan, 3, 638, 21, 5)
    assert (elems == 1).all() and (outs == 1).all()


def test_forward_plan_shrinks_the_tile_for_wide_rows_and_raises_past_the_limits():
    wide = fq.forward_plan(1, 128, 300, 5, 15)  # 300 channels: 3 samples a block
    assert wide.tile * 300 <= fq.MAX_THREADS and wide.shared_bytes <= fq.MAX_SHARED_BYTES
    elems, outs = _walk(wide, 1, 128, 300, 5)
    assert (elems == 1).all() and (outs == 1).all()
    # 341 channels still fit one sample's tables, weights and h in 48 KB; 342 do not
    assert fq.forward_plan(1, 4, 341, 5, 15).tile == 1
    with pytest.raises(ValueError, match="shared memory"):
        fq.forward_plan(1, 4, 342, 5, 15)
    with pytest.raises(ValueError, match="threads"):
        fq.forward_plan(1, 4, 1025, 1, 1)
    with pytest.raises(ValueError, match="empty launch"):
        fq.forward_plan(1, 0, 21, 5, 15)


@pytest.mark.parametrize("C", [4, 9])
def test_cpu_forward_matches_pallas_row_by_row(C):
    P, B, F = 3, 200, 3
    rng = np.random.default_rng(C)
    x = rng.uniform(-0.1, 1.1, (P, B, C)).astype(np.float32)
    x[:, :16, 0] = np.arange(16) / 16  # exact thresholds must fire
    masks = rng.uniform(size=(P, C, 16)) < 0.5
    masks[0] = True
    masks[1, 2, 1:] = False
    w = rng.normal(size=(P, C, F)).astype(np.float32)
    b = rng.normal(size=(P, F)).astype(np.float32)
    thr, ids = make_tables(torch.from_numpy(masks), N_BITS)
    out = fq.fused_forward(torch.from_numpy(x), thr, ids, torch.from_numpy(w),
                           torch.from_numpy(b), SCALE).numpy()
    for p in range(P):
        jthr, jids = jpq.make_tables(jnp.asarray(masks[p]), N_BITS)
        want = jfq.fused_qat_forward_pallas(
            jnp.asarray(x[p]), jthr, jids, jnp.asarray(w[p]), jnp.asarray(b[p]),
            scale=SCALE, block_b=64, interpret=True)
        np.testing.assert_allclose(out[p], np.asarray(want), **K2_TOL)
