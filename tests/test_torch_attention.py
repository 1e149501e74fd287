"""The port's attention against the reference: K4, K5 and the model layers.

On the CPU the port's K4 (``kernels/flash_attn``) and K5
(``kernels/decode_attn``) wrappers run their plain PyTorch versions; the
reference's Pallas kernels run in interpret mode, exactly as
``tests/test_kernels_flash_attn.py`` and ``tests/test_kernels_decode_attn.py``
run them, on the same shape sweeps (GQA, ragged block edges, head dims 80
and 160, non-causal, ragged kv_len).  Inputs come from a seed with numpy.

Tolerances:
* attention outputs: atol = rtol = 3e-5 in fp32 and 3e-2 in bf16, the
  reference's own kernel-vs-oracle bounds (fp32 sums in another order; in
  bf16 the output is rounded to bf16, one ulp of which is 2^-8 relative);
* the elementwise layers (``rms_norm``, ``apply_rope``, ``swiglu``):
  atol = rtol = 1e-6.  XLA and PyTorch round rsqrt, cos/sin and the matmul
  sums differently; the measured gap is one fp32 ulp of the value at most
  (9.5e-7 on values up to 11).
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.decode_attn import ops as jda  # noqa: E402
from repro.kernels.flash_attn import ops as jfa  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels.decode_attn import ops as da  # noqa: E402
from repro_torch.kernels.flash_attn import ops as fa  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

FP32 = dict(atol=3e-5, rtol=3e-5)
BF16 = dict(atol=3e-2, rtol=3e-2)
ELEMENTWISE = dict(atol=1e-6, rtol=1e-6)


def _t(a):
    """numpy (fp32 or bf16) -> torch on the CPU, same values and dtype."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return t.to(torch.float32).numpy()


# ---------------------------------------------------------------------------
# K4: flash attention (model layout) vs the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------

def _flash(B, Sq, Sk, Hq, Hkv, d, causal=True, dtype=np.float32, bq=64, bk=64, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Sq, Hq, d)).astype(dtype)
    k = rng.normal(size=(B, Sk, Hkv, d)).astype(dtype)
    v = rng.normal(size=(B, Sk, Hkv, d)).astype(dtype)
    want = np.asarray(
        jfa.flash_attention_tpu(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=causal, block_q=bq, block_k=bk),
        np.float32,
    )
    got = fa.flash_attention(_t(q), _t(k), _t(v), causal=causal)
    assert got.shape == (B, Sq, Hq, d) and got.dtype == _t(q).dtype
    return _np(got), want


@pytest.mark.parametrize(
    "B,Sq,Sk,Hq,Hkv,d,causal",
    [
        (1, 128, 128, 4, 4, 64, True),    # MHA causal
        (2, 96, 96, 8, 2, 32, True),      # GQA, ragged block boundary
        (1, 64, 192, 4, 4, 64, False),    # cross-attention shape
        (2, 256, 256, 6, 2, 128, True),   # internvl2-like head ratio
        (1, 80, 80, 4, 4, 80, True),      # odd head_dim (zamba2-like)
    ],
)
def test_flash_matches_pallas(B, Sq, Sk, Hq, Hkv, d, causal):
    got, want = _flash(B, Sq, Sk, Hq, Hkv, d, causal)
    np.testing.assert_allclose(got, want, **FP32)


@pytest.mark.parametrize("bq,bk", [(32, 32), (64, 128), (128, 64)])
def test_flash_matches_pallas_at_every_block_size(bq, bk):
    got, want = _flash(1, 160, 160, 4, 2, 32, bq=bq, bk=bk)
    np.testing.assert_allclose(got, want, **FP32)


def test_flash_bfloat16():
    got, want = _flash(1, 128, 128, 4, 4, 64, dtype=ml_dtypes.bfloat16)
    np.testing.assert_allclose(got, want, **BF16)


# ---------------------------------------------------------------------------
# K5: flash-decode vs the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------

def _decode(B, Hq, Hkv, S, d, block_s=256, dtype=np.float32, seed=0, ragged=True):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Hq, d)).astype(dtype)
    k = rng.normal(size=(B, S, Hkv, d)).astype(dtype)
    v = rng.normal(size=(B, S, Hkv, d)).astype(dtype)
    kvl = (rng.integers(1, S + 1, size=(B,)) if ragged else np.full((B,), S)).astype(np.int32)
    want = np.asarray(
        jda.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kvl),
                             block_s=block_s),
        np.float32,
    )
    got = da.decode_attention(_t(q), _t(k), _t(v), torch.from_numpy(kvl))
    assert got.shape == (B, Hq, d) and got.dtype == _t(q).dtype
    return _np(got), want


@pytest.mark.parametrize(
    "B,Hq,Hkv,S,d",
    [
        (1, 8, 8, 128, 64),     # MHA
        (2, 8, 2, 513, 64),     # GQA, ragged block boundary
        (2, 64, 8, 1024, 128),  # command-r-like head config
        (1, 32, 8, 777, 160),   # mistral-nemo-like head dim
        (3, 16, 16, 96, 80),    # zamba2-like
    ],
)
def test_decode_matches_pallas(B, Hq, Hkv, S, d):
    got, want = _decode(B, Hq, Hkv, S, d)
    np.testing.assert_allclose(got, want, **FP32)


@pytest.mark.parametrize("block_s", [64, 128, 512])
def test_decode_matches_pallas_at_every_block_size(block_s):
    got, want = _decode(2, 8, 4, 600, 64, block_s=block_s)
    np.testing.assert_allclose(got, want, **FP32)


def test_decode_bfloat16():
    got, want = _decode(2, 8, 4, 256, 64, dtype=ml_dtypes.bfloat16)
    np.testing.assert_allclose(got, want, **BF16)


def test_decode_full_cache():
    got, want = _decode(2, 8, 4, 512, 64, ragged=False)
    np.testing.assert_allclose(got, want, **FP32)


def test_decode_kv_len_one_attends_only_first():
    """kv_len = 1 returns v[:, 0] of each query head's KV head, exactly."""
    rng = np.random.default_rng(1)
    B, Hq, Hkv, S, d = 2, 4, 2, 300, 64
    q = torch.from_numpy(rng.normal(size=(B, Hq, d)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(B, S, Hkv, d)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(B, S, Hkv, d)).astype(np.float32))
    out = da.decode_attention(q, k, v, torch.ones(B, dtype=torch.int32))
    torch.testing.assert_close(out, v[:, 0].repeat_interleave(Hq // Hkv, dim=1), rtol=0, atol=0)


def test_decode_wrapper_rejects_empty_caches_and_bad_inputs():
    """An empty cache row is not rejected: it gives NaN, as the reference's
    plain version does, and the other row is computed.  Bad inputs raise."""
    q = torch.zeros(2, 4, 16)
    k = torch.zeros(2, 8, 2, 16)
    out = da.decode_attention(q, k, k, torch.tensor([3, 0], dtype=torch.int32))
    assert bool(out[1].isnan().all()) and bool(out[0].isfinite().all())
    with pytest.raises(ValueError, match="int32"):
        da.decode_attention(q, k, k, torch.tensor([3, 1]))
    with pytest.raises(TypeError):
        da.decode_attention(q.double(), k.double(), k.double(), torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="multiple"):
        da.decode_attention(torch.zeros(2, 3, 16), k, k, torch.ones(2, dtype=torch.int32))


def test_wrappers_never_take_the_plain_path_off_the_cpu():
    """A tensor that is not on the CPU launches the kernel or raises: here a
    tensor on another device, or on two devices at once, raises."""
    meta = dict(device="meta")
    q, k = torch.empty(2, 4, 16, **meta), torch.empty(2, 8, 2, 16, **meta)
    with pytest.raises(ValueError, match="unsupported device"):
        da.decode_attention(q, k, k, torch.ones(2, dtype=torch.int32, **meta))
    with pytest.raises(ValueError, match="is on"):
        da.decode_attention(q, k, k, torch.ones(2, dtype=torch.int32))
    q4, k4 = torch.empty(1, 8, 4, 16, **meta), torch.empty(1, 8, 2, 16, **meta)
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention(q4, k4, k4)
    with pytest.raises(ValueError, match="is on"):
        fa.flash_attention(torch.zeros(1, 8, 4, 16), k4, k4)


# ---------------------------------------------------------------------------
# the model layers vs repro.models.layers (fp32)
# ---------------------------------------------------------------------------

def _qkv(seed, B=2, S=96, Hq=8, Hkv=2, d=32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, Hq, d)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, d)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, d)).astype(np.float32))


def test_rms_norm_rope_and_swiglu_match_reference():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 12, 4, 32)).astype(np.float32) * 3
    scale = rng.normal(size=(32,)).astype(np.float32)
    np.testing.assert_allclose(
        _np(L.rms_norm(_t(x), _t(scale))), np.asarray(JL.rms_norm(x, scale)), **ELEMENTWISE)
    pos = rng.integers(0, 4096, (2, 12)).astype(np.int32)
    for theta in (1e4, 1e6):
        np.testing.assert_allclose(
            _np(L.apply_rope(_t(x), torch.from_numpy(pos), theta)),
            np.asarray(JL.apply_rope(x, pos, theta)), **ELEMENTWISE)
    h = rng.normal(size=(2, 5, 64)).astype(np.float32)
    wg, wu = (rng.normal(size=(64, 128)).astype(np.float32) / 8 for _ in range(2))
    wd = rng.normal(size=(128, 64)).astype(np.float32) / 11
    np.testing.assert_allclose(
        _np(L.swiglu(_t(h), _t(wg), _t(wu), _t(wd))), np.asarray(JL.swiglu(h, wg, wu, wd)),
        **ELEMENTWISE)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_and_blocked_attention_match_reference(causal):
    q, k, v = _qkv(6)
    want = np.asarray(JL.plain_attention(q, k, v, causal=causal))
    np.testing.assert_allclose(
        _np(L.plain_attention(_t(q), _t(k), _t(v), causal=causal)), want, **FP32)
    for block_k in (32, 40):  # 40: a ragged last block
        got = L.flash_attention(_t(q), _t(k), _t(v), causal=causal, block_k=block_k)
        jax_blocked = JL.flash_attention(q, k, v, causal=causal, block_k=block_k)
        np.testing.assert_allclose(_np(got), np.asarray(jax_blocked), **FP32)
        np.testing.assert_allclose(_np(got), want, **FP32)


def test_decode_attention_plain_matches_reference():
    rng = np.random.default_rng(8)
    B, Hq, Hkv, S, d = 3, 8, 2, 40, 32
    q = rng.normal(size=(B, Hq, d)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, d)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, d)).astype(np.float32)
    kvl = np.array([1, 17, 40], np.int32)
    want = np.asarray(JL.decode_attention_jnp(q, k, v, kvl))
    got = L.decode_attention_plain(_t(q), _t(k), _t(v), torch.from_numpy(kvl))
    np.testing.assert_allclose(_np(got), want, **FP32)
    # the model's plain twin and K5's plain version agree
    np.testing.assert_allclose(
        _np(da.decode_attention(_t(q), _t(k), _t(v), torch.from_numpy(kvl))), want, **FP32)
