"""The Hopper designs of K4 and K5, reached on the CPU through their emulations.

The bf16 K4 kernel (``kernels/flash_attn/csrc/flash_attn_tc.cu``) runs its
products on the tensor cores and rounds P to bf16 before P.V; the K5 kernel
(``kernels/decode_attn/csrc/decode_attn.cu``) splits the cache into chunks
and merges the partials.  Neither runs here, so each kernel's ``ref.py``
carries a CPU emulation of its numerics, held here against the JAX
package's Pallas kernels in interpret mode (as ``tests/test_kernels_*``
run them) and against the fp32 plain versions.  Inputs come from a seed
with numpy.

Tolerances:
* K4 emulation vs Pallas, bf16 inputs, both at the kernel's key tile for
  the head dim: 3e-2, the bf16 gate of the card's kernel-vs-plain check.
  Measured (CPU): at most 0.015625, one bf16 ulp of outputs in [2, 4),
  because both round the output to bf16.
* K4 emulation vs the fp32 plain version on bf16-valued fp32 inputs, which
  isolates P's rounding to bf16: 3e-2; measured at most 0.0035 over the
  sweep.  With P kept in fp32 the emulation is the plain version's
  algorithm blocked, held at the fp32 bound 3e-5 (measured 7.2e-7).
* K5 emulation vs Pallas in fp32: 3e-5, the reference's own bound.
"""

import inspect
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.decode_attn import ops as jda  # noqa: E402
from repro.kernels.flash_attn import ops as jfa  # noqa: E402
from repro_torch.kernels.decode_attn import ops as da  # noqa: E402
from repro_torch.kernels.decode_attn import ref as dref  # noqa: E402
from repro_torch.kernels.flash_attn import ops as fa  # noqa: E402
from repro_torch.kernels.flash_attn import ref as fref  # noqa: E402

FP32 = dict(atol=3e-5, rtol=3e-5)
BF16 = dict(atol=3e-2, rtol=3e-2)
HEAD_DIMS = (32, 64, 80, 128, 160, 256)
# (causal, Sq, Sk): square and ragged causal, and non-causal with Sq != Sk; the
# last two put a ragged Sq of 130 over the kernel's 128-key tile
FLASH_CASES = [(True, 100, 100), (False, 70, 150), (True, 130, 130), (False, 130, 257)]


def _bf16(rng, shape):
    return rng.normal(size=shape).astype(ml_dtypes.bfloat16)


def _t(a):
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# K4: the tensor-core kernel's numerics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("causal,Sq,Sk", FLASH_CASES)
def test_tc_emulation_matches_pallas(d, causal, Sq, Sk):
    """At the kernel's key tile for the head dim, on both sides."""
    tile = fref.tc_key_tile(d)
    rng = np.random.default_rng(d + Sq)
    q, k, v = _bf16(rng, (1, Sq, 4, d)), _bf16(rng, (1, Sk, 2, d)), _bf16(rng, (1, Sk, 2, d))
    want = np.asarray(
        jfa.flash_attention_tpu(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=causal, block_q=64, block_k=tile),
        np.float32,
    )
    got = fref.flash_attention_tc_emulation(_t(q), _t(k), _t(v), causal, block_k=tile)
    assert got.dtype == torch.bfloat16 and got.shape == (1, Sq, 4, d)
    np.testing.assert_allclose(got.float().numpy(), want, **BF16)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("causal,Sq,Sk", FLASH_CASES)
def test_tc_emulation_p_in_bf16_error_against_fp32_plain(d, causal, Sq, Sk):
    """P rounded to bf16 is the one new approximation: sized against the
    fp32 plain version on the same (bf16-valued) inputs; with P in fp32 the
    blocked emulation is the plain version to the fp32 bound."""
    rng = np.random.default_rng(d + Sq)
    q, k, v = (_t(_bf16(rng, s)).float() for s in ((1, Sq, 4, d), (1, Sk, 2, d), (1, Sk, 2, d)))
    plain = fref.flash_attention_ref(q, k, v, causal)
    p_bf16 = fref.flash_attention_tc_emulation(q, k, v, causal)  # at the kernel's tile
    p_fp32 = fref.flash_attention_tc_emulation(q, k, v, causal, p_dtype=torch.float32)
    torch.testing.assert_close(p_bf16, plain, **BF16)
    torch.testing.assert_close(p_fp32, plain, **FP32)
    assert float((p_bf16 - plain).abs().max()) > float((p_fp32 - plain).abs().max())


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_tc_emulation_defaults_to_the_kernels_tile(d):
    """128 keys a tile up to d 128 (a second 64-register S fits beside O),
    64 at d 160 and 256; the default is that tile, bit for bit."""
    assert fref.tc_key_tile(d) == (128 if d <= 128 else 64)
    rng = np.random.default_rng(d)
    q, k, v = (_t(_bf16(rng, s)) for s in ((1, 200, 4, d), (1, 200, 2, d), (1, 200, 2, d)))
    tiled = fref.flash_attention_tc_emulation(q, k, v, True, block_k=fref.tc_key_tile(d))
    assert torch.equal(fref.flash_attention_tc_emulation(q, k, v, True), tiled)


@pytest.mark.parametrize("block_k", [32, 64, 128])
def test_tc_emulation_is_independent_of_the_key_tile(block_k):
    """The causal skip and the tile size change no value beyond rounding."""
    rng = np.random.default_rng(5)
    q, k, v = (_t(_bf16(rng, s)).float() for s in ((2, 96, 8, 64), (2, 96, 2, 64), (2, 96, 2, 64)))
    got = fref.flash_attention_tc_emulation(q, k, v, True, block_k=block_k,
                                            p_dtype=torch.float32)
    torch.testing.assert_close(got, fref.flash_attention_ref(q, k, v, True), **FP32)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_k4_bf16_takes_the_tensor_core_kernel(d):
    assert fa.variant(torch.bfloat16, d) == "tc"
    assert fa.variant(torch.float32, d) == "fp32"


@pytest.mark.parametrize("d", [16, 48, 96, 112, 192, 320])
def test_k4_bf16_raises_at_other_head_dims(d):
    with pytest.raises(ValueError, match="head dim"):
        fa.variant(torch.bfloat16, d)
    assert fa.variant(torch.float32, d) == "fp32"  # the CUDA-core kernel takes any d <= 256


def test_k4_variant_rejects_other_dtypes_and_cpu_keeps_the_plain_path():
    with pytest.raises(TypeError):
        fa.variant(torch.float16, 64)
    # the dispatch is for CUDA tensors; on the CPU every head dim takes ref
    q = torch.randn(1, 8, 2, 96).bfloat16()
    out = fa.flash_attention(q, q, q)
    torch.testing.assert_close(out, fref.flash_attention_ref(q, q, q), rtol=0, atol=0)


def test_ptxas_report_flags_serialized_wgmma(tmp_path):
    """K4's overlap needs ptxas to keep its wgmma asynchronous: the report
    marks a kernel whose wgmma ptxas serialized (``chip_smoke.build_all``
    fails on one), and its registers and spills as before."""
    from repro_torch.kernels import _build

    so = tmp_path / "lib.so"
    so.with_suffix(".ptxas.txt").write_text(
        "ptxas info    : Compiling entry function '_Z1av' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z1av\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async instructions are "
        "serialized due to insufficient register resources for the wgmma pipeline in the "
        "function '_Z1av'\n"
        "ptxas info    : Used 168 registers, used 1 barriers, 384 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_Z1bv' for 'sm_90a'\n"
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 40 registers, 16 bytes smem, 384 bytes cmem[0]\n")
    a, b = _build.ptxas_report(so)
    assert a == {"kernel": "_Z1av", "registers": 168, "static_smem": 0, "spill_stores": 0,
                 "spill_loads": 0, "wgmma_serialized": True}
    assert b == {"kernel": "_Z1bv", "registers": 40, "static_smem": 16, "spill_stores": 8,
                 "spill_loads": 4, "wgmma_serialized": False}


def test_k4_counters_name_both_variants():
    assert set(fa.LAUNCHES) == {"flash_attention", "flash_attention_tc", "flash_attention_fp32",
                                "flash_attention_window", "flash_attention_dv"}
    fa.LAUNCHES["flash_attention_tc"] = 3
    fa.reset_launch_counts()
    assert set(fa.LAUNCHES.values()) == {0}


# ---------------------------------------------------------------------------
# K5: split across the cache, then merged
# ---------------------------------------------------------------------------

def _decode_case(B, Hq, Hkv, S, d, kv_len, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Hq, d)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, d)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, d)).astype(np.float32)
    kvl = np.asarray(kv_len, np.int32)
    want = np.asarray(
        jda.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kvl)),
        np.float32,
    )
    return [torch.from_numpy(a) for a in (q, k, v, kvl)], want


# kv_len = 1 and = S, a chunk that does not divide S, splits wholly past kv_len
@pytest.mark.parametrize(
    "n_split,chunk",
    [(1, 320), (2, 192), (3, 128), (5, 64), (8, 40)],
)
def test_split_emulation_matches_pallas(n_split, chunk):
    S = 300
    assert n_split * chunk >= S
    (q, k, v, kvl), want = _decode_case(4, 8, 2, S, 64, [1, S, 70, 129])
    got = dref.decode_attention_split_emulation(q, k, v, kvl, n_split, chunk)
    np.testing.assert_allclose(got.numpy(), want, **FP32)


@pytest.mark.parametrize("B,Hq,Hkv,S,d", [(4, 32, 4, 1024, 128), (2, 16, 16, 500, 64),
                                          (1, 24, 4, 777, 80)])
def test_split_emulation_with_the_planned_split(B, Hq, Hkv, S, d):
    rng = np.random.default_rng(S)
    kv_len = np.concatenate([[S], rng.integers(1, S + 1, size=B - 1)])
    (q, k, v, kvl), want = _decode_case(B, Hq, Hkv, S, d, kv_len, seed=S)
    n_split, chunk = da.split_plan(B, Hkv, S)
    got = dref.decode_attention_split_emulation(q, k, v, kvl, n_split, chunk)
    np.testing.assert_allclose(got.numpy(), want, **FP32)


@pytest.mark.parametrize(
    "B,Hkv,S",
    [(1, 1, 1), (4, 4, 4096), (4, 8, 512), (4, 16, 448), (4, 16, 1500), (64, 8, 4096),
     (1, 1, 100_000), (2, 8, 513), (3, 5, 63), (128, 8, 32768)],
)
def test_split_plan_covers_the_cache_exactly(B, Hkv, S):
    n_split, chunk = da.split_plan(B, Hkv, S)
    assert n_split >= 1 and chunk % da.SPLIT_TILE == 0
    assert (n_split - 1) * chunk < S <= n_split * chunk  # covers S, no split wholly past it
    assert n_split <= 2 * da.SMS  # the merge pass holds at most 512 weights
    # about two blocks an SM where the cache has the tiles for it
    tiles = -(-S // da.SPLIT_TILE)
    if B * Hkv < 2 * da.SMS and tiles >= 2 * 2 * da.SMS:
        assert da.SMS <= n_split * B * Hkv <= 4 * da.SMS


def test_split_plan_reads_nothing_but_shapes():
    assert list(inspect.signature(da.split_plan).parameters) == ["B", "Hkv", "S"]
    assert da.split_plan(4, 4, 4096) == da.split_plan(4, 4, 4096) == (16, 256)
    # yi-9b's decode shape: 256 blocks on 132 SMs, where one a (b, KV head) gave 16
    n_split, _ = da.split_plan(4, 4, 4096)
    assert n_split * 4 * 4 == 256


# (G, d) of the served models and of the card's edge sweep
@pytest.mark.parametrize("G,d", [(8, 128), (6, 128), (1, 64), (4, 160), (1, 80), (4, 64),
                                 (7, 128), (2, 64)])
def test_k5_bf16_takes_the_tensor_core_kernel(G, d):
    assert da.variant(torch.bfloat16, G, d) == "tc"
    assert da.variant(torch.float32, G, d) == "fp32"


@pytest.mark.parametrize("G,d", [(16, 128), (9, 64), (4, 72), (1, 40), (12, 88)])
def test_k5_bf16_raises_beyond_the_tensor_core_kernel(G, d):
    with pytest.raises(ValueError, match="bf16 kernel"):
        da.variant(torch.bfloat16, G, d)
    assert da.variant(torch.float32, G, d) == "fp32"  # the fp32 kernel takes any G
    with pytest.raises(TypeError):
        da.variant(torch.float16, G, d)


def test_k5_cpu_keeps_the_plain_path_beyond_the_tensor_core_kernel():
    """The dispatch is for CUDA tensors: on the CPU a bf16 shape the kernel
    does not take still runs the plain version."""
    q = torch.randn(2, 32, 72).bfloat16()
    k, v = torch.randn(2, 40, 2, 72).bfloat16(), torch.randn(2, 40, 2, 72).bfloat16()
    kv_len = torch.tensor([40, 7], dtype=torch.int32)
    out = da.decode_attention(q, k, v, kv_len)
    torch.testing.assert_close(out, dref.decode_attention_ref(q, k, v, kv_len), rtol=0, atol=0)


def test_k5_scratch_is_kept_per_stream_and_grown():
    """The workspace and the counters of one stream are reused between calls
    (the kernel's last blocks leave the counters at zero) and replaced by
    larger ones, counters zeroed, when a call needs more."""
    dev = torch.device("cpu")
    ws, cnt = da._scratch(dev, 12345, 100, 16)
    assert ws.dtype == torch.float32 and ws.numel() == 100
    assert cnt.dtype == torch.int32 and cnt.numel() == 16 and not cnt.any()
    again = da._scratch(dev, 12345, 80, 8)
    assert again[0] is ws and again[1] is cnt
    ws2, cnt2 = da._scratch(dev, 12345, 200, 32)
    assert ws2.numel() == 200 and cnt2.numel() == 32 and not cnt2.any()
    other = da._scratch(dev, 54321, 10, 1)  # another stream has its own
    assert other[0] is not ws2 and other[1] is not cnt2
    for key in ((None, 12345), (None, 54321)):
        da._SCRATCH.pop(key)


def test_emulations_stay_off_the_main_path():
    """Only the tests call the emulations: no module of the port names them
    outside the ref.py that defines each."""
    root = Path(da.__file__).resolve().parents[2]
    for name, home in (("flash_attention_tc_emulation", "flash_attn/ref.py"),
                       ("decode_attention_split_emulation", "decode_attn/ref.py")):
        users = [p for p in root.rglob("*.py") if name in p.read_text()]
        assert [p.relative_to(root / "kernels").as_posix() for p in users] == [home]
