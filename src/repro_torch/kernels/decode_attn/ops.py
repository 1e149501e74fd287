"""Flash-decode GQA attention: the K5 wrapper.

``decode_attention(q, k_cache, v_cache, kv_len=None)`` has the signature
and layout of the JAX package's ``kernels/decode_attn/ops.decode_attention``:
q (B, Hq, d) one token per row, caches (B, S, Hkv, d) in the model's
layout, kv_len (B,) int32 or None for the full cache; returns (B, Hq, d) in
q's dtype.  A row with ``kv_len <= 0`` attends to nothing and is NaN, as
the reference's plain version gives it; the other rows are computed as
usual.  Nothing of kv_len is read on the host.

Kernel: ``csrc/decode_attn.cu`` (CUDA C++ for ``sm_90a``; the note at the
top of that file says what it replaces, what bounds it and how the design
answers): one launch a call, a block per ``split_plan(B, Hkv, S)`` chunk of
the cache, KV head and batch row, the last block of each (batch row, KV
head) merging the chunks' partials.  It is one of two kernels, picked by
dtype (``variant``): bf16 scores on the tensor cores, for G <= 8 query
heads a KV head and d a multiple of 16; fp32 on the CUDA cores.  Device
rule: a tensor on the CPU takes the plain PyTorch version in ``ref``; a
tensor on CUDA launches the kernel or raises.  There is no fallback
between the two.  ``LAUNCHES`` counts calls that launched.  The kernel has
no backward: a CUDA call that autograd would record raises
(``kernels.refuse_autograd``).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build, refuse_autograd
from repro_torch.kernels.decode_attn import ref

__all__ = ["LAUNCHES", "reset_launch_counts", "build", "split_plan", "variant",
           "decode_attention"]

SOURCES = [Path(__file__).resolve().parent / "csrc" / "decode_attn.cu"]
MAX_SHARED_BYTES = 232448  # 227 KB, the most one Hopper block may opt into
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMS = 132         # an H100 SXM's streaming multiprocessors
SPLIT_TILE = 64   # a chunk is a whole number of these positions
MAX_HEAD_DIM = 256
MMA_MAX_GROUP = 8  # query heads a KV head the bf16 kernel's n8 fragment holds

LAUNCHES = {"decode_attention": 0}

_vp, _int, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_library("decode_attn", SOURCES)
    lib.decode_attn.argtypes = (
        [_vp] * 7 + [_int] * 7 + [_i64] * 6 + [ctypes.c_float, _int, _vp]
    )
    lib.decode_attn.restype = _int
    lib.decode_attn_shared_bytes.argtypes = [_int, _int, _int]
    lib.decode_attn_shared_bytes.restype = ctypes.c_size_t
    lib.decode_attn_error_string.argtypes = [_int]
    lib.decode_attn_error_string.restype = ctypes.c_char_p
    return lib


def build() -> Path:
    """Build (or find) the kernel's shared library; returns its path."""
    return Path(_lib()._name)


# (device index, stream) -> (workspace, counters), kept between calls
_SCRATCH: dict[tuple[int, int], tuple[torch.Tensor, torch.Tensor]] = {}


def _scratch(device: torch.device, stream: int, n_floats: int, n_counts: int):
    """The partials' workspace and the per-(batch row, KV head) counters of
    the calls on one stream, kept between calls and grown when a call needs
    more.  Each call's last block of a group resets its counter, so the
    counters are zero when the next call on the stream starts."""
    ws, cnt = _SCRATCH.get((device.index, stream), (None, None))
    if ws is None or ws.numel() < n_floats:
        ws = torch.empty(n_floats, dtype=torch.float32, device=device)
    if cnt is None or cnt.numel() < n_counts:
        cnt = torch.zeros(n_counts, dtype=torch.int32, device=device)
    _SCRATCH[(device.index, stream)] = ws, cnt
    return ws, cnt


def split_plan(B: int, Hkv: int, S: int) -> tuple[int, int]:
    """(n_split, chunk) for the split pass, from the shapes alone: about two
    blocks an SM over the (split, KV head, batch row) grid, a chunk a whole
    number of SPLIT_TILE positions, and n_split * chunk covering S with no
    split wholly past S.  kv_len is never read, so a launch needs no host
    round trip."""
    tiles = -(-S // SPLIT_TILE)
    n = max(1, min(tiles, -(-2 * SMS // (B * Hkv))))
    chunk = -(-tiles // n) * SPLIT_TILE
    return -(-S // chunk), chunk


def variant(dtype: torch.dtype, G: int, d: int) -> str:
    """The split kernel a CUDA call of this dtype, group size and head dim
    launches: "tc" (bf16, scores on the tensor cores) or "fp32"."""
    if dtype == torch.float32:
        return "fp32"
    if dtype == torch.bfloat16:
        if G > MMA_MAX_GROUP or d % 16:
            raise ValueError(
                f"the bf16 kernel takes G <= {MMA_MAX_GROUP} and d a multiple of 16, "
                f"not G={G}, d={d}")
        return "tc"
    raise TypeError(f"no kernel for {dtype}")


def _check(q, k_cache, v_cache, kv_len) -> tuple[int, ...]:
    """Validate the inputs (shapes, dtypes, devices: nothing is read from the
    device); returns (B, S, Hkv, G, d)."""
    if q.ndim != 3 or k_cache.ndim != 4:
        raise ValueError("q must be (B, Hq, d) and the caches (B, S, Hkv, d)")
    B, Hq, d = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    if tuple(k_cache.shape) != (B, S, Hkv, d) or tuple(v_cache.shape) != (B, S, Hkv, d):
        raise ValueError(
            f"caches {tuple(k_cache.shape)}, {tuple(v_cache.shape)} do not fit q {tuple(q.shape)}"
        )
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"{Hq} query heads are not a multiple of {Hkv} KV heads")
    if kv_len is not None and (tuple(kv_len.shape) != (B,) or kv_len.dtype != torch.int32):
        raise ValueError(f"kv_len must be ({B},) int32, got {tuple(kv_len.shape)} {kv_len.dtype}")
    if q.dtype not in DTYPES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(
            f"q/k/v must share one of {list(DTYPES)}: {q.dtype}, {k_cache.dtype}, {v_cache.dtype}"
        )
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache), ("kv_len", kv_len)):
        if t is not None and t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    return B, S, Hkv, Hq // Hkv, d


def decode_attention(q, k_cache, v_cache, kv_len=None) -> torch.Tensor:
    """One-token GQA attention against a ragged KV cache; K5 on CUDA.
    ``kv_len=None`` is the full cache, as in the reference."""
    B, S, Hkv, G, d = _check(q, k_cache, v_cache, kv_len)
    if kv_len is None:  # filled on q's device: no host round trip
        kv_len = torch.full((B,), S, dtype=torch.int32, device=q.device)
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k_cache, v_cache, kv_len)
    refuse_autograd("K5 (decode_attn.ops.decode_attention)",
                    "models.layers.decode_attention_plain", q, k_cache, v_cache)
    if not q.is_contiguous() or k_cache.stride(3) != 1 or v_cache.stride(3) != 1:
        raise ValueError("the kernel takes a contiguous q and caches with unit stride in d")
    if B < 1 or S < 1 or B > 65535 or Hkv > 65535:
        raise ValueError(f"launch out of range: B={B} S={S} Hkv={Hkv}")
    variant(q.dtype, G, d)
    vec = 16 // q.element_size()  # elements in the kernel's 16-byte loads
    if d % vec or d > MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes d a multiple of {vec} up to {MAX_HEAD_DIM}, not {d}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.data_ptr() % 16 or any(st % vec for st in t.stride()[:3]):
            raise ValueError(f"{name} must be 16-byte aligned with strides in 16-byte steps")
    lib = _lib()
    need = lib.decode_attn_shared_bytes(G, d, DTYPES[q.dtype])
    if need > MAX_SHARED_BYTES:
        raise ValueError(f"G={G}, d={d} need {need} bytes of shared memory a block")
    n_split, chunk = split_plan(B, Hkv, S)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ws, cnt = _scratch(q.device, stream, B * Hkv * G * n_split * (d + 2), B * Hkv)
        err = lib.decode_attn(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), kv_len.data_ptr(),
            out.data_ptr(), ws.data_ptr(), cnt.data_ptr(), B, S, Hkv, G, d, chunk, n_split,
            *k_cache.stride()[:3], *v_cache.stride()[:3], 1.0 / d ** 0.5, DTYPES[q.dtype],
            stream,
        )
    if err != 0:
        raise RuntimeError(f"decode_attn launch failed: {lib.decode_attn_error_string(err).decode()}")
    LAUNCHES["decode_attention"] += 1
    return out
