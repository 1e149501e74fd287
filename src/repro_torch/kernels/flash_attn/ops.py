"""Flash-attention forward for prefill: the K4 wrapper.

``flash_attention(q, k, v, causal=True)`` takes the model layout of the JAX
package's ``kernels/flash_attn/ops.flash_attention_tpu``: q (B, Sq, Hq, d),
k/v (B, Sk, Hkv, d) with Hq a multiple of Hkv (GQA); returns
(B, Sq, Hq, d) in q's dtype.  ``scale`` is the scores' (None: d^-1/2).
Latent attention's heads give v a narrower dv than q and k's d: v
(B, Sk, Hkv, dv), out (B, Sq, Hq, dv), in bf16 at the pairs of
``TC_DV_PAIRS`` only (DeepSeek-V3's d 192, dv 128), without a window.

Two kernels, CUDA C++ for ``sm_90a``, picked by dtype (``variant``), never
one after the other: bf16 takes ``csrc/flash_attn_tc.cu`` (wgmma on the
tensor cores, TMA-fed K/V; head dims in ``TC_HEAD_DIMS``, others raise),
fp32 takes ``csrc/flash_attn.cu`` (the CUDA cores: the tensor cores cannot
hold fp32 attention to 3e-5).  The note at the top of each file says what
it replaces, what bounds it and how the design answers.  Device rule: a
tensor on the CPU takes the plain PyTorch version in ``ref``; a tensor on
CUDA launches a kernel or raises.  There is no fallback between them.
``LAUNCHES`` counts launches: ``flash_attention`` every call, and
``flash_attention_tc`` / ``flash_attention_fp32`` the variant that ran;
``flash_attention_window`` the calls with a sliding window, which only the
bf16 kernel takes (``flash_attn_tc_window_kernel``, a name of its own in a
device trace; the fp32 kernel raises on one); ``flash_attention_dv`` the
calls with dv != d (``flash_attn_tc_dv_kernel``, also a name of its own).
The kernels have no backward: a CUDA call that autograd would record
raises (``kernels.refuse_autograd``); training takes the plain versions of
``models/layers``, as the reference does.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build, refuse_autograd
from repro_torch.kernels.flash_attn import ref

__all__ = ["LAUNCHES", "TC_HEAD_DIMS", "reset_launch_counts", "build", "build_tc", "variant",
           "flash_attention"]

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = [CSRC / "flash_attn.cu"]
TC_SOURCES = [CSRC / "flash_attn_tc.cu"]
MAX_SHARED_BYTES = 232448  # 227 KB, the most one Hopper block may opt into
DTYPES = (torch.float32, torch.bfloat16)
TC_HEAD_DIMS = (32, 64, 80, 128, 160, 256)  # the tensor-core kernel's instantiations
TC_DV_PAIRS = ((192, 128),)  # its (d, dv) instantiations with a narrower v

LAUNCHES = {"flash_attention": 0, "flash_attention_tc": 0, "flash_attention_fp32": 0,
            "flash_attention_window": 0, "flash_attention_dv": 0}

_vp, _int = ctypes.c_void_p, ctypes.c_int


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_library("flash_attn", SOURCES)
    lib.flash_attn.argtypes = [_vp] * 4 + [_int] * 7 + [ctypes.c_float, _vp]
    lib.flash_attn.restype = _int
    lib.flash_attn_shared_bytes.argtypes = [_int]
    lib.flash_attn_shared_bytes.restype = ctypes.c_size_t
    lib.flash_attn_max_head_dim.argtypes = []
    lib.flash_attn_max_head_dim.restype = _int
    lib.flash_attn_error_string.argtypes = [_int]
    lib.flash_attn_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _lib_tc() -> ctypes.CDLL:
    lib = _build.load_library("flash_attn_tc", TC_SOURCES)
    lib.flash_attn_tc.argtypes = [_vp] * 4 + [_int] * 9 + [ctypes.c_float, _vp]
    lib.flash_attn_tc.restype = _int
    lib.flash_attn_tc_shared_bytes.argtypes = [_int, _int]
    lib.flash_attn_tc_shared_bytes.restype = ctypes.c_size_t
    lib.flash_attn_tc_error_string.argtypes = [_int]
    lib.flash_attn_tc_error_string.restype = ctypes.c_char_p
    return lib


def build() -> Path:
    """Build (or find) the fp32 kernel's shared library; returns its path."""
    return Path(_lib()._name)


def build_tc() -> Path:
    """Build (or find) the bf16 tensor-core kernel's shared library; returns its path."""
    return Path(_lib_tc()._name)


def variant(dtype: torch.dtype, d: int, dv: int | None = None) -> str:
    """The kernel a CUDA call of this dtype and head dims (v's ``dv``, None:
    d) launches: "tc" or "fp32"."""
    dv = d if dv is None else dv
    if dv != d and (dtype != torch.bfloat16 or (d, dv) not in TC_DV_PAIRS):
        raise ValueError(f"{dtype} head dims {d}/{dv}: a narrower v runs in bf16 at "
                         f"{TC_DV_PAIRS} only")
    if dtype == torch.float32:
        return "fp32"
    if dtype == torch.bfloat16:
        if d not in TC_HEAD_DIMS and dv == d:
            raise ValueError(f"bf16 head dim {d} is not one of the kernel's {TC_HEAD_DIMS}")
        return "tc"
    raise TypeError(f"no kernel for {dtype}")


def _check(q, k, v) -> tuple[int, ...]:
    """Validate the inputs; returns (B, Sq, Sk, Hq, Hkv, d, dv)."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q must be (B, Sq, Hq, d), k (B, Sk, Hkv, d) and v (B, Sk, Hkv, dv)")
    B, Sq, Hq, d = q.shape
    Sk, Hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    if tuple(k.shape) != (B, Sk, Hkv, d) or tuple(v.shape) != (B, Sk, Hkv, dv):
        raise ValueError(f"k {tuple(k.shape)}, v {tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"{Hq} query heads are not a multiple of {Hkv} KV heads")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share one of {list(DTYPES)}: {q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    return B, Sq, Sk, Hq, Hkv, d, dv


def flash_attention(q, k, v, causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """Online-softmax attention over the whole sequence; K4 on CUDA.
    ``window`` (causal only): query i keeps the keys i - window < j <= i;
    None or 0 is the full causal path.  ``scale``: the scores' (None:
    d^-1/2)."""
    B, Sq, Sk, Hq, Hkv, d, dv = _check(q, k, v)
    if window and (not causal or window < 1):
        raise ValueError(f"a sliding window needs causal attention and window >= 1: {window}")
    if window and dv != d:
        raise ValueError("the kernel's narrower-v instance has no sliding window")
    window = int(window or 0)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal, window or None, scale=scale)
    refuse_autograd("K4 (flash_attn.ops.flash_attention)",
                    "models.layers.plain_attention or layers.flash_attention", q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous for the kernel")
    if not (1 <= B <= 65535 and 1 <= Hq and Sq >= 1 and Sk >= 1):
        raise ValueError(f"launch out of range: B={B} Sq={Sq} Sk={Sk} Hq={Hq}")
    kind = variant(q.dtype, d, dv)
    out = q.new_empty((B, Sq, Hq, dv))
    scale = 1.0 / d ** 0.5 if scale is None else float(scale)
    if kind == "tc":
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("the tensor-core kernel's TMA needs 16-byte aligned q, k and v")
        if -(-Sq // 128) > 65535:
            raise ValueError(f"Sq={Sq} needs more than 65535 q tiles")
        lib, fn, err_str = _lib_tc(), "flash_attn_tc", "flash_attn_tc_error_string"
        need = lib.flash_attn_tc_shared_bytes(d, dv)
    else:
        if window:
            raise ValueError("the fp32 kernel has no sliding window: serve windowed layers in bf16")
        if Hq > 65535:
            raise ValueError(f"launch out of range: Hq={Hq}")
        lib, fn, err_str = _lib(), "flash_attn", "flash_attn_error_string"
        if d > lib.flash_attn_max_head_dim():
            raise ValueError(f"head dim {d} exceeds the kernel's {lib.flash_attn_max_head_dim()}")
        need = lib.flash_attn_shared_bytes(d)
    if need > MAX_SHARED_BYTES:
        raise ValueError(f"d={d} needs {need} bytes of shared memory a block")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, Sq, Sk, Hq, Hkv, d, *([dv] if kind == "tc" else []), int(causal),
                *([window] if kind == "tc" else [])]
        err = getattr(lib, fn)(*args, scale, stream)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: {getattr(lib, err_str)(err).decode()}")
    LAUNCHES["flash_attention"] += 1
    LAUNCHES[f"flash_attention_{kind}"] += 1
    if window:
        LAUNCHES["flash_attention_window"] += 1
    if dv != d:
        LAUNCHES["flash_attention_dv"] += 1
    return out
