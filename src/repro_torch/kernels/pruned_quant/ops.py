"""Pruned flash-ADC comparator bank: the K1 wrapper.

``pruned_quantize(x, mask, n_bits=4, vref=1.0)`` has the signature of the
JAX package's ``kernels/pruned_quant/ops.pruned_quantize``: x (..., C)
fp32 analog inputs, mask (C, 2^N) boolean keep-masks; returns the (..., C)
int32 level indices on the original 2^N grid.  The tables come from
``ref.make_tables`` and the leading axes are flattened into the kernel's
rows, as there.

Kernel: ``csrc/pruned_quant.cu`` (CUDA C++ for ``sm_90a``; the note at the
top of that file says what it replaces, what bounds it and how the design
answers).  Device rule: a tensor on the CPU takes the plain PyTorch version
``ref.pruned_quantize_ref``; a tensor on CUDA launches the kernel or raises.
There is no fallback between the two.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pruned_quant import ref

__all__ = ["LAUNCHES", "reset_launch_counts", "build", "pruned_quantize"]

SOURCES = [Path(__file__).resolve().parent / "csrc" / "pruned_quant.cu"]
MAX_SHARED_BYTES = 232448  # 227 KB, the most one Hopper block may opt into

LAUNCHES = {"pruned_quantize": 0}

_vp, _int = ctypes.c_void_p, ctypes.c_int


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_library("pruned_quant", SOURCES)
    lib.pruned_quant.argtypes = [_vp] * 4 + [_int] * 3 + [_vp]
    lib.pruned_quant.restype = _int
    lib.pruned_quant_shared_bytes.argtypes = [_int]
    lib.pruned_quant_shared_bytes.restype = ctypes.c_size_t
    lib.pruned_quant_error_string.argtypes = [_int]
    lib.pruned_quant_error_string.restype = ctypes.c_char_p
    return lib


def build() -> Path:
    """Build (or find) the kernel's shared library; returns its path."""
    return Path(_lib()._name)


def _check(x, mask, n_bits: int) -> None:
    if x.ndim < 1:
        raise ValueError("x must be (..., C)")
    C = x.shape[-1]
    if tuple(mask.shape) != (C, 1 << n_bits):
        raise ValueError(
            f"mask {tuple(mask.shape)} does not fit x's {C} channels at {n_bits} bits")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    if mask.device != x.device:
        raise ValueError(f"mask is on {mask.device}, x on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def pruned_quantize(x: torch.Tensor, mask: torch.Tensor, n_bits: int = 4,
                    vref: float = 1.0) -> torch.Tensor:
    """Levels (..., C) int32 of x through per-channel pruned flash ADCs; K1 on CUDA."""
    _check(x, mask, n_bits)
    thr, ids = ref.make_tables(mask, n_bits, vref)
    lead, C = x.shape[:-1], x.shape[-1]
    xf = x.reshape(-1, C)
    if x.device.type == "cpu":
        return ref.pruned_quantize_ref(xf, thr, ids).reshape(*lead, C)
    xf = xf.contiguous()
    B, T = xf.shape[0], thr.shape[1]
    if B > 2**31 - 1 or C > 2**31 - 1:
        raise ValueError(f"launch out of range: B={B} C={C}")
    out = torch.empty((B, C), dtype=torch.int32, device=x.device)
    if B == 0 or C == 0:
        return out.reshape(*lead, C)
    lib = _lib()
    need = lib.pruned_quant_shared_bytes(T)
    if need > MAX_SHARED_BYTES:
        raise ValueError(f"{n_bits} bits ({T} comparators) need {need} bytes of shared memory")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.pruned_quant(xf.data_ptr(), thr.data_ptr(), ids.data_ptr(), out.data_ptr(),
                               B, C, T, stream)
    if err != 0:
        msg = lib.pruned_quant_error_string(err).decode()
        raise RuntimeError(f"pruned_quant launch failed: {msg}")
    LAUNCHES["pruned_quantize"] += 1
    return out.reshape(*lead, C)
