"""Pruned flash-ADC comparator bank: the K1 wrapper.

``pruned_quantize(x, mask, n_bits=4, vref=1.0)`` has the signature of the
JAX package's ``kernels/pruned_quant/ops.pruned_quantize``: x (..., C)
fp32 analog inputs, mask (C, 2^N) boolean keep-masks; returns the (..., C)
int32 level indices on the original 2^N grid.  The tables come from
``ref.make_tables`` and the leading axes are flattened into the kernel's
rows, as there.

Kernel: ``csrc/pruned_quant.cu`` (CUDA C++ for ``sm_90a``; the note at the
top of that file says what it replaces, what bounds it and how the design
answers).  Its grid is planned here, from shapes only (``launch_plan``):
channels a thread, rows a block and the grid, so that the CPU tests can
check that a plan covers every (row, channel) once.  Device rule: a tensor on the CPU takes the plain PyTorch version
``ref.pruned_quantize_ref``; a tensor on CUDA launches the kernel or raises.
There is no fallback between the two.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pruned_quant import ref

__all__ = ["LAUNCHES", "reset_launch_counts", "build", "LaunchPlan", "launch_plan",
           "pruned_quantize"]

SOURCES = [Path(__file__).resolve().parent / "csrc" / "pruned_quant.cu"]
THREADS = 128          # threads a block (csrc THREADS)
ROWS_IN_FLIGHT = 8     # rows a thread loads before it encodes (csrc U)
BLOCKS_PER_SM = 4      # blocks the plan aims to keep on each SM
H100_SMS = 132

LAUNCHES = {"pruned_quantize": 0}

_vp, _int = ctypes.c_void_p, ctypes.c_int


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_library("pruned_quant", SOURCES)
    lib.pruned_quant.argtypes = [_vp] * 4 + [_int] * 7 + [_vp]
    lib.pruned_quant.restype = _int
    lib.pruned_quant_error_string.argtypes = [_int]
    lib.pruned_quant_error_string.restype = ctypes.c_char_p
    return lib


def build() -> Path:
    """Build (or find) the kernel's shared library; returns its path."""
    return Path(_lib()._name)


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """K1's grid: thread (tx, bx, by) encodes channels [(bx * THREADS + tx) * width,
    + width) of rows [by * rows_per_block, + rows_per_block), clipped to (B, C)."""

    width: int            # channels a thread: 2 (8-byte accesses) or 1
    rows_per_block: int   # a multiple of ROWS_IN_FLIGHT
    grid_x: int
    grid_y: int


def launch_plan(B: int, C: int, aligned: bool = True, sms: int = H100_SMS) -> LaunchPlan:
    """The grid for a (B, C) call: two channels a thread where C is even and
    x is 8-byte aligned, one otherwise; enough row groups for about
    BLOCKS_PER_SM blocks on each of ``sms`` SMs, each block as many rows as
    that leaves (so the tables are read once a block, grid_y times in all)."""
    if B < 1 or C < 1:
        raise ValueError(f"empty launch: B={B} C={C}")
    width = 2 if C % 2 == 0 and aligned else 1
    grid_x = -(-(-(-C // width)) // THREADS)
    want_y = max(1, -(-sms * BLOCKS_PER_SM // grid_x))
    rows = -(-B // want_y)
    rows = -(-rows // ROWS_IN_FLIGHT) * ROWS_IN_FLIGHT
    return LaunchPlan(width, rows, grid_x, -(-B // rows))


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    plan = launch_plan(B, C, aligned=xf.data_ptr() % 8 == 0,
                       sms=_sm_count(x.device.index or 0))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.pruned_quant(xf.data_ptr(), thr.data_ptr(), ids.data_ptr(), out.data_ptr(),
                               B, C, T, plan.width, plan.rows_per_block, plan.grid_x,
                               plan.grid_y, stream)
    if err != 0:
        msg = lib.pruned_quant_error_string(err).decode()
        raise RuntimeError(f"pruned_quant launch failed: {msg}")
    LAUNCHES["pruned_quantize"] += 1
    return out.reshape(*lead, C)
