"""RMSNorm over the last dim, with the post-norm residual add: the wrapper.

``rms_norm(x, scale, eps, residual=None)`` computes ``models.layers.rms_norm(x,
scale, eps)``, and ``residual + rms_norm(...)`` where a residual is given: x
(..., d) and the residual in bf16 or fp32, scale (d,) of the same dtype;
returns (..., d) in that dtype.

Kernel: ``csrc/rms_norm.cu`` (CUDA C++ for ``sm_90a``; the note at the top of
that file says what it takes the place of, what bounds it and how the design
answers).  Its grid is planned here, from shapes only (``launch_plan``):
threads a row from the width, rows a block, blocks for the rows, so that the
CPU tests can check that a plan covers every (row, vector) once.  Device
rule: a tensor on the CPU takes the plain PyTorch version ``ref.rms_norm_ref``;
a tensor on CUDA launches the kernel or raises.  There is no fallback
between the two.  ``LAUNCHES`` counts launches: ``rms_norm`` every one,
``rms_norm_residual`` those with a residual.  The kernel has no backward:
a CUDA call that autograd would record raises (``kernels.refuse_autograd``);
training takes ``models.layers.rms_norm``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build, refuse_autograd
from repro_torch.kernels.rms_norm import ref

__all__ = ["LAUNCHES", "DTYPES", "reset_launch_counts", "build", "LaunchPlan", "launch_plan",
           "rms_norm"]

SOURCES = [Path(__file__).resolve().parent / "csrc" / "rms_norm.cu"]
DTYPES = (torch.float32, torch.bfloat16)
VECTOR_BYTES = 16          # a thread's loads and stores
MAX_VPT = 8                # vectors a thread keeps in registers (csrc MAX_VPT)
TARGET_VPT = 4             # the plan's aim: few threads a row, 4 vectors each
MAX_THREADS_PER_ROW = 512  # csrc MAX_THREADS: a block's threads at most
BLOCK_THREADS = 256        # rows of fewer threads share a block of this many

LAUNCHES = {"rms_norm": 0, "rms_norm_residual": 0}

_vp, _int, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_library("rms_norm", SOURCES)
    lib.rms_norm.argtypes = [_vp] * 4 + [_i64] + [_int] * 6 + [ctypes.c_float, _vp]
    lib.rms_norm.restype = _int
    lib.rms_norm_error_string.argtypes = [_int]
    lib.rms_norm_error_string.restype = ctypes.c_char_p
    return lib


def build() -> Path:
    """Build (or find) the kernel's shared library; returns its path."""
    return Path(_lib()._name)


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """The kernel's grid: row ``b * rows_per_block + t // tpr`` is thread
    (t, b)'s, which holds its vectors ``t % tpr + j * tpr`` (j < vpt) below
    ``nvec``; rows at or past the call's are idle."""

    nvec: int             # 16-byte vectors a row
    tpr: int              # threads a row, a power of two
    vpt: int              # vectors a thread
    rows_per_block: int
    grid: int

    @property
    def block(self) -> int:
        return self.tpr * self.rows_per_block


def launch_plan(rows: int, d: int, itemsize: int) -> LaunchPlan:
    """The grid for ``rows`` rows of width ``d`` of ``itemsize``-byte
    elements: the fewest threads a row (a power of two) that hold its
    vectors at about TARGET_VPT each, at most MAX_VPT; rows of fewer than
    BLOCK_THREADS threads share a block of that many.  Raises on a width
    the kernel cannot take."""
    if rows < 1 or d < 1:
        raise ValueError(f"empty launch: rows={rows} d={d}")
    per_vec = VECTOR_BYTES // itemsize
    if d % per_vec:
        raise ValueError(f"width {d} is not a multiple of {per_vec} ({VECTOR_BYTES}-byte "
                         "vectors)")
    nvec = d // per_vec
    tpr = 1 << max(0, (-(-nvec // TARGET_VPT) - 1).bit_length())
    tpr = min(tpr, MAX_THREADS_PER_ROW)
    vpt = -(-nvec // tpr)
    if vpt > MAX_VPT:
        raise ValueError(f"width {d} needs {vpt} vectors a thread, more than {MAX_VPT}")
    rows_per_block = max(1, BLOCK_THREADS // tpr)
    grid = -(-rows // rows_per_block)
    if grid > 2**31 - 1:
        raise ValueError(f"launch out of range: {rows} rows")
    return LaunchPlan(nvec, tpr, vpt, rows_per_block, grid)


def _check(x, scale, residual) -> None:
    if x.ndim < 1:
        raise ValueError("x must be (..., d)")
    d = x.shape[-1]
    if tuple(scale.shape) != (d,):
        raise ValueError(f"scale {tuple(scale.shape)} does not fit x's width {d}")
    if residual is not None and residual.shape != x.shape:
        raise ValueError(f"residual {tuple(residual.shape)} does not fit x {tuple(x.shape)}")
    others = [scale] + ([residual] if residual is not None else [])
    if x.dtype not in DTYPES or any(t.dtype != x.dtype for t in others):
        raise TypeError(f"x, scale and residual must share one of {list(DTYPES)}: "
                        f"{[t.dtype for t in [x] + others]}")
    if any(t.device != x.device for t in others):
        raise ValueError(f"scale and residual must be on x's device {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             residual: torch.Tensor | None = None) -> torch.Tensor:
    """``layers.rms_norm(x, scale, eps)`` (+ ``residual``); the kernel on CUDA."""
    _check(x, scale, residual)
    if x.device.type == "cpu":
        return ref.rms_norm_ref(x, scale, eps, residual)
    refuse_autograd("rms_norm (kernels.rms_norm.ops.rms_norm)", "models.layers.rms_norm",
                    x, scale, residual)
    tensors = {"x": x, "scale": scale, "residual": residual}
    for name, t in tensors.items():
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous for the kernel")
        if t is not None and t.data_ptr() % VECTOR_BYTES:
            raise ValueError(f"{name} must be {VECTOR_BYTES}-byte aligned for the kernel")
    d = x.shape[-1]
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    if rows == 0:
        return out
    plan = launch_plan(rows, d, x.element_size())
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.rms_norm(x.data_ptr(), scale.data_ptr(),
                           residual.data_ptr() if residual is not None else None,
                           out.data_ptr(), rows, d, int(x.dtype == torch.bfloat16), plan.vpt,
                           plan.tpr.bit_length() - 1, plan.rows_per_block, plan.grid, eps,
                           stream)
    if err != 0:
        raise RuntimeError(f"rms_norm launch failed: {lib.rms_norm_error_string(err).decode()}")
    LAUNCHES["rms_norm"] += 1
    if residual is not None:
        LAUNCHES["rms_norm_residual"] += 1
    return out
