"""Fused pruned-ADC QAT first layer: the kernel wrappers and the autograd Function.

``fused_qat_first_layer`` replaces the unfused pair

    h = adc.quantize_pruned_ste(x, mask, n_bits)   # comparator bank, STE
    h @ w + b                                       # first-layer matmul

inside ``core.qat.mlp_forward``, for a whole population at once.  The
po2 weight quantizer stays outside (its own STE chains through the ``w``
gradient returned here), so callers pass the already-quantized weight.

Kernels (``csrc/fused_qat.cu``, CUDA C++ for ``sm_90a``; see the note at
the top of that file for what bounds them and how the design answers):

* ``fused_forward``  -- K2, replaces ``_fwd_kernel`` of
  ``src/repro/kernels/fused_qat/fused_qat.py``; a block per (tile of
  samples, row), a thread an element in its comparator stage and an output
  in its matmul stage, planned from shapes alone by ``forward_plan`` so
  that the CPU tests can check the plan;
* ``fused_backward`` -- K3, replaces ``_bwd_kernel`` there; the dequantized
  activations are recomputed from ``x``, never saved.  One launch a call,
  dw summed in a fixed tree over samples that
  ``ref.fused_backward_emulation`` repeats on the CPU.

Device rule: a tensor on the CPU takes the plain PyTorch version in
``ref``; a tensor on CUDA launches the kernel or raises.  There is no
fallback between the two.  ``LAUNCHES`` counts kernel launches, one per
wrapper call that launches, so a run can show its main path went through
the kernels.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from pathlib import Path

import torch

from repro_torch.core.sums import fixed_sum
from repro_torch.kernels import _build
from repro_torch.kernels.fused_qat import ref
from repro_torch.kernels.pruned_quant.ref import make_tables

__all__ = [
    "LAUNCHES",
    "reset_launch_counts",
    "ForwardPlan",
    "forward_plan",
    "fused_forward",
    "fused_backward",
    "FusedQAT",
    "fused_qat_first_layer",
]

SOURCES = [Path(__file__).resolve().parent / "csrc" / "fused_qat.cu"]
MAX_SHARED_BYTES = 48 * 1024  # default dynamic shared memory of one forward block
MAX_THREADS = 1024  # threads of one forward block (csrc FWD_MAX_THREADS)
MAX_ROWS = 65535  # grid.y carries the population axis
TILE = 16  # samples a forward block, chosen by measurement on the card (PERF.md)

LAUNCHES = {"fused_qat_forward": 0, "fused_qat_backward": 0}

_vp, _int, _float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library, loaded once per process (hashing sources is not free)."""
    lib = _build.load_library("fused_qat", SOURCES)
    lib.fused_qat_forward.argtypes = [_vp] * 6 + [_int] * 5 + [_float] + [_int] * 4 + [_vp]
    lib.fused_qat_forward.restype = _int
    lib.fused_qat_backward.argtypes = [_vp] * 7 + [_int] * 5 + [_float, _vp]
    lib.fused_qat_backward.restype = _int
    lib.fused_qat_error_string.argtypes = [_int]
    lib.fused_qat_error_string.restype = ctypes.c_char_p
    return lib


def build() -> Path:
    """Build (or find) the kernels' shared library; returns its path."""
    return Path(_lib()._name)


def _check(x, thr, ids, w, other, other_name: str, other_shape) -> tuple[int, ...]:
    """Validate the kernels' inputs; returns (P, B, C, T, F)."""
    if x.ndim != 3 or thr.ndim != 3 or ids.ndim != 3 or w.ndim != 3:
        raise ValueError("x, thr, ids and w must be (P, B, C), (P, C, T), (P, C, T), (P, C, F)")
    P, B, C = x.shape
    T, F = thr.shape[2], w.shape[2]
    want = {
        "thr": (thr, (P, C, T), torch.float32),
        "ids": (ids, (P, C, T), torch.int32),
        "w": (w, (P, C, F), torch.float32),
        other_name: (other, other_shape(P, B, F), torch.float32),
    }
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.device.type == "cuda":
        for name, t in [("x", x), *((n, v[0]) for n, v in want.items())]:
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous for the kernel")
        if P < 1 or B < 1 or C < 1 or F < 1:
            raise ValueError(f"empty launch: P={P} B={B} C={C} F={F}")
        if P > MAX_ROWS:
            raise ValueError(f"population {P} exceeds the kernel's grid limit {MAX_ROWS}")
    elif x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    return P, B, C, T, F


def _launch_check(lib, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.fused_qat_error_string(err).decode()}")


@dataclasses.dataclass(frozen=True)
class ForwardPlan:
    """K2's launch: block (bx, p) covers samples [bx * tile, + tile) of row p,
    clipped to B.  In its comparator stage thread t takes element t of those
    samples' x rows, (sample t // C, channel t % C); in its matmul stage,
    output t, (sample t // F, unit t % F).  Threads past the tile's elements
    (or outputs) idle in that stage."""

    tile: int           # samples a block
    threads: int        # tile * max(C, F), rounded up to a warp
    grid_x: int         # tiles of a row; grid.y is P
    shared_bytes: int   # thr, ids (C * T each), w (C * F) and the h tile (tile * C)


def forward_plan(P: int, B: int, C: int, F: int, T: int) -> ForwardPlan:
    """The launch of a (P, B, C) -> (P, B, F) forward: TILE samples a block,
    fewer where the batch is smaller, where max(C, F) channels or units would
    need more than MAX_THREADS threads, or where the h tile would not fit in
    MAX_SHARED_BYTES beside the tables; raises ValueError where even one
    sample a block does not fit."""
    if P < 1 or B < 1 or C < 1 or F < 1:
        raise ValueError(f"empty launch: P={P} B={B} C={C} F={F}")
    width = max(C, F)
    if width > MAX_THREADS:
        raise ValueError(
            f"C={C}, F={F}: one sample a block needs {width} threads; "
            f"a block holds at most {MAX_THREADS}")
    fixed = 4 * (2 * C * T + C * F)  # the row's tables and weights
    fits = (MAX_SHARED_BYTES - fixed) // (4 * C)  # samples whose h tile fits beside them
    if fits < 1:
        raise ValueError(
            f"C={C}, T={T}, F={F}: the row's tables, weights and one sample need "
            f"{fixed + 4 * C} bytes of shared memory a block; the kernel takes at most "
            f"{MAX_SHARED_BYTES}")
    tile = min(TILE, MAX_THREADS // width, fits, B)
    return ForwardPlan(tile, -(-tile * width // 32) * 32, -(-B // tile),
                       fixed + 4 * tile * C)


def fused_forward(x, thr, ids, w, b, scale: float) -> torch.Tensor:
    """K2: (P, B, F) = (x + (level(x)*scale - x)) @ w + b, row by row."""
    P, B, C, T, F = _check(x, thr, ids, w, b, "b", lambda P, B, F: (P, F))
    if x.device.type == "cpu":
        return ref.fused_forward_tables(x, thr, ids, w, b, scale)
    plan = forward_plan(P, B, C, F, T)
    lib = _lib()
    out = torch.empty((P, B, F), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fused_qat_forward(
            x.data_ptr(), thr.data_ptr(), ids.data_ptr(), w.data_ptr(), b.data_ptr(),
            out.data_ptr(), P, B, C, T, F, float(scale), plan.tile, plan.threads,
            plan.grid_x, plan.shared_bytes, stream,
        )
    _launch_check(lib, err, "fused_qat_forward")
    LAUNCHES["fused_qat_forward"] += 1
    return out


def fused_backward(x, thr, ids, w, g, scale: float, need_dx: bool = True):
    """K3: (dx (P, B, C) or None, dw (P, C, F)) from the output gradient g."""
    P, B, C, T, F = _check(x, thr, ids, w, g, "g", lambda P, B, F: (P, B, F))
    if x.device.type == "cpu":
        return ref.fused_backward_tables(x, thr, ids, w, g, scale, need_dx)
    lib = _lib()
    dev = x.device
    dx = torch.empty((P, B, C), dtype=torch.float32, device=dev) if need_dx else None
    dw = torch.empty((P, C, F), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_qat_backward(
            x.data_ptr(), thr.data_ptr(), ids.data_ptr(), w.data_ptr(), g.data_ptr(),
            dx.data_ptr() if need_dx else None, dw.data_ptr(),
            P, B, C, T, F, float(scale), stream,
        )
    _launch_check(lib, err, "fused_qat_backward")
    LAUNCHES["fused_qat_backward"] += 1
    return dx, dw


class FusedQAT(torch.autograd.Function):
    """K2 forward, K3 backward; the STE makes the quantizer's gradient the identity.

    The tables are searched by the GA, not trained: no gradient for them.
    ``db`` is the batch sum of ``g`` in the fixed order of ``fixed_sum``.
    """

    @staticmethod
    def forward(ctx, x, thr, ids, w, b, scale):
        ctx.save_for_backward(x, thr, ids, w)
        ctx.scale = scale
        return fused_forward(x, thr, ids, w, b, scale)

    @staticmethod
    def backward(ctx, g):
        x, thr, ids, w = ctx.saved_tensors
        g = g.contiguous()
        dx, dw = fused_backward(x, thr, ids, w, g, ctx.scale, need_dx=ctx.needs_input_grad[0])
        db = fixed_sum(g, 1) if ctx.needs_input_grad[4] else None
        return dx, None, None, dw, db, None


def fused_qat_first_layer(x, mask, w, b, n_bits: int = 4, vref: float = 1.0) -> torch.Tensor:
    """Fused pruned-ADC quantize + first-layer QAT matmul, STE gradient.

    Args:
      x:    (P, B, C) analog inputs in [0, vref).
      mask: (P, C, 2^N) boolean keep-masks (level 0 is never a comparator).
      w:    (P, C, F) first-layer weights, already po2-quantized.
      b:    (P, F) bias.
    Returns: (P, B, F) float32 pre-activations.
    """
    thr, ids = make_tables(mask, n_bits, vref)
    return FusedQAT.apply(
        x.contiguous(), thr, ids, w.contiguous(), b.contiguous(), vref / (1 << n_bits)
    )
