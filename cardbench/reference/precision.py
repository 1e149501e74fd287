"""Precisions below the stated one, for the controls: TF32 and fp8 (e4m3).

The controls are the plain references computed one precision lower than
the configuration states.  Both roundings are written out on fp32
tensors, so a control computes the same on the card and on the CPU and
needs no hardware mode: ``tf32`` rounds a matmul's inputs to TF32's 10
mantissa bits (to nearest, ties to even), as a TF32 tensor-core GEMM reads
them; ``fp8`` scales each row to e4m3's range, rounds it to e4m3 and back.
A TF32 matmul under autograd rounds the inputs of its backward products too,
as a TF32 GEMM does in the backward pass.
"""

from __future__ import annotations

import torch

__all__ = ["tf32", "fp8", "matmul"]

E4M3_MAX = 448.0


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32 (1 sign, 8 exponent, 10 mantissa bits)."""
    bits = x.contiguous().view(torch.int32)
    # round to nearest even on the 13 dropped bits, then clear them
    lsb = (bits >> 13) & 1
    rounded = (bits + 0x0FFF + lsb) & ~0x1FFF
    out = rounded.view(torch.float32)
    return torch.where(torch.isfinite(x), out, x)


def fp8(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """fp32 ``x`` through e4m3 with one scale per slice along ``dim``."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    scale = amax / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _TF32MatMul(torch.autograd.Function):
    """``a @ b`` from TF32 inputs, forward and backward."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = tf32(a), tf32(b)
        ctx.save_for_backward(a, b)
        return torch.matmul(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32(g)
        return torch.matmul(g, b.transpose(-1, -2)), torch.matmul(a.transpose(-1, -2), g)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str = "fp32") -> torch.Tensor:
    """``a @ b`` in fp32 from inputs held in ``precision``: "fp32", "tf32"
    or "fp8" (a's rows and b's columns scaled apart; no gradient)."""
    if precision == "tf32":
        return _TF32MatMul.apply(a, b)
    if precision == "fp8":
        a, b = fp8(a, -1), fp8(b, -2)
    elif precision != "fp32":
        raise ValueError(f"unknown precision {precision!r}")
    return torch.matmul(a, b)
