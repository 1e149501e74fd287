"""Int8 gradient compression with error feedback (port of
``repro.optim.compress``).

Compressing gradients to int8 before a data-parallel all-reduce cuts its
bytes 4x (vs fp32); the error-feedback buffer (Karimireddy et al., 2019)
re-injects the quantization error next step so SGD still converges.
``launch/train`` runs it behind ``grad_compression="int8_ef"``.  On one
card there is no all-reduce: compress then decompress is the whole path.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["CompressState", "init_state", "compress_gradients", "decompress_gradients"]

_INV_127 = float(torch.tensor(1.0 / 127.0, dtype=torch.float32))


class CompressState(NamedTuple):
    error: dict  # error-feedback residuals, same keys as the grads


def init_state(params: dict) -> CompressState:
    return CompressState(error={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                                for k, p in params.items()})


@torch.no_grad()
def compress_gradients(grads: dict, state: CompressState):
    """grads -> (int8 codes, per-leaf fp32 scales, new state)."""
    codes, scales, errors = {}, {}, {}
    for k, g in grads.items():
        g32 = g.to(torch.float32) + state.error[k]  # re-inject last step's residual
        # XLA folds the division by the constant 127 into a multiply by its
        # fp32 reciprocal; the same here, so the scales agree bit for bit
        scale = torch.clamp(g32.abs().max(), min=1e-12) * _INV_127
        q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
        codes[k], scales[k] = q, scale
        errors[k] = _residual(g32, q.to(torch.float32), scale)
    return codes, scales, CompressState(errors)


def _residual(g32: torch.Tensor, q32: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``g32 - q32 * scale`` rounded once, as the reference's fused
    multiply-subtract gives it (XLA contracts it to an FMA; the product is
    ~127x larger than the residual, so its own rounding would show).

    ``scale`` splits into a high part with 12 mantissa bits and the rest,
    so both products with |q| <= 127 are exact, and ``g32 - q32 * s_hi`` is
    exact too (|g32 - q32 * scale| <= scale / 2): only the last subtraction
    rounds, on the card and the CPU alike."""
    s_hi = (scale.view(torch.int32) & ~0xFFF).view(torch.float32)
    s_lo = scale - s_hi
    return (g32 - q32 * s_hi) - q32 * s_lo


def decompress_gradients(codes: dict, scales: dict) -> dict:
    """The fp32 gradients of ``compress_gradients``' codes and scales (after
    the all-reduce, where there is one)."""
    return {k: q.to(torch.float32) * scales[k] for k, q in codes.items()}
