"""Plain PyTorch version of the fused pruned-ADC QAT first layer.

``fused_qat_ref`` composes the port's own building blocks exactly as the
unfused path does (``core.adc.quantize_pruned_ste`` then ``h @ w + b``).
The ``*_tables`` functions compute the same thing from the threshold/id
tables the kernels take; the wrapper in ``ops`` runs them for tensors on
the CPU, and ``chip_smoke.py`` holds the kernels against them on the card.

Shapes carry an explicit leading population axis P (the reference's
``vmap``): x (P, B, C), thr/ids (P, C, T), w (P, C, F), b (P, F).
"""

from __future__ import annotations

import torch

from repro_torch.core import adc
from repro_torch.kernels.pruned_quant.ref import pruned_quantize_ref

__all__ = [
    "fused_qat_ref",
    "dequant_ste_tables",
    "fused_forward_tables",
    "fused_backward_tables",
]


def fused_qat_ref(x, mask, w, b, n_bits: int, vref: float = 1.0) -> torch.Tensor:
    """Unfused reference: STE pruned-ADC dequant, then first-layer matmul."""
    h = adc.quantize_pruned_ste(x, mask, n_bits, vref)
    return torch.matmul(h, w) + b.unsqueeze(-2)


def dequant_ste_tables(x, thr, ids, scale: float) -> torch.Tensor:
    """``x + (v - x)`` with ``v = level * scale`` from the (P, C, T) tables."""
    lv = pruned_quantize_ref(x, thr.unsqueeze(-3), ids.unsqueeze(-3))
    v = lv.to(torch.float32) * scale
    return x + (v - x)


def fused_forward_tables(x, thr, ids, w, b, scale: float) -> torch.Tensor:
    """(P, B, F) pre-activations: what the forward kernel computes."""
    return torch.matmul(dequant_ste_tables(x, thr, ids, scale), w) + b.unsqueeze(-2)


def fused_backward_tables(x, thr, ids, w, g, scale: float):
    """(dx (P, B, C), dw (P, C, F)): what the backward kernel computes."""
    h = dequant_ste_tables(x, thr, ids, scale)
    return torch.matmul(g, w.transpose(-1, -2)), torch.matmul(h.transpose(-1, -2), g)
