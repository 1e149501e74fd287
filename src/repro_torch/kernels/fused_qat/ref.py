"""Plain PyTorch version of the fused pruned-ADC QAT first layer.

``fused_qat_ref`` composes the port's own building blocks exactly as the
unfused path does (``core.adc.quantize_pruned_ste`` then ``h @ w + b``).
The ``*_tables`` functions compute the same thing from the threshold/id
tables the kernels take; the wrapper in ``ops`` runs them for tensors on
the CPU, and ``chip_smoke.py`` holds the kernels against them on the card.
``fused_backward_emulation`` repeats K3's own order of summation for dw
(``csrc/fused_qat.cu``), so that order can be tested on the CPU and the
kernel's dw checked bit for bit on the card.

Shapes carry an explicit leading population axis P (the reference's
``vmap``): x (P, B, C), thr/ids (P, C, T), w (P, C, F), b (P, F).
"""

from __future__ import annotations

import torch
import torch.nn.functional as tnf

from repro_torch.core import adc
from repro_torch.kernels.pruned_quant.ref import pruned_quantize_ref

__all__ = [
    "fused_qat_ref",
    "dequant_ste_tables",
    "fused_forward_tables",
    "fused_backward_tables",
    "BWD_THREADS",
    "fused_backward_emulation",
]

BWD_THREADS = 128  # threads of a K3 block (csrc BWD_THREADS): 4 warps of 32


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


def fused_backward_tables(x, thr, ids, w, g, scale: float, need_dx: bool = True):
    """(dx (P, B, C) or None, dw (P, C, F)): what the backward kernel computes."""
    h = dequant_ste_tables(x, thr, ids, scale)
    dx = torch.matmul(g, w.transpose(-1, -2)) if need_dx else None
    return dx, torch.matmul(h.transpose(-1, -2), g)


def _fold(v: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` (a power of two long) in halves: v[:n/2] + v[n/2:], until one."""
    while v.shape[dim] > 1:
        h = v.shape[dim] // 2
        v = v.narrow(dim, 0, h) + v.narrow(dim, h, h)
    return v.squeeze(dim)


def fused_backward_emulation(x, thr, ids, w, g, scale: float):
    """(dx (P, B, C), dw (P, C, F)) with dw summed in K3's order.

    K3 gives each (row p, channel c) a block of BWD_THREADS threads.  Thread t
    adds the products h[b, c] * g[b, f] of samples t, t + BWD_THREADS, ... in
    index order to a sum that starts at 0; each warp folds its 32 sums in
    halves (its shuffle tree), and the 4 warp sums are added as
    (w0 + w2) + (w1 + w3).  Every step is an fp32 multiply or add on tensors
    of one row's shape, so a row's dw has the same bits alone, inside any
    batch of rows, and on every run.  dx is the plain product (the kernel's
    5-term fmaf chain may differ from it in the last bit).
    """
    h = dequant_ste_tables(x, thr, ids, scale)
    P, B, C = h.shape
    F = g.shape[-1]
    rounds = max(1, -(-B // BWD_THREADS))
    prod = h.unsqueeze(-1) * g.unsqueeze(-2)                     # (P, B, C, F)
    prod = tnf.pad(prod, (0, 0, 0, 0, 0, rounds * BWD_THREADS - B))
    prod = prod.view(P, rounds, BWD_THREADS, C, F)
    sample = torch.arange(BWD_THREADS, device=x.device).view(BWD_THREADS, 1, 1)
    acc = torch.zeros((P, BWD_THREADS, C, F), dtype=torch.float32, device=x.device)
    for k in range(rounds):  # a thread's samples in index order; past B it adds nothing
        acc = torch.where(k * BWD_THREADS + sample < B, acc + prod[:, k], acc)
    warps = _fold(acc.view(P, BWD_THREADS // 32, 32, C, F), 2)  # (P, 4, C, F)
    return torch.matmul(g, w.transpose(-1, -2)), _fold(warps, 1)
