"""Plain PyTorch comparator-bank tables and level encoder.

Port of ``repro.kernels.pruned_quant.ref``: the pieces the fused QAT layer
needs.  The comparator bank and priority encoder are one masked max-reduce,

    level(b, c) = max_t  ids[c, t] * (x[b, c] >= thr[c, t])

with pruned levels carrying ``thr = +inf`` and ``ids = 0``.
"""

from __future__ import annotations

import torch

__all__ = ["make_tables", "pruned_quantize_ref"]


def make_tables(mask: torch.Tensor, n_bits: int, vref: float = 1.0):
    """mask (..., C, 2^N) -> (thr (..., C, 2^N-1) fp32 +inf-padded, ids int32)."""
    n = 1 << n_bits
    keep = mask.to(torch.bool)[..., 1:]
    lvl = torch.arange(1, n, dtype=torch.int32, device=mask.device)
    thr = torch.where(keep, lvl.to(torch.float32) * (vref / n), torch.inf)
    ids = torch.where(keep, lvl, 0).to(torch.int32)
    return thr.contiguous(), ids.contiguous()


def pruned_quantize_ref(x: torch.Tensor, thr: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Levels (..., C) int32 of x (..., C) against tables (C, T) (or broadcastable)."""
    fired = x.unsqueeze(-1) >= thr
    return torch.amax(torch.where(fired, ids, 0), dim=-1).to(torch.int32)
