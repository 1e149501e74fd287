"""Flash-ADC digital twin with per-input level pruning (port of ``repro.core.adc``).

An N-bit flash ADC exposes 2^N uniform levels over [0, vref).  Level ``i``
(i >= 1) has a comparator at ``i / 2^N``; level 0 is the ground state and
has none.  Pruning level ``i`` removes its comparator: an input that would
land on it falls to the next-lower kept level, and the encoder emits the
kept level's original code, so values stay on the uniform grid
``v = level / 2^N``.

Masks are boolean ``(..., C, 2^N)`` tensors; ``mask[..., i]`` keeps level
``i``.  Level 0 is forced kept.  A leading population axis P on the mask
(``(P, C, 2^N)``) pairs with inputs of shape ``(P, B, C)``: each row has
its own bank.
"""

from __future__ import annotations

import torch

__all__ = [
    "force_level0",
    "levels_to_values",
    "kept_thresholds",
    "quantize_pruned",
    "quantize_pruned_ste",
]


def force_level0(mask: torch.Tensor) -> torch.Tensor:
    """Level 0 is the comparator-free ground state: always kept."""
    mask = mask.clone()
    mask[..., 0] = True
    return mask


def levels_to_values(levels: torch.Tensor, n_bits: int, vref: float = 1.0) -> torch.Tensor:
    """Dequantize level indices back onto the uniform value grid."""
    return levels.to(torch.float32) * (vref / (1 << n_bits))


def kept_thresholds(mask: torch.Tensor, n_bits: int, vref: float = 1.0) -> torch.Tensor:
    """Per-channel sorted threshold table ``(..., 2^N - 1)``, pruned slots +inf."""
    n = 1 << n_bits
    lvl = torch.arange(1, n, dtype=torch.float32, device=mask.device) * (vref / n)
    thr = torch.where(mask[..., 1:], lvl, torch.inf)
    # +inf sorts last and kept thresholds are already ascending
    return torch.sort(thr, dim=-1, stable=True).values


def _bank_shape(t: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Line a per-channel table up with ``x``: (P, C, k) -> (P, 1, C, k)."""
    return t.unsqueeze(-3) if mask.ndim == 3 else t


def quantize_pruned(
    x: torch.Tensor, mask: torch.Tensor, n_bits: int, vref: float = 1.0
) -> torch.Tensor:
    """Levels of ``x`` through per-channel pruned flash ADCs.

    Args:
      x:    (..., C) analog inputs, or (P, B, C) when ``mask`` is (P, C, 2^N).
      mask: (C, 2^N) or (P, C, 2^N) boolean keep-masks (level 0 forced).
    Returns:
      int32 level indices on the ORIGINAL 2^N grid, shaped like ``x``.
    """
    mask = force_level0(mask.to(torch.bool))
    n = 1 << n_bits
    x = torch.clamp(x, 0.0, vref * (1.0 - 0.5 / n))
    thr = _bank_shape(kept_thresholds(mask, n_bits, vref), mask)
    rank = torch.sum(x.unsqueeze(-1) >= thr, dim=-1)  # kept comparators that fire
    keep = mask[..., 1:]
    lvl_ids = torch.arange(1, n, dtype=torch.int32, device=mask.device)
    big = torch.iinfo(torch.int32).max
    # kept level ids compacted to the front in ascending order, 0 after
    compact = torch.sort(torch.where(keep, lvl_ids, big), dim=-1).values
    compact = torch.where(compact == big, 0, compact)
    padded = torch.cat([torch.zeros_like(compact[..., :1]), compact], dim=-1)  # (..., C, n)
    padded = _bank_shape(padded, mask).expand(x.shape + (n,))
    return torch.gather(padded, -1, rank.unsqueeze(-1)).squeeze(-1)


def quantize_pruned_ste(
    x: torch.Tensor, mask: torch.Tensor, n_bits: int, vref: float = 1.0
) -> torch.Tensor:
    """Dequantized pruned-ADC output with a straight-through gradient.

    Forward value ``x + (v - x)`` with ``v = level * vref / 2^N`` (the same
    fp32 op order as the reference); backward is the identity in ``x``.
    """
    v = levels_to_values(quantize_pruned(x, mask, n_bits, vref), n_bits, vref)
    return x + (v - x).detach()
