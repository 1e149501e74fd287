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

:func:`circuit_simulate` is the gate-level oracle (comparator bank ->
thermometer code -> level-select ANDs -> OR-tree encoder), in numpy and
deliberately literal, as in the reference: the tests hold the fast path
to it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = [
    "ADCSpec",
    "force_level0",
    "levels_to_values",
    "kept_thresholds",
    "quantize_pruned",
    "quantize_pruned_ste",
    "thermometer_code",
    "circuit_simulate",
]


@dataclasses.dataclass(frozen=True)
class ADCSpec:
    """Static description of the ADC frontend of one model.

    Attributes:
      n_bits:     flash-ADC resolution N (levels = 2^N).
      n_channels: number of analog input channels (one bespoke ADC each).
      vref:       full-scale reference; inputs are normalised to [0, vref).
    """

    n_bits: int = 4
    n_channels: int = 1
    vref: float = 1.0

    @property
    def n_levels(self) -> int:
        return 1 << self.n_bits

    def full_mask(self, device=None) -> torch.Tensor:
        """The unpruned bank: a (n_channels, 2^N) bool tensor of ones on ``device``."""
        return torch.ones((self.n_channels, self.n_levels), dtype=torch.bool,
                          device=resolve_device(device))


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


# ---------------------------------------------------------------------------
# Gate-level circuit simulation (tests only; deliberately literal).
# ---------------------------------------------------------------------------

def thermometer_code(x: np.ndarray, mask: np.ndarray, n_bits: int, vref: float = 1.0) -> np.ndarray:
    """Comparator-bank outputs of the pruned ADC, one bit per KEPT level >= 1.

    Returns (..., C, 2^N - 1) uint8; pruned comparator positions are 0
    (their comparator does not exist).
    """
    n = 1 << n_bits
    x = np.clip(np.asarray(x, np.float64), 0.0, vref * (1.0 - 0.5 / n))
    thr = np.arange(1, n, dtype=np.float64) * (vref / n)
    fired = (x[..., None] >= thr).astype(np.uint8)
    keep = np.asarray(mask)[..., 1:].astype(np.uint8)
    return fired * keep


def circuit_simulate(x: np.ndarray, mask: np.ndarray, n_bits: int, vref: float = 1.0) -> np.ndarray:
    """Bit-exact pruned flash ADC: comparators -> priority encoder -> binary.

    Mirrors Fig. 3(b) of the paper: level-select signal
    ``s_i = c_i AND NOT c_j`` where ``c_j`` is the next *kept* comparator
    above ``i`` (for the topmost kept level, ``s_i = c_i``); output bit
    ``a_b = OR_{kept i with bit b set} s_i``.
    Returns (..., C) int64 level ids.
    """
    n = 1 << n_bits
    mask = np.asarray(mask).astype(bool).copy()
    mask[..., 0] = True
    tc = thermometer_code(x, mask, n_bits, vref)  # (..., C, n-1)
    batch_shape = tc.shape[:-2] if tc.ndim >= 2 else ()
    C = mask.shape[0] if mask.ndim == 2 else 1
    mask2 = mask.reshape(C, n)
    tc = tc.reshape(batch_shape + (C, n - 1)) if tc.ndim >= 2 else tc

    out = np.zeros(tc.shape[:-1], dtype=np.int64)
    for c in range(C):
        kept = [i for i in range(1, n) if mask2[c, i]]
        # level-select AND gates
        s = {}
        for idx, i in enumerate(kept):
            ci = tc[..., c, i - 1]
            if idx + 1 < len(kept):
                cj = tc[..., c, kept[idx + 1] - 1]
                s[i] = ci & (1 - cj)
            else:
                s[i] = ci
        # OR-tree encoder per output bit
        bits = np.zeros(tc.shape[:-2] + (n_bits,), dtype=np.uint8)
        for b in range(n_bits):
            acc = np.zeros(tc.shape[:-2], dtype=np.uint8)
            for i in kept:
                if (i >> b) & 1:
                    acc = acc | s[i]
            bits[..., b] = acc
        out[..., c] = sum((bits[..., b].astype(np.int64) << b) for b in range(n_bits))
    return out
