"""Proxy area/power model of pruned flash ADCs (port of ``repro.core.area``).

Mirrors the paper's section II-B proxy: a pruned ADC costs

    area  = n_comparators * A_COMP + n_or * A_OR + n_and * A_AND
    power = n_comparators * P_COMP + n_or * P_OR + n_and * P_AND

where ``n_comparators`` is the number of kept levels ``i >= 1`` and the
encoder gate counts follow from the kept-level set: each output bit is an
OR-tree over the level-select signals of kept levels whose code has that
bit set, and each kept level but the topmost needs one AND.  The resistor
ladder is untouched by pruning and is left out of the ratios, as the paper
normalises against the conventional ADC.  NumPy only, copied from the
reference; the bespoke-MLP cost terms wait for the genome-axes slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "ADCCostModel",
    "EGFET_4BIT",
    "adc_cost",
    "adc_cost_batch",
    "conventional_cost",
]


@dataclasses.dataclass(frozen=True)
class ADCCostModel:
    """Per-gate EGFET cost constants (area cm^2, power mW)."""

    a_comp: float = 0.0095
    a_or: float = 0.0008
    a_and: float = 0.0006
    a_ladder: float = 0.004  # fixed, unprunable (reported separately)
    p_comp: float = 0.075
    p_or: float = 0.004
    p_and: float = 0.003
    p_ladder: float = 0.02


EGFET_4BIT = ADCCostModel()


def adc_cost_batch(
    masks: np.ndarray,
    n_bits: int,
    model: ADCCostModel = EGFET_4BIT,
    include_ladder: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """(areas, powers) of a whole population of pruned ADC banks at once.

    ``masks`` is (..., C, 2^N): any number of leading batch axes over a
    C-channel bank.  Returns arrays of shape (...,) — the bank cost is the
    sum of its bespoke per-channel ADCs.  One vectorized pass: comparator
    counts are popcounts over kept levels, AND counts are ``kept - 1``, and
    the per-bit OR-tree terms come from a single (levels x bits) bit-table
    contraction instead of a per-mask Python loop.
    """
    n = 1 << n_bits
    masks = np.asarray(masks, dtype=bool)
    if masks.shape[-1] != n:
        raise ValueError(
            f"mask level axis {masks.shape[-1]} != 2^{n_bits}; "
            "masks must be (..., C, 2^n_bits)"
        )
    if masks.ndim < 2:
        masks = masks[None]
    n_ch = masks.shape[-2]
    m = masks.reshape((-1, n)).copy()
    m[:, 0] = True
    keep = m[:, 1:]  # (B*C, n-1)
    n_cmp = keep.sum(axis=-1)  # comparators = kept levels i >= 1
    n_and = np.maximum(n_cmp - 1, 0)  # topmost kept level needs no AND
    lvl = np.arange(1, n)
    bit_table = (lvl[:, None] >> np.arange(n_bits)[None, :]) & 1  # (n-1, N)
    t = keep.astype(np.int64) @ bit_table  # kept levels with bit b set
    n_or = np.maximum(t - 1, 0).sum(axis=-1)
    area = n_cmp * model.a_comp + n_or * model.a_or + n_and * model.a_and
    power = n_cmp * model.p_comp + n_or * model.p_or + n_and * model.p_and
    if include_ladder:
        area = area + model.a_ladder
        power = power + model.p_ladder
    batch_shape = masks.shape[:-2]
    # sum the channel axis -> per-bank totals (explicit channel count so an
    # empty batch reshapes cleanly to (0, C) instead of an ambiguous -1)
    area = area.reshape(batch_shape + (n_ch,)).sum(axis=-1)
    power = power.reshape(batch_shape + (n_ch,)).sum(axis=-1)
    return area.astype(np.float64), power.astype(np.float64)


def adc_cost(
    mask: np.ndarray,
    n_bits: int,
    model: ADCCostModel = EGFET_4BIT,
    include_ladder: bool = False,
) -> tuple[float, float]:
    """(area, power) of ONE pruned ADC bank.

    ``mask`` is (2^N,) for one channel or (C, 2^N) for a bank; the bank cost
    is the sum of its bespoke per-channel ADCs.  Thin scalar wrapper over
    :func:`adc_cost_batch`.
    """
    mask = np.asarray(mask).astype(bool)
    if mask.ndim == 1:
        mask = mask[None]
    area, power = adc_cost_batch(mask[None], n_bits, model, include_ladder)
    return float(area[0]), float(power[0])


def conventional_cost(
    n_channels: int,
    n_bits: int,
    model: ADCCostModel = EGFET_4BIT,
    include_ladder: bool = False,
) -> tuple[float, float]:
    """Cost of the unpruned ADC bank (the normalisation baseline)."""
    full = np.ones((n_channels, 1 << n_bits), dtype=bool)
    return adc_cost(full, n_bits, model, include_ladder)
