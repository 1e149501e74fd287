"""Proxy area/power model of pruned flash ADCs (port of ``repro.core.area``).

Mirrors the paper's section II-B proxy: a pruned ADC costs

    area  = n_comparators * A_COMP + n_or * A_OR + n_and * A_AND
    power = n_comparators * P_COMP + n_or * P_OR + n_and * P_AND

where ``n_comparators`` is the number of kept levels ``i >= 1`` and the
encoder gate counts follow from the kept-level set: each output bit is an
OR-tree over the level-select signals of kept levels whose code has that
bit set, and each kept level but the topmost needs one AND.  The resistor
ladder is untouched by pruning and is left out of the ratios, as the paper
normalises against the conventional ADC.  The bespoke power-of-2 MLP
proxy and its generalized-genome costing (activation circuits, per-layer
weight precision) price the whole printed system when the search goes
beyond the ADC masks.  NumPy only, copied from the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "ADCCostModel",
    "EGFET_4BIT",
    "encoder_gate_counts",
    "adc_cost",
    "adc_cost_batch",
    "conventional_cost",
    "mlp_pow2_cost",
    "ACT_APPROX_AREA_SCALE",
    "mlp_genome_cost_batch",
    "genome_area_batch",
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


def encoder_gate_counts(mask: np.ndarray, n_bits: int) -> tuple[int, int]:
    """(n_or, n_and) of the pruned priority encoder for ONE channel mask."""
    mask = np.asarray(mask).astype(bool).copy()
    mask[0] = True
    kept = [i for i in range(1, 1 << n_bits) if mask[i]]
    n_and = max(len(kept) - 1, 0)  # topmost kept level needs no AND
    n_or = 0
    for b in range(n_bits):
        t = sum(1 for i in kept if (i >> b) & 1)
        n_or += max(t - 1, 0)
    return n_or, n_and


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


# ---------------------------------------------------------------------------
# Bespoke pow2 MLP circuit proxy (for the system-level Table I benchmark).
# ---------------------------------------------------------------------------

# EGFET full-adder-ish cost per bit of an adder stage (cm^2, mW).
# Calibrated so the [7]-style bespoke MLPs land at Table-I magnitudes AND
# the Fig.-1 system breakdown reproduces ADC-dominance (~55% area / ~70%
# power) with the published per-dataset topologies.
_A_ADD_BIT = 0.004
_P_ADD_BIT = 0.010
_A_RELU_BIT = 0.0006
_P_RELU_BIT = 0.002


def mlp_pow2_cost(
    layer_sizes: list[int],
    weight_bits: int = 8,
    act_bits: int = 4,
    nonzero_frac: float = 1.0,
) -> tuple[float, float]:
    """(area, power) proxy of a bespoke multiplier-free pow2 MLP.

    Each nonzero pow2 weight contributes one shift (wiring, ~free) and one
    adder slot in the neuron's accumulation tree: a neuron with f fan-in has
    (f - 1) adders of ~(act_bits + weight_exponent_range) bit width.  ReLU /
    comparator output stages add a small per-neuron term.
    """
    area = power = 0.0
    acc_bits = act_bits + weight_bits // 2  # accumulator growth proxy
    for fan_in, n_out in zip(layer_sizes[:-1], layer_sizes[1:]):
        eff_fan_in = max(int(round(fan_in * nonzero_frac)), 1)
        adders = (eff_fan_in - 1 + 1) * n_out  # +1 for bias add
        area += adders * acc_bits * _A_ADD_BIT
        power += adders * acc_bits * _P_ADD_BIT
        area += n_out * acc_bits * _A_RELU_BIT
        power += n_out * acc_bits * _P_RELU_BIT
    return float(area), float(power)


# ---------------------------------------------------------------------------
# Generalized-genome costing: activation circuit + per-layer weight precision.
# ---------------------------------------------------------------------------

# Printed output-stage area/power of each chromosome.ACT_APPROX_CHOICES entry
# relative to the exact ReLU stage (same order).  The saturating follower
# drops the dedicated rectifier, the 2-segment PWL replaces it with a
# resistor-divider bend, and the mid-rail comparator is a single stage.
ACT_APPROX_AREA_SCALE = (1.0, 0.75, 0.6, 0.25)


def mlp_genome_cost_batch(
    layer_sizes: list[int],
    weight_bits: np.ndarray,
    act_bits: np.ndarray,
    act_sel: np.ndarray | None = None,
    wprec: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """(areas, powers) of a population of bespoke MLPs under the genome axes.

    ``weight_bits`` / ``act_bits`` are (P,) per-individual scalars.  With
    ``wprec`` (P, n_layers) float widths (0.0 = ternary) the per-layer gene
    supersedes the scalar: a ternary crossbar is pure sign-add, so its
    accumulator grows only 1 bit over ``act_bits`` instead of
    ``weight_bits // 2``.  With ``act_sel`` (P, n_hidden) indices, each
    hidden layer's output-stage term is scaled by
    :data:`ACT_APPROX_AREA_SCALE`.  With both None this reduces exactly to
    a vectorised :func:`mlp_pow2_cost` (nonzero_frac = 1).
    """
    weight_bits = np.asarray(weight_bits, np.float64)
    act_bits = np.asarray(act_bits, np.float64)
    n_layers = len(layer_sizes) - 1
    P = weight_bits.shape[0]
    if wprec is None:
        per_layer_w = np.broadcast_to(weight_bits[:, None], (P, n_layers))
    else:
        per_layer_w = np.asarray(wprec, np.float64)
        if per_layer_w.shape != (P, n_layers):
            raise ValueError(
                f"wprec shape {per_layer_w.shape} != {(P, n_layers)}"
            )
    # accumulator growth proxy per layer; ternary -> sign-add only (+1 bit)
    acc = act_bits[:, None] + np.where(per_layer_w > 0, per_layer_w // 2, 1.0)
    scales = np.asarray(ACT_APPROX_AREA_SCALE, np.float64)
    area = np.zeros(P, np.float64)
    power = np.zeros(P, np.float64)
    for i, (fan_in, n_out) in enumerate(zip(layer_sizes[:-1], layer_sizes[1:])):
        adders = (fan_in - 1 + 1) * n_out  # +1 for bias add
        area += adders * acc[:, i] * _A_ADD_BIT
        power += adders * acc[:, i] * _P_ADD_BIT
        if act_sel is not None and i < n_layers - 1:
            s = scales[np.asarray(act_sel, np.int64)[:, i]]
        else:
            s = 1.0
        area += s * n_out * acc[:, i] * _A_RELU_BIT
        power += s * n_out * acc[:, i] * _P_RELU_BIT
    return area, power


def genome_area_batch(
    masks: np.ndarray,
    n_bits: int,
    layer_sizes: list[int],
    weight_bits: np.ndarray,
    act_bits: np.ndarray,
    act_sel: np.ndarray | None = None,
    wprec: np.ndarray | None = None,
    model: ADCCostModel = EGFET_4BIT,
) -> tuple[np.ndarray, np.ndarray]:
    """Total printed front-end + classifier cost of a genome population.

    The joint-objective area when the search goes beyond ADC masks:
    comparator bank (pruned encoder) + weighted-sum precision area +
    activation circuits, all per individual.  Returns (areas, powers),
    each (P,).
    """
    adc_area, adc_power = adc_cost_batch(masks, n_bits, model)
    mlp_area, mlp_power = mlp_genome_cost_batch(
        layer_sizes, weight_bits, act_bits, act_sel=act_sel, wprec=wprec
    )
    return adc_area + mlp_area, adc_power + mlp_power
