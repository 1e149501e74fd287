"""Chromosome encoding of the ADC-only co-design search (port of ``repro.core.chromosome``).

A genome is ``n_channels * 2^adc_bits`` boolean mask genes (level 0 of each
channel is forced kept at decode time) plus five categorical QAT genes:
weight_bits, act_bits, batch_size, epochs and lr, each an index into its
choice table.  The layout, and so the genome bytes the NSGA-II memo keys
on, is the reference's ADC-only layout; the "act" and "wprec" gene groups
wait for ROADMAP Queue 1 item 6 (``normalize_axes`` already validates an
axes selection as the reference does).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "WEIGHT_BITS_CHOICES",
    "ACT_BITS_CHOICES",
    "BATCH_CHOICES",
    "EPOCH_CHOICES",
    "LR_CHOICES",
    "CAT_CARDINALITIES",
    "AXES",
    "normalize_axes",
    "n_mask_bits",
    "cat_cardinalities",
    "decode_batch",
]

WEIGHT_BITS_CHOICES = (8, 7, 6, 5, 4)
ACT_BITS_CHOICES = (4, 3, 2, 5, 6)
BATCH_CHOICES = (64, 32, 16, 128)
EPOCH_CHOICES = (120, 80, 160, 60)
LR_CHOICES = (0.05, 0.02, 0.1, 0.01)

CAT_CARDINALITIES = (
    len(WEIGHT_BITS_CHOICES),
    len(ACT_BITS_CHOICES),
    len(BATCH_CHOICES),
    len(EPOCH_CHOICES),
    len(LR_CHOICES),
)


# the reference's gene groups; only "adc" is ported
AXES = ("adc", "act", "wprec")


def normalize_axes(axes) -> tuple[str, ...]:
    """Validate and canonicalise a gene-axes selection (the reference's check).

    Accepts any iterable (or comma-separated string) of axis names;
    returns them in the canonical ``("adc", "act", "wprec")`` order.  The
    ``"adc"`` axis is mandatory.
    """
    if isinstance(axes, str):
        axes = tuple(a.strip() for a in axes.split(",") if a.strip())
    axes = tuple(axes)
    unknown = [a for a in axes if a not in AXES]
    if unknown:
        raise ValueError(f"unknown genome axis(es) {unknown}; choose from {AXES}")
    if "adc" not in axes:
        raise ValueError(
            "the 'adc' axis is mandatory: the per-input level masks are "
            "the genome's structural backbone (drop levels by evolving "
            "the masks, not by removing the axis)"
        )
    return tuple(a for a in AXES if a in axes)


def n_mask_bits(n_channels: int, adc_bits: int) -> int:
    return n_channels * (1 << adc_bits)


def cat_cardinalities() -> tuple[int, ...]:
    """Categorical gene cardinalities of the ADC-only genome."""
    return CAT_CARDINALITIES


def decode_batch(
    mask_genes: np.ndarray, cat_genes: np.ndarray, n_channels: int, adc_bits: int
) -> dict[str, np.ndarray]:
    """Vectorised decode of a whole population -> per-row arrays for the trainer."""
    P = mask_genes.shape[0]
    n = 1 << adc_bits
    masks = np.asarray(mask_genes, bool).reshape(P, n_channels, n).copy()
    masks[:, :, 0] = True
    base = np.asarray(cat_genes)
    if base.shape[-1] != len(CAT_CARDINALITIES):
        raise ValueError(
            f"categorical genome has {base.shape[-1]} genes, the ADC-only "
            f"genome has {len(CAT_CARDINALITIES)}"
        )
    return {
        "masks": masks,
        "weight_bits": np.asarray(WEIGHT_BITS_CHOICES)[base[:, 0]].astype(np.float32),
        "act_bits": np.asarray(ACT_BITS_CHOICES)[base[:, 1]].astype(np.float32),
        "batch_size": np.asarray(BATCH_CHOICES)[base[:, 2]].astype(np.int32),
        "epochs": np.asarray(EPOCH_CHOICES)[base[:, 3]].astype(np.int32),
        "lr": np.asarray(LR_CHOICES)[base[:, 4]].astype(np.float32),
    }
