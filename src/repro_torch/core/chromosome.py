"""Chromosome encoding of the co-design search (port of ``repro.core.chromosome``).

The reference's genome is NumPy only, so the port keeps its own copy: the
same layout, the same genome bytes (which the NSGA-II memo keys on), the
same decoded arrays.  Three gene groups, ``axes``:

  * ``"adc"`` (always on): per-input ADC level masks --
    ``n_channels * 2^adc_bits`` boolean genes (level 0 of each channel is
    forced kept at decode time) plus five categorical QAT genes:
    weight_bits, act_bits, batch_size, epochs and lr, each an index into
    its choice table;
  * ``"act"``: one categorical gene per hidden layer selecting the
    activation from ACT_APPROX_CHOICES (``core.qat.act_approx``);
  * ``"wprec"``: one categorical gene per weight layer selecting the
    weight lowering from WPREC_CHOICES (po2 at k bits, or ternary;
    ``core.qat.quantize_layer_weights``).

With the default ``axes=("adc",)`` the layout is the ADC-only one.  An
enabled axis appends its genes to the categorical vector in the canonical
order: base QAT genes, then act genes, then wprec genes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

WEIGHT_BITS_CHOICES = (8, 7, 6, 5, 4)
ACT_BITS_CHOICES = (4, 3, 2, 5, 6)
BATCH_CHOICES = (64, 32, 16, 128)
EPOCH_CHOICES = (120, 80, 160, 60)
LR_CHOICES = (0.05, 0.02, 0.1, 0.01)

# Activation implementations per hidden layer (axis "act"); index 0 is the
# exact baseline so all-zero genes decode to the pre-axes network.  The
# lowering lives in core.qat.ACT_APPROX_FNS (same order); the printed
# circuit cost of each choice in core.area.ACT_APPROX_AREA_SCALE.
ACT_APPROX_CHOICES = ("relu", "sat01", "pwl2", "step")

# Weight lowering per layer (axis "wprec"); index 0 is the exact po2-8
# baseline.  Encoded to the trainer as a float bit width, with 0.0 the
# ternary sentinel (core.qat.quantize_layer_weights branches on it).
WPREC_CHOICES = ("po2-8", "po2-6", "po2-4", "ternary")
WPREC_BITS = (8.0, 6.0, 4.0, 0.0)
TERNARY_BITS = 0.0  # sentinel: quantize_layer_weights -> quantize_ternary

AXES = ("adc", "act", "wprec")

# The base (axis-"adc") categorical genome: the persisted-memo key layout
# assumes exactly these five genes.
CAT_CARDINALITIES = (
    len(WEIGHT_BITS_CHOICES),
    len(ACT_BITS_CHOICES),
    len(BATCH_CHOICES),
    len(EPOCH_CHOICES),
    len(LR_CHOICES),
)

N_BASE_CATS = len(CAT_CARDINALITIES)


def normalize_axes(axes) -> tuple[str, ...]:
    """Validate and canonicalise a gene-axes selection.

    Accepts any iterable (or comma-separated string) of axis names;
    returns them in the canonical ``("adc", "act", "wprec")`` order.
    The ``"adc"`` axis is mandatory — the mask gene group is the
    structural backbone every decode path assumes.
    """
    if isinstance(axes, str):
        axes = tuple(a.strip() for a in axes.split(",") if a.strip())
    axes = tuple(axes)
    unknown = [a for a in axes if a not in AXES]
    if unknown:
        raise ValueError(
            f"unknown genome axis(es) {unknown}; choose from {AXES}"
        )
    if "adc" not in axes:
        raise ValueError(
            "the 'adc' axis is mandatory: the per-input level masks are "
            "the genome's structural backbone (drop levels by evolving "
            "the masks, not by removing the axis)"
        )
    return tuple(a for a in AXES if a in axes)


def cat_cardinalities(
    axes: tuple[str, ...] = ("adc",), n_layers: int = 2
) -> tuple[int, ...]:
    """Categorical gene cardinalities for a genome over ``axes``.

    ``n_layers`` is the number of weight layers (``len(layer_sizes)-1``);
    the act group has one gene per *hidden* layer (``n_layers - 1``), the
    wprec group one per weight layer.  With ``axes=("adc",)`` this is
    exactly the module-level :data:`CAT_CARDINALITIES`.
    """
    axes = normalize_axes(axes)
    if n_layers < 1:
        raise ValueError(f"n_layers must be >= 1, got {n_layers}")
    cards = list(CAT_CARDINALITIES)
    if "act" in axes:
        cards += [len(ACT_APPROX_CHOICES)] * (n_layers - 1)
    if "wprec" in axes:
        cards += [len(WPREC_CHOICES)] * n_layers
    return tuple(cards)


def split_cats(
    cats: np.ndarray, axes: tuple[str, ...] = ("adc",), n_layers: int = 2
) -> dict[str, np.ndarray]:
    """Slice a categorical gene array into its per-axis groups.

    ``cats`` is (..., n_cats) in the canonical layout (base QAT genes,
    then act genes, then wprec genes).  Returns ``{"base": (..., 5),
    "act": (..., n_layers-1) | None, "wprec": (..., n_layers) | None}``.
    """
    axes = normalize_axes(axes)
    cats = np.asarray(cats)
    expect = len(cat_cardinalities(axes, n_layers))
    if cats.shape[-1] != expect:
        raise ValueError(
            f"categorical genome has {cats.shape[-1]} genes, axes {axes} "
            f"with {n_layers} layers expect {expect}"
        )
    out: dict[str, np.ndarray | None] = {
        "base": cats[..., :N_BASE_CATS], "act": None, "wprec": None,
    }
    off = N_BASE_CATS
    if "act" in axes:
        out["act"] = cats[..., off : off + n_layers - 1]
        off += n_layers - 1
    if "wprec" in axes:
        out["wprec"] = cats[..., off : off + n_layers]
    return out


@dataclasses.dataclass(frozen=True)
class DecodedChromosome:
    mask: np.ndarray  # (n_channels, 2^adc_bits) bool, level 0 kept
    weight_bits: int
    act_bits: int
    batch_size: int
    epochs: int
    lr: float
    # generalized-genome axes (None when the axis is not searched):
    act_sel: np.ndarray | None = None  # (n_hidden,) ACT_APPROX_CHOICES idx
    wprec: np.ndarray | None = None  # (n_layers,) float bits, 0.0=ternary


def n_mask_bits(n_channels: int, adc_bits: int) -> int:
    return n_channels * (1 << adc_bits)


def decode(
    mask_genes: np.ndarray,
    cat_genes: np.ndarray,
    n_channels: int,
    adc_bits: int,
    axes: tuple[str, ...] = ("adc",),
    n_layers: int = 2,
) -> DecodedChromosome:
    n = 1 << adc_bits
    mask = np.asarray(mask_genes, dtype=bool).reshape(n_channels, n).copy()
    mask[:, 0] = True
    groups = split_cats(np.asarray(cat_genes), axes, n_layers)
    wb, ab, bs, ep, lr = (int(g) for g in groups["base"])
    act_sel = wprec = None
    if groups["act"] is not None:
        act_sel = np.asarray(groups["act"], np.int32)
    if groups["wprec"] is not None:
        wprec = np.asarray(WPREC_BITS, np.float32)[groups["wprec"]]
    return DecodedChromosome(
        mask=mask,
        weight_bits=WEIGHT_BITS_CHOICES[wb],
        act_bits=ACT_BITS_CHOICES[ab],
        batch_size=BATCH_CHOICES[bs],
        epochs=EPOCH_CHOICES[ep],
        lr=LR_CHOICES[lr],
        act_sel=act_sel,
        wprec=wprec,
    )


def encode(
    dec: DecodedChromosome,
    n_channels: int,
    adc_bits: int,
    axes: tuple[str, ...] = ("adc",),
    n_layers: int = 2,
) -> tuple[np.ndarray, np.ndarray]:
    """Inverse of :func:`decode`: a DecodedChromosome back to gene arrays.

    Returns ``(mask_genes, cat_genes)`` in the canonical layout (flat
    bool mask, then base QAT genes, then act genes, then wprec genes).
    Like :func:`decode`, level 0 of every channel is canonically forced
    kept, so ``decode(*encode(dec)) == dec`` for any decode output.
    Raises ValueError when a field value is not in its choice table or a
    gene group's shape does not match ``axes`` / ``n_layers``.
    """
    axes = normalize_axes(axes)
    n = 1 << adc_bits
    mask = np.asarray(dec.mask, dtype=bool)
    if mask.shape != (n_channels, n):
        raise ValueError(
            f"mask shape {mask.shape} != ({n_channels}, {n}) for "
            f"adc_bits={adc_bits}"
        )
    mask = mask.copy()
    mask[:, 0] = True

    def _idx(table, value, name):
        for i, v in enumerate(table):
            if v == value:
                return i
        raise ValueError(f"{name}={value!r} not in {table}")

    cats = [
        _idx(WEIGHT_BITS_CHOICES, dec.weight_bits, "weight_bits"),
        _idx(ACT_BITS_CHOICES, dec.act_bits, "act_bits"),
        _idx(BATCH_CHOICES, dec.batch_size, "batch_size"),
        _idx(EPOCH_CHOICES, dec.epochs, "epochs"),
        _idx(LR_CHOICES, dec.lr, "lr"),
    ]
    if "act" in axes:
        act_sel = np.asarray(dec.act_sel, np.int64).reshape(-1)
        if act_sel.shape != (n_layers - 1,):
            raise ValueError(
                f"act_sel has {act_sel.shape[0]} genes, expected {n_layers - 1}"
            )
        if act_sel.size and not (
            (act_sel >= 0) & (act_sel < len(ACT_APPROX_CHOICES))
        ).all():
            raise ValueError(f"act_sel {act_sel} out of range")
        cats += [int(a) for a in act_sel]
    if "wprec" in axes:
        wprec = np.asarray(dec.wprec, np.float32).reshape(-1)
        if wprec.shape != (n_layers,):
            raise ValueError(
                f"wprec has {wprec.shape[0]} genes, expected {n_layers}"
            )
        cats += [_idx(WPREC_BITS, float(b), "wprec") for b in wprec]
    return mask.reshape(-1), np.asarray(cats, np.int64)


def decode_batch(
    mask_genes: np.ndarray,
    cat_genes: np.ndarray,
    n_channels: int,
    adc_bits: int,
    axes: tuple[str, ...] = ("adc",),
    n_layers: int = 2,
) -> dict[str, np.ndarray]:
    """Vectorised decode of a whole population -> per-row arrays for the trainer.

    With axes beyond ``"adc"`` the dict grows ``"act_sel"`` (P, n_hidden)
    int32 selector indices and/or ``"wprec"`` (P, n_layers) float32 bit
    widths (0.0 = ternary); absent axes are simply not in the dict, so
    ADC-only callers are byte-for-byte untouched.
    """
    P = mask_genes.shape[0]
    n = 1 << adc_bits
    masks = np.asarray(mask_genes, bool).reshape(P, n_channels, n).copy()
    masks[:, :, 0] = True
    groups = split_cats(np.asarray(cat_genes), axes, n_layers)
    base = groups["base"]
    wb = np.asarray(WEIGHT_BITS_CHOICES)[base[:, 0]]
    ab = np.asarray(ACT_BITS_CHOICES)[base[:, 1]]
    bs = np.asarray(BATCH_CHOICES)[base[:, 2]]
    ep = np.asarray(EPOCH_CHOICES)[base[:, 3]]
    lr = np.asarray(LR_CHOICES)[base[:, 4]]
    out = {
        "masks": masks,
        "weight_bits": wb.astype(np.float32),
        "act_bits": ab.astype(np.float32),
        "batch_size": bs.astype(np.int32),
        "epochs": ep.astype(np.int32),
        "lr": lr.astype(np.float32),
    }
    if groups["act"] is not None:
        out["act_sel"] = np.asarray(groups["act"], np.int32)
    if groups["wprec"] is not None:
        out["wprec"] = np.asarray(WPREC_BITS, np.float32)[groups["wprec"]]
    return out
