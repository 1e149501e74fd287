"""Quantization-aware training primitives (port of ``repro.core.qat``).

The printed MLP trains with power-of-2 weights, 4-bit pruned-ADC inputs and
uniformly re-digitised hidden activations, each quantizer with a
straight-through estimator (STE).  Everything is batched over a leading
population axis P: one row per chromosome, each with its own masks,
precisions and parameters, in place of the reference's ``jax.vmap``.

Parameters are a dict of stacked tensors ``{"w0": (P, C, H), "b0": (P, H),
"w1": (P, H, K), "b1": (P, K), ...}``, the reference's names.

Every reduction a row's training step needs has its order fixed by that
row alone (``core.sums.fixed_sum``, the kernels, or explicit loops over
the few classes), so a row's result does not depend on P or on the other
rows: the genome memo relies on it.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.sums import fixed_sum
from repro_torch.kernels.fused_qat import fused_qat_first_layer

__all__ = [
    "quantize_pow2",
    "quantize_uniform",
    "quantize_ternary",
    "quantize_layer_weights",
    "clip01",
    "act_approx",
    "ACT_APPROX_FNS",
    "MLPConfig",
    "init_mlp",
    "dense",
    "mlp_forward",
    "cross_entropy",
    "argmax",
    "accuracy",
]


def _ste(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return x + (q - x).detach()


def _as_f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


# 0-dim CPU constants: a binary op takes them as scalars on any device, so
# a clip launches no fill kernel (and copies nothing under a CUDA graph)
_ZERO = torch.tensor(0.0)
_ONE = torch.tensor(1.0)


def clip01(x: torch.Tensor) -> torch.Tensor:
    """``x`` clipped to [0, 1] with ``jnp.clip``'s gradient.

    ``minimum(maximum(x, 0), 1)``: at a tie (x exactly 0 or 1) the gradient
    splits, so the rail passes half of it, as ``jax.grad`` of ``jnp.clip``
    does; ``torch.clamp`` would pass all of it.
    """
    return torch.minimum(torch.maximum(x, _ZERO), _ONE)


def quantize_pow2(w: torch.Tensor, bits) -> torch.Tensor:
    """Power-of-2 quantizer: w -> sign(w) * 2^round(log2 |w|), STE gradient.

    ``bits`` (a scalar, or a tensor broadcastable against ``w``) bounds the
    exponent to [-(2^(bits-1)) + 1, 0]; magnitudes below half the smallest
    power collapse to 0.  ``torch.round`` rounds half to even, like
    ``jnp.round``.
    """
    bits = _as_f32(bits, w)
    e_lo = -torch.exp2(bits - 1.0) + 1.0
    mag = torch.abs(w)
    e = torch.round(torch.log2(torch.clamp(mag, min=1e-12)))
    e = torch.clamp(torch.maximum(e, e_lo), max=0.0)
    q = torch.sign(w) * torch.exp2(e)
    q = torch.where(mag < torch.exp2(e_lo - 1.0), 0.0, q)
    return _ste(w, q)


def quantize_uniform(x: torch.Tensor, bits, signed: bool = False) -> torch.Tensor:
    """Symmetric uniform quantizer with STE (activations / logits)."""
    bits = _as_f32(bits, x)
    n = torch.exp2(bits)
    scale = (n / 2.0) - 1.0 if signed else n - 1.0
    lo = -scale if signed else torch.zeros_like(scale)
    q = torch.minimum(torch.maximum(torch.round(x * scale), lo), scale) / scale
    return _ste(x, q)


def quantize_ternary(w: torch.Tensor) -> torch.Tensor:
    """Printed ternary weights {-s, 0, +s} of each row, STE gradient (arXiv 2508.19660).

    ``w`` is (P, ...): every row is its own tensor.  A weight is live when
    ``|w| > 0.7 * mean|w|`` and takes the row's ``s = mean |w|`` over the
    live weights, as the reference's per-tensor rule.  The row's sums run
    in ``fixed_sum``'s order, and the mean is ``sum * fp32(1/n)`` as XLA
    computes ``jnp.mean``.
    """
    P = w.shape[0]
    mag = torch.abs(w)
    flat = mag.reshape(P, -1)
    shape = (P,) + (1,) * (w.ndim - 1)
    thr = 0.7 * (fixed_sum(flat, 1) * (1.0 / flat.shape[1]))
    live = mag > thr.view(shape)
    count = fixed_sum(live.reshape(P, -1).to(w.dtype), 1)  # integer-valued: exact
    total = fixed_sum(torch.where(live, mag, 0.0).reshape(P, -1), 1)
    scale = total / torch.clamp(count, min=1.0)
    q = torch.where(live, torch.sign(w) * scale.view(shape), 0.0)
    return _ste(w, q)


def quantize_layer_weights(w: torch.Tensor, bits) -> torch.Tensor:
    """Per-row weight lowering keyed by a float bit width (the "wprec" genes).

    ``w`` is (P, ...) and ``bits`` (P,): ``bits > 0`` selects the po2
    quantizer at that width, ``bits == 0`` the ternary sentinel
    (``chromosome.TERNARY_BITS``).  Both run and each row selects, as the
    reference's branchless select under ``vmap``, so a population with
    mixed widths stays one set of launches.
    """
    bits = _rows(bits, w, w.ndim)
    po2 = quantize_pow2(w, torch.clamp(bits, min=1.0))
    return torch.where(bits > 0.0, po2, quantize_ternary(w))


# --- printed activation approximations (arXiv 2312.17612) ---------------
#
# Cheap printed-circuit stand-ins for ReLU before the [0, 1] clip and the
# act_bits re-digitisation.  Order matches chromosome.ACT_APPROX_CHOICES;
# index 0 is the exact baseline.


def _act_relu(h: torch.Tensor) -> torch.Tensor:
    return torch.relu(h)


def _act_sat01(h: torch.Tensor) -> torch.Tensor:
    # single printed source-follower stage: hard saturation at the rail
    return clip01(h)


def _act_pwl2(h: torch.Tensor) -> torch.Tensor:
    # two-segment compressive PWL: slope 1 on [0, 0.5], slope 0.5 above
    return torch.relu(h) - 0.5 * torch.relu(h - 0.5)


def _act_step(h: torch.Tensor) -> torch.Tensor:
    # binary comparator at the mid-rail; STE with sat01's gradient
    return _ste(_act_sat01(h), (h > 0.5).to(h.dtype))


ACT_APPROX_FNS = (_act_relu, _act_sat01, _act_pwl2, _act_step)


def act_approx(h: torch.Tensor, sel) -> torch.Tensor:
    """Each row's activation approximation, selected by its index in ``sel``.

    ``h`` is (P, ...) and ``sel`` (P,) integer indices into
    :data:`ACT_APPROX_FNS`.  Every branch runs on the whole tensor and each
    row takes its own, as ``lax.switch`` under ``vmap`` computes (an index
    out of range clamps to the nearest branch, as ``lax.switch`` does), so
    the selected values are the branch's bits and the step stays one set
    of launches whatever the selectors.
    """
    sel = torch.as_tensor(sel, device=h.device)
    sel = torch.clamp(sel, 0, len(ACT_APPROX_FNS) - 1).reshape((-1,) + (1,) * (h.ndim - 1))
    out = ACT_APPROX_FNS[-1](h)
    for k in range(len(ACT_APPROX_FNS) - 2, -1, -1):
        out = torch.where(sel == k, ACT_APPROX_FNS[k](h), out)
    return out


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    """Bespoke printed-MLP topology + quantization knobs."""

    layer_sizes: tuple[int, ...]  # (in, hidden..., classes)
    adc_bits: int = 4
    weight_bits: int = 8
    act_bits: int = 4


def init_mlp(gen: torch.Generator, cfg: MLPConfig) -> dict[str, torch.Tensor]:
    """uniform(+-1/sqrt(fan_in)) weights and zero biases of one row, shaped (1, ...).

    Drawn on the generator's device (the trainer uses a CPU generator, so a
    row's draw does not depend on where it trains).
    """
    params = {}
    for i, (fi, fo) in enumerate(zip(cfg.layer_sizes[:-1], cfg.layer_sizes[1:])):
        bound = 1.0 / float(fi) ** 0.5
        u = torch.rand((1, fi, fo), generator=gen, dtype=torch.float32)
        params[f"w{i}"] = u * (2.0 * bound) - bound
        params[f"b{i}"] = torch.zeros((1, fo), dtype=torch.float32)
    return params


class _Dense(torch.autograd.Function):
    """``h @ w + b`` for (P, B, J) x (P, J, K), each row's sums in a fixed order.

    The printed MLP's hidden layers are a few units wide, far below a
    matmul tile.  The products are formed elementwise and reduced with
    ``fixed_sum``, forward and backward, so a row's values never depend on
    how many rows share the call (a batched GEMM may change its reduction
    split with the batch count).
    """

    @staticmethod
    def forward(ctx, h, w, b):
        ctx.save_for_backward(h, w)
        return fixed_sum(h.unsqueeze(-1) * w.unsqueeze(1), 2) + b.unsqueeze(1)

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        dh = dw = db = None
        if ctx.needs_input_grad[0]:
            dh = fixed_sum(g.unsqueeze(2) * w.unsqueeze(1), 3)
        if ctx.needs_input_grad[1]:
            dw = fixed_sum(h.unsqueeze(-1) * g.unsqueeze(2), 1)
        if ctx.needs_input_grad[2]:
            db = fixed_sum(g, 1)
        return dh, dw, db


def dense(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(P, B, J) @ (P, J, K) + (P, K) with row-local fixed-order sums."""
    return _Dense.apply(h, w, b)


def _rows(v, like: torch.Tensor, ndim: int) -> torch.Tensor:
    """A per-row scalar (P,) (or a plain scalar) shaped to broadcast over ``ndim`` dims."""
    v = _as_f32(v, like)
    return v.reshape(v.shape + (1,) * (ndim - v.ndim)) if v.ndim else v


def mlp_forward(
    params: dict[str, torch.Tensor],
    x: torch.Tensor,
    cfg: MLPConfig,
    masks: torch.Tensor,
    weight_bits=None,
    act_bits=None,
    act_sel: torch.Tensor | None = None,
    layer_weight_bits: torch.Tensor | None = None,
    tables: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """Quantized forward pass of a population on the pruned-ADC path.

    Args:
      x:     (P, B, C) analog inputs.
      masks: (P, C, 2^adc_bits) pruned-ADC keep-masks.
      weight_bits, act_bits: per-row (P,) precisions (default: cfg's).
      act_sel: (P, n_hidden) int indices into :data:`ACT_APPROX_FNS`, one
        a hidden layer (genome axis "act"); None is relu.
      layer_weight_bits: (P, n_layers) fp32 widths through
        :func:`quantize_layer_weights` (0.0 = ternary, axis "wprec"); they
        replace ``weight_bits`` in every layer, the first one included.
      tables: the masks' comparator tables ``(thr, ids)``
        (``kernels.pruned_quant.ref.make_tables``) where the caller keeps
        them; then ``masks`` is not read.
    Returns: (P, B, n_classes) logits.

    The first layer is the fused comparator bank + matmul
    (``kernels.fused_qat``: the kernels on the card, their plain version on
    the CPU) on the quantized first-layer weight; hidden layers apply the
    activation -> clip to [0, 1] -> ``quantize_uniform(act_bits)``, as
    ``repro.core.qat.mlp_forward``.
    """
    wb = _rows(cfg.weight_bits if weight_bits is None else weight_bits, x, 3)
    ab = _rows(cfg.act_bits if act_bits is None else act_bits, x, 3)
    n_layers = len(cfg.layer_sizes) - 1

    def layer_w(i):
        if layer_weight_bits is None:
            return quantize_pow2(params[f"w{i}"], wb)
        return quantize_layer_weights(params[f"w{i}"], layer_weight_bits[:, i])

    def hidden_act(h, i):
        h = torch.relu(h) if act_sel is None else act_approx(h, act_sel[:, i])
        # printed hidden activations are re-digitised at act_bits
        return quantize_uniform(clip01(h), ab)

    h = fused_qat_first_layer(x, masks, layer_w(0), params["b0"], cfg.adc_bits, tables=tables)
    for i in range(1, n_layers):
        h = dense(hidden_act(h, i - 1), layer_w(i), params[f"b{i}"])
    return h


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-sample cross-entropy (P, B) of int labels under (P, B, K) logits.

    ``log(sum_k exp(l_k - m)) - (l_y - m)``, the value of
    ``-log_softmax(l)[y]`` with the max ``m`` held constant for the gradient
    as ``jax.nn.log_softmax`` does.  The class sum runs over the few
    classes in index order, so its gradient needs no reduction.
    """
    m = logits[..., 0]
    for k in range(1, logits.shape[-1]):
        m = torch.maximum(m, logits[..., k])
    shifted = logits - m.detach().unsqueeze(-1)
    total = torch.exp(shifted[..., 0])
    for k in range(1, logits.shape[-1]):
        total = total + torch.exp(shifted[..., k])
    picked = torch.gather(shifted, -1, labels.unsqueeze(-1)).squeeze(-1)
    return torch.log(total) - picked


def argmax(logits: torch.Tensor) -> torch.Tensor:
    """Index of the first largest logit over the last axis (``jnp.argmax`` ties)."""
    best = logits[..., 0]
    pred = torch.zeros(best.shape, dtype=torch.int64, device=logits.device)
    for k in range(1, logits.shape[-1]):
        better = logits[..., k] > best
        pred = torch.where(better, k, pred)
        best = torch.where(better, logits[..., k], best)
    return pred


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """(P,) fraction of correct predictions over the batch axis."""
    hits = (argmax(logits) == labels).sum(-1)  # integer count: exact in any order
    # times the fp32 reciprocal, as the reference's jnp.mean computes on XLA;
    # filled on the device, so a call on the card never waits for the host
    inv = torch.full((), 1.0 / labels.shape[-1], dtype=torch.float32, device=hits.device)
    return hits.to(torch.float32) * inv
