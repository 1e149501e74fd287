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
) -> torch.Tensor:
    """Quantized forward pass of a population on the pruned-ADC path.

    Args:
      x:     (P, B, C) analog inputs.
      masks: (P, C, 2^adc_bits) pruned-ADC keep-masks.
      weight_bits, act_bits: per-row (P,) precisions (default: cfg's).
    Returns: (P, B, n_classes) logits.

    The first layer is the fused comparator bank + matmul
    (``kernels.fused_qat``: the kernels on the card, their plain version on
    the CPU); hidden layers apply relu -> clip to [0, 1] ->
    ``quantize_uniform(act_bits)``, as ``repro.core.qat.mlp_forward``.
    """
    wb = _rows(cfg.weight_bits if weight_bits is None else weight_bits, x, 3)
    ab = _rows(cfg.act_bits if act_bits is None else act_bits, x, 3)
    n_layers = len(cfg.layer_sizes) - 1

    def hidden_act(h):
        return quantize_uniform(torch.clamp(torch.relu(h), 0.0, 1.0), ab)

    h = fused_qat_first_layer(x, masks, quantize_pow2(params["w0"], wb), params["b0"], cfg.adc_bits)
    for i in range(1, n_layers):
        h = dense(hidden_act(h), quantize_pow2(params[f"w{i}"], wb), params[f"b{i}"])
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
