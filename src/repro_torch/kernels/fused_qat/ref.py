"""Plain PyTorch version of the fused pruned-ADC QAT first layer.

``fused_qat_ref`` composes the port's own building blocks exactly as the
unfused path does (``core.adc.quantize_pruned_ste`` then ``h @ w + b``).
The ``*_tables`` functions compute the same thing from the threshold/id
tables the kernels take; the wrapper in ``ops`` runs them for tensors on
the CPU, and ``chip_smoke.py`` holds the kernels against them on the card.
``fused_backward_emulation`` repeats K3's own order of summation for dw
(``csrc/fused_qat.cu``), so that order can be tested on the CPU and the
kernel's dw checked bit for bit on the card.

``qat_step`` is the population's training step as the step's kernels
compute it, in plain ops: ``ops.qat_step`` runs it for tensors on the CPU,
and its backward is written out, op by op, where the trainer's chain asks
autograd for it.

Shapes carry an explicit leading population axis P (the reference's
``vmap``): x (P, B, C), thr/ids (P, C, T), w (P, C, F), b (P, F).
"""

from __future__ import annotations

import torch
import torch.nn.functional as tnf

from repro_torch.core import adc
from repro_torch.core.sums import fixed_sum
from repro_torch.kernels.pruned_quant.ref import pruned_quantize_ref

__all__ = [
    "fused_qat_ref",
    "dequant_ste_tables",
    "fused_forward_tables",
    "fused_backward_tables",
    "BWD_THREADS",
    "fused_backward_emulation",
    "layer_sizes",
    "qat_step",
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


def layer_sizes(params) -> tuple[int, ...]:
    """The MLP's layer sizes, read from its weights ``w0``, ``w1``, ... (P, in, out)."""
    n = sum(k[0] == "w" for k in params)
    return (params["w0"].shape[-2],) + tuple(params[f"w{i}"].shape[-1] for i in range(n))


# 0-dim CPU constants, as core.qat's: a binary op takes them as scalars
_ZERO = torch.tensor(0.0)
_ONE = torch.tensor(1.0)


def _pow2(w, bits):
    """``core.qat.quantize_pow2``'s forward value, ``w + (q - w)``."""
    e_lo = -torch.exp2(bits - 1.0) + 1.0
    mag = torch.abs(w)
    e = torch.round(torch.log2(torch.clamp(mag, min=1e-12)))
    e = torch.clamp(torch.maximum(e, e_lo), max=0.0)
    q = torch.sign(w) * torch.exp2(e)
    q = torch.where(mag < torch.exp2(e_lo - 1.0), 0.0, q)
    return w + (q - w)


def _hidden_act(u, bits):
    """A hidden layer's activation as ``core.qat.mlp_forward`` computes it:
    relu, ``clip01``, then ``quantize_uniform``'s forward value."""
    x = torch.minimum(torch.maximum(torch.relu(u), _ZERO), _ONE)
    scale = torch.exp2(bits) - 1.0
    q = torch.minimum(torch.maximum(torch.round(x * scale), torch.zeros_like(scale)),
                      scale) / scale
    return x + (q - x)


def _act_backward(u, ga):
    """The hidden activation's gradient at pre-activation ``u`` (csrc
    ``act_backward``): autograd's rules for relu, maximum and minimum."""
    r = torch.relu(u)
    c1 = torch.maximum(r, torch.zeros_like(r))
    d = torch.where(c1 == 1.0, ga / 2, ga).masked_fill(c1 > 1.0, 0.0)
    d = torch.where(r == 0.0, d / 2, d).masked_fill(r < 0.0, 0.0)
    return torch.where(r <= 0.0, 0.0, d)


def _momentum_update(buf, grads: dict, momentum: float, j: int) -> None:
    """``v = momentum * v - lr * g``, ``p += on * v`` for every parameter."""
    P = buf.idx.shape[0]
    with torch.no_grad():
        lr_t, on = buf.lr[:, j], buf.gate[:, j]
        for k, p in buf.params.items():
            shape = (P,) + (1,) * (p.ndim - 1)
            v = buf.vel[k]
            v.copy_(momentum * v - lr_t.view(shape) * grads[k])
            p.add_(on.view(shape) * v)


def qat_step(X_tr, y_tr, buf, j: int, momentum: float,
             first_layer=(fused_forward_tables, fused_backward_tables)) -> None:
    """Training step ``j`` of every row of ``buf`` (``ops.StepBuffers``), in
    place, as the step's kernels compute it (``csrc/fused_qat.cu``), in plain
    ops: the po2 weights, the first layer (``first_layer``: K2's and K3's
    plain versions; ``ops.fused_forward``, ``ops.fused_backward`` to run the
    kernels themselves), the hidden layers, then the backward written out:
    the cross-entropy's gradient ``(dce / total) * exp(l - m)`` less ``dce``
    at the label, each dense layer's dw, db and dh in ``fixed_sum``'s trees,
    the activation's gradient (``_act_backward``), db0 over the batch, dw0
    from K3, and the momentum update.  The trainer's chain of ``core.qat``
    ops and autograd computes the same bits (``tests/test_torch_qat_step.py``).
    """
    fwd, bwd = first_layer
    P = buf.idx.shape[0]
    L = len(layer_sizes(buf.params)) - 1
    it = buf.idx[:, j]
    scale = 1.0 / (buf.thr.shape[-1] + 1)
    with torch.no_grad():
        wq = [_pow2(buf.params[f"w{i}"], buf.wb.view(P, 1, 1)) for i in range(L)]
        x = X_tr[it]
        z = [None, fwd(x, buf.thr, buf.ids, wq[0], buf.params["b0"], scale)]
        a = [None]
        for i in range(1, L):
            a.append(_hidden_act(z[i], buf.ab.view(P, 1, 1)))
            z.append(fixed_sum(a[i].unsqueeze(-1) * wq[i].unsqueeze(1), 2)
                     + buf.params[f"b{i}"].unsqueeze(1))
        logits = z[L]
        K = logits.shape[-1]
        m = logits[..., 0]
        for k in range(1, K):
            m = torch.maximum(m, logits[..., k])
        shifted = logits - m.unsqueeze(-1)
        ex = [torch.exp(shifted[..., k]) for k in range(K)]
        total = ex[0]
        for k in range(1, K):
            total = total + ex[k]
        dce = (torch.ones_like(buf.w) / buf.denom[:, None]) * buf.w
        dtotal = dce / total
        g = torch.stack([dtotal * e for e in ex], -1)
        at_label = torch.arange(K, device=g.device) == y_tr[it].unsqueeze(-1)
        g = torch.where(at_label, g + (-dce).unsqueeze(-1), g)
        grads = {}
        for i in range(L - 1, 0, -1):
            grads[f"w{i}"] = fixed_sum(a[i].unsqueeze(-1) * g.unsqueeze(2), 1)
            grads[f"b{i}"] = fixed_sum(g, 1)
            g = _act_backward(z[i], fixed_sum(g.unsqueeze(2) * wq[i].unsqueeze(1), 3))
        grads["b0"] = fixed_sum(g, 1)
        grads["w0"] = bwd(x, buf.thr, buf.ids, wq[0], g.contiguous(), scale, need_dx=False)[1]
    _momentum_update(buf, grads, momentum, j)
