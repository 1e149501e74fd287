"""Differentiable relaxation of the approximation genome (port of ``repro.core.relaxed``).

Each ADC mask bit is relaxed to a sigmoid gate ``sg(theta / tau)`` and,
per enabled genome axis, the activation selector and the per-layer weight
lowering to softmax mixtures over their discrete choices; the gates and
mixtures train jointly with the MLP by gradient descent while ``tau``
anneals, with linear area proxies added to the loss:

    L = CE + lambda_area * (kept-level fraction + activation scale + accumulator bits)

At the end the genes harden (threshold / argmax) and the result is
re-evaluated with the exact pipeline (``qat.mlp_forward``, the fused
QAT layer; ``area.genome_area_batch``).  ``core.hybrid`` runs the same
descent to warm-start and refine the GA's genomes.

Everything is batched over a leading member axis R (the reference's
``vmap`` over restarts and members): parameters are (R, ...) stacks, and
every member's sums run in a fixed order of its own (``core.sums``,
``qat.dense``), so a member's descent does not depend on the others.
Gradients come from torch autograd; the clips on a gradient path use
``qat.clip01`` (``jnp.clip``'s tie rule).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import area, chromosome, qat
from repro_torch.core.sums import fixed_sum
from repro_torch.device import resolve_device

__all__ = [
    "RelaxedConfig",
    "anneal_tau",
    "relaxed_forward",
    "relaxed_loss",
    "descend",
    "train_relaxed",
    "train_relaxed_genome",
]


@dataclasses.dataclass(frozen=True)
class RelaxedConfig:
    adc_bits: int = 4
    steps: int = 800
    lr: float = 0.05
    mask_lr: float = 2.0
    lambda_area: float = 1.0
    tau_start: float = 2.0
    tau_end: float = 0.2
    seed: int = 0


def anneal_tau(t, steps: int, tau_start: float, tau_end: float) -> torch.Tensor:
    """Temperature at step ``t`` of a ``steps``-step geometric anneal, a 0-dim fp32 CPU tensor.

    Decays from ``tau_start`` at ``t = 0`` to exactly ``tau_end`` at the
    final step ``t = steps - 1``, in fp32 as the reference computes it.
    A 0-dim CPU tensor enters a device op as a scalar.
    """
    if steps <= 1:
        return torch.tensor(tau_end, dtype=torch.float32)
    frac = torch.tensor(t, dtype=torch.float32) / (steps - 1)
    ratio = torch.tensor(tau_end / tau_start, dtype=torch.float32)
    return tau_start * torch.pow(ratio, frac)


def _soft_quantize(x: torch.Tensor, gates: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Differentiable pruned quantizer: a soft comparator bank.

    ``x`` (N, C) inputs shared by the members, ``gates`` (R, C, 2^N - 1).
    Each comparator's sigmoid output is weighted by its gate and adds one
    level step (1/n); exact when gates are 0/1.  The value is the soft
    level, the gradient reaches the gates (STE in x, as the reference).
    """
    n = 1 << n_bits
    thr = torch.arange(1, n, dtype=torch.float32, device=x.device) / n
    fired = torch.sigmoid((x.unsqueeze(-1) - thr) * 200.0)  # (N, C, n-1)
    lvl_vals = torch.arange(1, n, dtype=torch.float32, device=x.device) / n
    inc = torch.cat([lvl_vals[:1], torch.diff(lvl_vals)])  # = 1/n each
    soft = fixed_sum(fired.unsqueeze(0) * gates.unsqueeze(1) * inc, -1)  # (R, N, C)
    return x + (soft - x).detach() + (soft - soft.detach()) * 1.0


def relaxed_forward(params, theta, phi, psi, x, tau, mlp_cfg: qat.MLPConfig, axes=("adc",)):
    """Soft forward pass of R relaxed genomes at temperature ``tau``.

    ``params`` the (R, ...) stacked MLP, ``theta`` (R, C, 2^N - 1) mask
    logits, ``phi`` (R, max(n_layers - 1, 1), len(ACT_APPROX_CHOICES)) and
    ``psi`` (R, n_layers, len(WPREC_CHOICES)) selector logits (ignored, may
    be None, when their axis is off), ``x`` (N, C) shared inputs.  Sigmoid
    gates feed the soft comparator bank; per enabled axis, softmax mixtures
    over :data:`qat.ACT_APPROX_FNS` and the wprec lowerings replace the
    exact activation and weight quantizer.  Returns ``(logits (R, N, K),
    gates, p_act, p_w)``; ``p_act`` / ``p_w`` are None for disabled axes.
    """
    axes = chromosome.normalize_axes(axes)
    has_act = "act" in axes
    has_wprec = "wprec" in axes
    n = 1 << mlp_cfg.adc_bits
    nl = len(mlp_cfg.layer_sizes) - 1
    R = theta.shape[0]
    gates = torch.sigmoid(theta / tau)
    p_act = torch.softmax(phi / tau, dim=-1) if has_act else None
    p_w = torch.softmax(psi / tau, dim=-1) if has_wprec else None
    # the data's clip: no gradient reaches x
    h = _soft_quantize(torch.clamp(x, 0.0, 1.0 - 0.5 / n), gates, mlp_cfg.adc_bits)
    for i in range(nl):
        wi = params[f"w{i}"]
        if has_wprec:
            w = 0
            for c, bits in enumerate(chromosome.WPREC_BITS):
                q = qat.quantize_layer_weights(wi, torch.full((R,), bits, device=wi.device))
                w = w + p_w[:, i, c].view(R, 1, 1) * q
        else:
            w = qat.quantize_pow2(wi, mlp_cfg.weight_bits)
        h = qat.dense(h, w, params[f"b{i}"])
        if i < nl - 1:
            if has_act:
                mix = 0
                for c, fn in enumerate(qat.ACT_APPROX_FNS):
                    mix = mix + p_act[:, i, c].view(R, 1, 1) * fn(h)
                h = mix
            else:
                h = torch.relu(h)
            h = qat.quantize_uniform(qat.clip01(h), mlp_cfg.act_bits)
    return h, gates, p_act, p_w


# accumulator-growth proxy of each wprec choice (area.mlp_genome_cost_batch)
# and its largest value, the normaliser of the wprec area term
_ACC_BITS = tuple(b // 2 if b > 0 else 1.0 for b in chromosome.WPREC_BITS)
_ACC_BITS_MAX = float(max(_ACC_BITS))


def relaxed_loss(params, theta, phi, psi, X, y, tau, lam, mlp_cfg: qat.MLPConfig,
                 axes=("adc",)) -> torch.Tensor:
    """(R,) losses: mean cross-entropy + ``lam`` x the linear area proxies.

    The proxies: the expected kept-level fraction, and per enabled axis the
    mean expected activation-circuit scale and the mean expected
    accumulator bits over their maximum (the reference's objective).
    ``lam`` is a float or an (R,) tensor on the members' device.
    """
    axes = chromosome.normalize_axes(axes)
    logits, gates, p_act, p_w = relaxed_forward(params, theta, phi, psi, X, tau, mlp_cfg, axes)
    R, N = logits.shape[0], logits.shape[1]
    ce = fixed_sum(qat.cross_entropy(logits, y.expand(R, N)), 1) * (1.0 / N)
    a_norm = fixed_sum(gates.reshape(R, -1), 1) / gates[0].numel()
    if p_act is not None:
        scales = torch.tensor(area.ACT_APPROX_AREA_SCALE, dtype=torch.float32,
                              device=theta.device)
        per = fixed_sum(p_act * scales, -1)
        a_norm = a_norm + fixed_sum(per, 1) * (1.0 / per.shape[1])
    if p_w is not None:
        acc = torch.tensor(_ACC_BITS, dtype=torch.float32, device=theta.device)
        per = fixed_sum(p_w * acc, -1)
        a_norm = a_norm + fixed_sum(per, 1) * (1.0 / per.shape[1]) / _ACC_BITS_MAX
    return ce + lam * a_norm


def descend(params, theta, phi, psi, X, y, lam, mlp_cfg: qat.MLPConfig, axes, steps: int,
            lr: float, mask_lr: float, tau_start: float, tau_end: float):
    """``steps`` annealed gradient steps of every member; returns ``(params, traj)``.

    Plain gradient descent: the MLP at ``lr``, the mask and selector logits
    at ``mask_lr``, at ``tau = anneal_tau(t, steps, ...)``.  ``traj`` is
    the list of ``(theta, phi, psi)`` after each step.  Inputs are not
    modified.
    """
    params = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    genes = [t.detach().clone().requires_grad_(True) for t in (theta, phi, psi)]
    leaves = list(params.values()) + genes
    traj = []
    for t in range(steps):
        tau = anneal_tau(t, steps, tau_start, tau_end)
        loss = relaxed_loss(params, *genes, X, y, tau, lam, mlp_cfg, axes).sum()
        # a disabled axis' logits are unused: no gradient, no update
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        with torch.no_grad():
            for j, (p, g) in enumerate(zip(leaves, grads)):
                if g is not None:
                    p.sub_((lr if j < len(params) else mask_lr) * g)
        traj.append(tuple(g.detach().clone() for g in genes))
    return {k: v.detach() for k, v in params.items()}, traj


def init_genes(C: int, n: int, nl: int, R: int = 1):
    """The reference's starting logits: masks at 1, selectors tilted 0.5 toward choice 0."""
    theta = torch.full((R, C, n - 1), 1.0)
    phi = torch.zeros((R, max(nl - 1, 1), len(chromosome.ACT_APPROX_CHOICES)))
    phi[..., 0] = 0.5
    psi = torch.zeros((R, nl, len(chromosome.WPREC_CHOICES)))
    psi[..., 0] = 0.5
    return theta, phi, psi


def _hard_mask(theta: torch.Tensor) -> np.ndarray:
    th = theta.cpu().numpy()
    return np.concatenate([np.ones((th.shape[0], 1), bool), th > 0.0], axis=1)


def train_relaxed(X_tr, y_tr, X_te, y_te, layer_sizes, cfg: RelaxedConfig = RelaxedConfig(),
                  device=None):
    """Returns (hard mask (C, 2^N), test_acc, area_cm2) after annealing the ADC masks."""
    return _train(X_tr, y_tr, X_te, y_te, layer_sizes, cfg, ("adc",), device)


def train_relaxed_genome(X_tr, y_tr, X_te, y_te, layer_sizes,
                         cfg: RelaxedConfig = RelaxedConfig(),
                         axes: tuple[str, ...] = ("adc", "act", "wprec"), device=None):
    """Differentiable relaxation of the full approximation genome.

    Like :func:`train_relaxed`, jointly annealing per enabled axis the
    activation mixture and the weight-lowering mixture.  Returns ``{"mask",
    "act_sel", "wprec", "acc", "area_cm2"}`` with the hardened genes
    re-evaluated by the exact pipeline; ``act_sel`` / ``wprec`` are None
    for disabled axes.
    """
    return _train(X_tr, y_tr, X_te, y_te, layer_sizes, cfg, axes, device, genome=True)


def _train(X_tr, y_tr, X_te, y_te, layer_sizes, cfg: RelaxedConfig, axes, device,
           genome: bool = False):
    """The MLP drawn from ``cfg.seed`` (a CPU generator), descended, hardened, re-evaluated."""
    axes = chromosome.normalize_axes(axes)
    dev = resolve_device(device)
    n = 1 << cfg.adc_bits
    C = int(np.asarray(X_tr).shape[1])
    nl = len(layer_sizes) - 1
    mlp_cfg = qat.MLPConfig(tuple(layer_sizes), adc_bits=cfg.adc_bits)
    params0 = {k: v.to(dev) for k, v in qat.init_mlp(
        torch.Generator().manual_seed(int(cfg.seed)), mlp_cfg).items()}
    theta, phi, psi = (t.to(dev) for t in init_genes(C, n, nl))
    X = torch.as_tensor(np.asarray(X_tr), dtype=torch.float32).to(dev)
    y = torch.as_tensor(np.asarray(y_tr), dtype=torch.int64).to(dev)
    params, traj = descend(params0, theta, phi, psi, X, y, cfg.lambda_area, mlp_cfg, axes,
                           cfg.steps, cfg.lr, cfg.mask_lr, cfg.tau_start, cfg.tau_end)
    if traj:
        theta, phi, psi = traj[-1]
    hard = _hard_mask(theta[0])
    act_sel = wprec = None
    if "act" in axes:
        act_sel = phi[0].argmax(-1).cpu().numpy().astype(np.int32)[: nl - 1]
    if "wprec" in axes:
        wprec = np.asarray(chromosome.WPREC_BITS, np.float32)[psi[0].argmax(-1).cpu().numpy()]
    # exact re-evaluation: the fused QAT layer on the hardened masks
    Xte = torch.as_tensor(np.asarray(X_te), dtype=torch.float32).to(dev)
    yte = torch.as_tensor(np.asarray(y_te), dtype=torch.int64).to(dev)
    with torch.no_grad():
        logits = qat.mlp_forward(
            params, Xte.unsqueeze(0), mlp_cfg, torch.from_numpy(hard).unsqueeze(0).to(dev),
            act_sel=None if act_sel is None else torch.from_numpy(act_sel[None]).to(dev),
            layer_weight_bits=None if wprec is None else torch.from_numpy(wprec[None]).to(dev),
        )
        acc = float(qat.accuracy(logits, yte.unsqueeze(0))[0])
    if not genome:
        return hard, acc, area.adc_cost(hard, cfg.adc_bits)[0]
    a_cm2 = float(area.genome_area_batch(
        hard[None], cfg.adc_bits, list(layer_sizes),
        np.asarray([mlp_cfg.weight_bits], np.float64),
        np.asarray([mlp_cfg.act_bits], np.float64),
        act_sel=None if act_sel is None else act_sel[None],
        wprec=None if wprec is None else wprec[None],
    )[0][0])
    return {"mask": hard, "act_sel": act_sel, "wprec": wprec, "acc": acc, "area_cm2": a_cm2}
