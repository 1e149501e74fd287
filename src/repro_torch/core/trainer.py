"""Population QAT inner loop of the ADC-aware GA (port of ``repro.core.trainer``).

The reference evaluates a population as ``jax.vmap`` of one row program
scanned over ``max_steps``.  Here the row program is written out over a
leading population axis P, as a Python loop over the steps:

* heterogeneous batch sizes: every step draws ``max_batch`` samples with
  replacement and weights the loss with ``i < batch_size``;
* heterogeneous epoch budgets: the loop runs ``max_steps`` for every row
  and a row's parameters freeze once its own step budget
  ``min(max(ep * ceil(n / bs) * step_scale, 1), max_steps)`` is spent
  (its momentum velocity keeps updating, as in the reference);
* precisions and learning rate enter the quantizers and the optimiser as
  per-row values.

Randomness is drawn up front by :func:`draw_rows` from a CPU
``torch.Generator`` seeded from ``(cfg.seed, row seed)``, so a row's draw
does not depend on the device or on the other rows.  The step loop
(:func:`make_row_program`) takes those draws as inputs, which lets the
parity tests hand it the reference's own initial weights and minibatch
indices.  A row's result is a function of its own inputs only: every
reduction inside a step is ordered by the row alone (see ``core.qat``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import qat
from repro_torch.device import resolve_device

__all__ = ["EvalConfig", "draw_rows", "make_row_program", "make_population_evaluator"]


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    max_batch: int = 128
    max_steps: int = 600          # step-loop length for every chromosome
    step_scale: float = 1.0       # global shrink factor of the step budgets
    momentum: float = 0.9
    seed: int = 0


def draw_rows(seeds, cfg: EvalConfig, mlp_cfg: qat.MLPConfig, n_train: int):
    """Initial parameters and minibatch indices of each row, on the CPU.

    Returns ``(params0, idx)``: ``params0`` the stacked ``init_mlp``
    dict (leading axis P) and ``idx`` an int64 (P, max_steps, max_batch)
    tensor of training-sample indices, drawn with replacement.
    """
    params, idx = [], []
    for s in np.asarray(seeds, np.int64).reshape(-1):
        gen = torch.Generator().manual_seed((int(cfg.seed) << 32) + int(s))
        params.append(qat.init_mlp(gen, mlp_cfg))
        idx.append(torch.randint(0, n_train, (cfg.max_steps, cfg.max_batch), generator=gen))
    params0 = {k: torch.cat([p[k] for p in params]) for k in params[0]}
    return params0, torch.stack(idx)


def _schedules(bs, ep, lr, n_train: int, cfg: EvalConfig, device):
    """Per-row (P, max_steps) learning rates and parameter-update gates.

    Computed row by row, in fp32 with the reference's op order, so a row's
    schedule does not depend on how many rows share the call.
    """
    t = torch.arange(cfg.max_steps, dtype=torch.float32)
    lrs, gates = [], []
    for b, e, r in zip(bs.tolist(), ep.tolist(), lr.tolist()):
        b32, e32, r32 = (torch.tensor(v, dtype=torch.float32) for v in (b, e, r))
        steps_per_epoch = torch.ceil(n_train / b32)
        budget = torch.clamp(
            torch.clamp(e32 * steps_per_epoch * cfg.step_scale, min=1.0),
            max=float(cfg.max_steps),
        )
        frac = torch.clamp(t / budget, max=1.0)
        lrs.append(r32 * 0.5 * (1.0 + torch.cos(math.pi * frac)))
        gates.append((t < budget).to(torch.float32))
    return torch.stack(lrs).to(device), torch.stack(gates).to(device)


def make_row_program(X_tr, y_tr, X_te, y_te, mlp_cfg: qat.MLPConfig, cfg: EvalConfig,
                     device=None):
    """Returns ``train_rows(masks, wb, ab, bs, ep, lr, params0, idx) -> (acc, params)``.

    ``acc`` is the (P,) fp32 test-set accuracy of each row after its QAT
    run, ``params`` the final stacked parameters.  Per-row inputs are
    leading-axis stacked arrays or tensors: masks (P, C, 2^N) bool, wb/ab
    (P,) fp32 bit widths, bs/ep (P,) int, lr (P,) fp32; ``params0`` and
    ``idx`` come from :func:`draw_rows` (or from the reference, in tests).
    """
    dev = resolve_device(device)
    X_tr = torch.as_tensor(np.asarray(X_tr, np.float32), device=dev)
    y_tr = torch.as_tensor(np.asarray(y_tr, np.int64), device=dev)
    X_te = torch.as_tensor(np.asarray(X_te, np.float32), device=dev)
    y_te = torch.as_tensor(np.asarray(y_te, np.int64), device=dev)
    n_train = X_tr.shape[0]

    def train_rows(masks, wb, ab, bs, ep, lr, params0, idx):
        masks = torch.as_tensor(np.asarray(masks, bool), device=dev)
        P = masks.shape[0]
        wb = torch.as_tensor(np.asarray(wb, np.float32), device=dev)
        ab = torch.as_tensor(np.asarray(ab, np.float32), device=dev)
        bs = torch.as_tensor(np.asarray(bs, np.int64))
        lr_sched, gate = _schedules(
            bs, torch.as_tensor(np.asarray(ep, np.int64)),
            torch.as_tensor(np.asarray(lr, np.float32)), n_train, cfg, dev,
        )
        # loss weights i < bs: rows train on their own batch size
        w = (torch.arange(cfg.max_batch) < bs[:, None]).to(torch.float32).to(dev)
        denom = torch.clamp(w.sum(-1), min=1.0)  # integer-valued: exact in any order
        params = {k: v.detach().to(dev).clone().requires_grad_(True) for k, v in params0.items()}
        vel = {k: torch.zeros_like(v) for k, v in params.items()}
        idx = torch.as_tensor(idx).to(dev)

        for t in range(cfg.max_steps):
            it = idx[:, t]
            logits = qat.mlp_forward(params, X_tr[it], mlp_cfg, masks, wb, ab)
            # each row's loss: sum(w * ce) / max(sum(w), 1); rows add up
            # independently, so one backward gives every row its own gradient
            loss = ((w * qat.cross_entropy(logits, y_tr[it])) / denom[:, None]).sum()
            grads = torch.autograd.grad(loss, list(params.values()))
            with torch.no_grad():
                lr_t, on = lr_sched[:, t], gate[:, t]
                for (k, p), g in zip(params.items(), grads):
                    shape = (P,) + (1,) * (p.ndim - 1)
                    vel[k] = cfg.momentum * vel[k] - lr_t.view(shape) * g
                    p.add_(on.view(shape) * vel[k])

        with torch.no_grad():
            logits = qat.mlp_forward(params, X_te.expand(P, -1, -1), mlp_cfg, masks, wb, ab)
            acc = qat.accuracy(logits, y_te.expand(P, -1))
        return acc, {k: v.detach() for k, v in params.items()}

    return train_rows


def make_population_evaluator(X_tr, y_tr, X_te, y_te, mlp_cfg: qat.MLPConfig,
                              cfg: EvalConfig = EvalConfig(), device=None):
    """Returns ``evaluate(masks, wb, ab, bs, ep, lr, seeds) -> np.ndarray (P,)``.

    The test-set accuracy of each row after QAT, a pure function of the
    row (its training seed arrives as an input, derived upstream from the
    genome bytes), whatever rows share the call.
    """
    train_rows = make_row_program(X_tr, y_tr, X_te, y_te, mlp_cfg, cfg, device)
    n_train = int(np.shape(X_tr)[0])

    def evaluate(masks, wb, ab, bs, ep, lr, seeds):
        params0, idx = draw_rows(seeds, cfg, mlp_cfg, n_train)
        acc, _ = train_rows(masks, wb, ab, bs, ep, lr, params0, idx)
        return acc.cpu().numpy()

    return evaluate
