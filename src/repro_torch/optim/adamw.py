"""AdamW with fp32 moments of (bf16) parameters, the update in fp32 (port of
``repro.optim.adamw``).

Each update casts ``p`` to fp32, applies ``p - lr * (m_hat / (sqrt(n_hat)
+ eps) + wd * p)`` and casts back; the bias corrections are ``1 - b **
step`` in fp32.  ``torch.optim.AdamW`` keeps its moments in the
parameter's dtype and decays in a separate multiply: another optimizer.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

__all__ = ["AdamWState", "adamw"]


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: dict
    nu: dict


def _device(tree: dict) -> torch.device:
    return next(iter(tree.values())).device


def lr_at(lr, step: torch.Tensor) -> torch.Tensor:
    """A schedule's (or a constant's) fp32 learning rate at ``step``."""
    if callable(lr):
        return lr(step).to(torch.float32)
    return torch.full((), lr, dtype=torch.float32, device=step.device)


@dataclasses.dataclass(frozen=True)
class adamw:
    """Usage: opt = adamw(lr_fn); state = opt.init(params);
    params, state = opt.update(grads, state, params)."""

    lr: Callable[[torch.Tensor], torch.Tensor] | float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01

    def init(self, params: dict) -> AdamWState:
        def zeros():
            return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                    for k, p in params.items()}

        return AdamWState(torch.zeros((), dtype=torch.int32, device=_device(params)),
                          zeros(), zeros())

    @torch.no_grad()
    def update(self, grads: dict, state: AdamWState, params: dict):
        step = state.step + 1
        lr_t = lr_at(self.lr, step)
        b1, b2 = self.b1, self.b2
        bc1 = 1.0 - torch.pow(b1, step.to(torch.float32))
        bc2 = 1.0 - torch.pow(b2, step.to(torch.float32))
        new_params, new_mu, new_nu = {}, {}, {}
        for k, p in params.items():
            g32 = grads[k].to(torch.float32)
            mu = b1 * state.mu[k] + (1 - b1) * g32
            nu = b2 * state.nu[k] + (1 - b2) * g32.square()
            p32 = p.to(torch.float32)
            delta = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps) + self.weight_decay * p32
            new_params[k] = (p32 - lr_t * delta).to(p.dtype)
            new_mu[k], new_nu[k] = mu, nu
        return new_params, AdamWState(step, new_mu, new_nu)
