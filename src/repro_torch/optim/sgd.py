"""SGD + momentum, velocity in fp32 (port of ``repro.optim.sgd``)."""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch.optim.adamw import _device, lr_at

__all__ = ["SGDState", "sgd_momentum"]


class SGDState(NamedTuple):
    step: torch.Tensor
    velocity: dict


@dataclasses.dataclass(frozen=True)
class sgd_momentum:
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 0.05
    momentum: float = 0.9

    def init(self, params: dict) -> SGDState:
        return SGDState(
            step=torch.zeros((), dtype=torch.int32, device=_device(params)),
            velocity={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                      for k, p in params.items()},
        )

    @torch.no_grad()
    def update(self, grads: dict, state: SGDState, params: dict):
        step = state.step + 1
        lr_t = lr_at(self.lr, step)
        v = {k: self.momentum * state.velocity[k] - lr_t * grads[k].to(torch.float32)
             for k in params}
        new_p = {k: (p.to(torch.float32) + v[k]).to(p.dtype) for k, p in params.items()}
        return new_p, SGDState(step, v)
