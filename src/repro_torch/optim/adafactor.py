"""Adafactor (Shazeer & Stern, 2018), factored second moments (port of
``repro.optim.adafactor``).

For >100B-param configs (arctic-480b), where AdamW's fp32 moments would not
fit: a param of shape (..., n, m) keeps row (..., n) and col (..., m)
statistics instead of (..., n, m), and bf16 momentum; 1-D params keep an
unfactored second moment (col is zeros(1)).  The update is RMS-clipped.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch.optim.adamw import _device, lr_at

__all__ = ["AdafactorState", "adafactor"]


class AdafactorState(NamedTuple):
    step: torch.Tensor
    row: dict  # factored row stats (or the full nu of a 1-D leaf)
    col: dict  # factored col stats (zeros(1) for a 1-D leaf)
    mu: dict   # bf16 momentum


@dataclasses.dataclass(frozen=True)
class adafactor:
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 1e-3
    decay: float = 0.99
    momentum: float = 0.9
    eps: float = 1e-30
    clip_threshold: float = 1.0

    def init(self, params: dict) -> AdafactorState:
        def row_of(p):
            shape = p.shape[:-1] if p.ndim >= 2 else p.shape
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        def col_of(p):
            shape = p.shape[:-2] + p.shape[-1:] if p.ndim >= 2 else (1,)
            return torch.zeros(shape, dtype=torch.float32, device=p.device)

        return AdafactorState(
            step=torch.zeros((), dtype=torch.int32, device=_device(params)),
            row={k: row_of(p) for k, p in params.items()},
            col={k: col_of(p) for k, p in params.items()},
            mu={k: torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device)
                for k, p in params.items()},
        )

    @torch.no_grad()
    def update(self, grads: dict, state: AdafactorState, params: dict):
        step = state.step + 1
        lr_t = lr_at(self.lr, step)
        d = self.decay
        new_p, new_r, new_c, new_m = {}, {}, {}, {}
        for k, p in params.items():
            g32 = grads[k].to(torch.float32)
            g2 = g32.square() + self.eps
            r, c = state.row[k], state.col[k]
            if p.ndim >= 2:
                r = d * r + (1 - d) * g2.mean(dim=-1)
                c = d * c + (1 - d) * g2.mean(dim=-2)
                rc = r / torch.clamp(r.mean(dim=-1, keepdim=True), min=self.eps)
                v = rc[..., None] * c[..., None, :]
            else:
                r = d * r + (1 - d) * g2
                v = r
            u = g32 * torch.rsqrt(torch.clamp(v, min=self.eps))
            # update clipping (RMS <= threshold)
            rms = torch.sqrt(u.square().mean() + self.eps)
            u = u / torch.clamp(rms / self.clip_threshold, min=1.0)
            m32 = self.momentum * state.mu[k].to(torch.float32) + (1 - self.momentum) * u
            new_p[k] = (p.to(torch.float32) - lr_t * m32).to(p.dtype)
            new_r[k], new_c[k], new_m[k] = r, c, m32.to(torch.bfloat16)
        return new_p, AdafactorState(step, new_r, new_c, new_m)
