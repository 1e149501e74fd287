"""Learning-rate schedules as step -> lr callables (port of
``repro.optim.schedule``): a step (an integer tensor, or a number) gives a
0-dim fp32 tensor on the step's device."""

from __future__ import annotations

import math

import torch

__all__ = ["constant", "cosine_warmup"]


def _as_f32(step) -> torch.Tensor:
    if torch.is_tensor(step):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def constant(lr: float):
    return lambda step: torch.full_like(_as_f32(step), lr)


def cosine_warmup(peak_lr: float, warmup_steps: int, total_steps: int, floor: float = 0.0):
    """Linear warmup then cosine decay to ``floor``."""

    def fn(step):
        step = _as_f32(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        decay = floor + (peak_lr - floor) * 0.5 * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup_steps, warm, decay)

    return fn
