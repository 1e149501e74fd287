"""Optimizer selection, a deployment policy (port of the policy half of
``repro.launch.steps``): AdamW below 100B parameters, Adafactor (factored
second moments, bf16 momentum) above, which is what lets arctic-480b's
optimizer state fit.  The reference's plan and sharding builders
(``build_plan``, ``specs_to_shardings``, ...) come with ``parallel/``."""

from __future__ import annotations

from repro_torch import optim
from repro_torch.models.api import exact_n_params
from repro_torch.models.config import ModelConfig

__all__ = ["ADAFACTOR_THRESHOLD", "choose_optimizer"]

ADAFACTOR_THRESHOLD = 100_000_000_000


def choose_optimizer(cfg: ModelConfig):
    if exact_n_params(cfg) >= ADAFACTOR_THRESHOLD:
        return optim.adafactor(lr=optim.cosine_warmup(1e-4, 200, 10_000))
    return optim.adamw(lr=optim.cosine_warmup(3e-4, 200, 10_000))
