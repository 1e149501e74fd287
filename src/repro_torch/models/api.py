"""Unified model API of the port: one entry point per family.

``Model`` bundles what the serving driver and the tests need, as the JAX
package's ``models/api.Model`` does:
  * ``param_specs()``     -- {name: (shape, logical_axes, dtype)} (no alloc)
  * ``init_params(gen)``  -- random tensors on the ``torch.Generator``'s device
  * ``loss_fn(params, batch)`` -- scalar train loss (plain attention on
    every device; differentiate it with gradients on)
  * ``prefill / decode_step / cache_specs`` -- serving entry points
    (``prefill`` is None for the audio family, as in the reference)

``init_cache(model, ...)`` zeroes the caches of ``model.cache_specs``.

Every family of the reference is built: dense, MoE and VLM on
``models.transformer``, ssm on ``models.rwkv6`` (whose ``cache_specs``
ignores ``max_len``: the state is O(1) in the sequence, as in the
reference), hybrid on ``models.hybrid``, audio on ``models.whisper``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.models import hybrid, rwkv6, transformer, whisper
from repro_torch.models.config import ModelConfig

__all__ = ["Model", "build_model", "init_cache", "exact_n_params", "exact_n_active_params"]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    param_specs: Callable[[], dict]
    init_params: Callable[[torch.Generator], dict]
    loss_fn: Callable[[dict, dict], torch.Tensor]
    decode_step: Callable[..., Any]
    cache_specs: Callable[..., dict]
    prefill: Callable[..., Any] | None = None


def build_model(cfg: ModelConfig) -> Model:
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        return Model(
            cfg=cfg,
            param_specs=lambda: transformer.param_specs(cfg),
            init_params=lambda gen: transformer.init_params(gen, cfg),
            loss_fn=lambda p, b: transformer.loss_fn(p, b, cfg),
            decode_step=lambda p, t, c, n: transformer.decode_step(p, t, c, n, cfg),
            cache_specs=lambda batch, max_len: transformer.cache_specs(cfg, batch, max_len),
            prefill=lambda p, t, pe=None: transformer.prefill(p, t, cfg, pe),
        )
    if fam == "audio":
        return Model(
            cfg=cfg,
            param_specs=lambda: whisper.param_specs(cfg),
            init_params=lambda gen: whisper.init_params(gen, cfg),
            loss_fn=lambda p, b: whisper.loss_fn(p, b, cfg),
            decode_step=lambda p, t, c, n: whisper.decode_step(p, t, c, n, cfg),
            cache_specs=lambda batch, enc_len: whisper.cache_specs(cfg, batch, enc_len),
        )
    if fam == "ssm":
        return Model(
            cfg=cfg,
            param_specs=lambda: rwkv6.param_specs(cfg),
            init_params=lambda gen: rwkv6.init_params(gen, cfg),
            loss_fn=lambda p, b: rwkv6.loss_fn(p, b, cfg),
            decode_step=lambda p, t, c, n: rwkv6.decode_step(p, t, c, n, cfg),
            cache_specs=lambda batch, max_len: rwkv6.cache_specs(cfg, batch),
            prefill=lambda p, t: rwkv6.prefill(p, t, cfg),
        )
    if fam == "hybrid":
        return Model(
            cfg=cfg,
            param_specs=lambda: hybrid.param_specs(cfg),
            init_params=lambda gen: hybrid.init_params(gen, cfg),
            loss_fn=lambda p, b: hybrid.loss_fn(p, b, cfg),
            decode_step=lambda p, t, c, n: hybrid.decode_step(p, t, c, n, cfg),
            cache_specs=lambda batch, max_len: hybrid.cache_specs(cfg, batch, max_len),
            prefill=lambda p, t: hybrid.prefill(p, t, cfg),
        )
    raise ValueError(f"unknown family {fam}")


def init_cache(model: Model, batch: int, max_len: int, device) -> dict[str, torch.Tensor]:
    """Zeroed caches of ``model.cache_specs(batch, max_len)`` on ``device``
    (for whisper, ``max_len`` is the cross caches' encoder length)."""
    return {
        n: torch.zeros(shape, dtype=transformer.DTYPES[dt], device=device)
        for n, (shape, _, dt) in model.cache_specs(batch, max_len).items()
    }


def exact_n_params(cfg: ModelConfig) -> int:
    """Exact parameter count summed from the param specs (no allocation)."""
    return sum(math.prod(shape) for shape, _, _ in build_model(cfg).param_specs().values())


def exact_n_active_params(cfg: ModelConfig) -> int:
    """Active params per token: MoE expert tensors scaled by top_k/E."""
    total = 0.0
    for name, (shape, _, _) in build_model(cfg).param_specs().items():
        n = math.prod(shape)
        if name.startswith("we_") and cfg.n_experts:
            n *= cfg.top_k / cfg.n_experts
        total += n
    return int(total)
