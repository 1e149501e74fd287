"""Carry the JAX package's parameters across into the port.

The two packages draw different random bits from the same seed (JAX's
threefry vs ``torch.Generator``), so parity tests hand the reference's
initial weights to the port instead.  Arrays arrive as numpy (the tests
convert), which keeps this module free of any JAX import.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import build_model, transformer

__all__ = ["params_from_jax", "lm_params_from_jax"]


def params_from_jax(params: dict[str, np.ndarray], device=None) -> dict[str, torch.Tensor]:
    """``{"w0", "b0", "w1", "b1", ...}`` numpy arrays -> stacked fp32 tensors.

    Arrays that already carry a leading population axis (``w0`` of shape
    ``(P, C, H)``, as ``jax.vmap(qat.init_mlp)`` returns) keep it; a single
    row's dict (``w0`` of shape ``(C, H)``) becomes a population of one.
    """
    dev = resolve_device(device)
    single = np.ndim(params["w0"]) == 2
    out = {}
    for name, a in params.items():
        a = np.array(a, np.float32)  # a writable copy
        if single:
            a = a[None]
        out[name] = torch.as_tensor(a).to(dev).contiguous()
    return out


def lm_params_from_jax(params: dict[str, np.ndarray], cfg, device=None) -> dict[str, torch.Tensor]:
    """A model's parameter dict (numpy) -> the port's tensors in ``cfg.dtype``.

    The names and shapes must be those of the family's ``param_specs``
    (``models.transformer`` for dense, MoE and VLM, ``models.rwkv6`` for
    ssm, ``models.hybrid`` for hybrid, ``models.whisper`` for audio).
    Arrays may arrive in fp32 (a bf16 -> fp32 -> bf16 round trip is exact).
    """
    dev = resolve_device(device)
    specs = build_model(cfg).param_specs()
    if set(params) != set(specs):
        raise ValueError(f"parameter names differ: {sorted(set(params) ^ set(specs))}")
    out = {}
    for name, (shape, _, dtype) in specs.items():
        a = np.array(params[name], np.float32)  # a writable copy
        if a.shape != shape:
            raise ValueError(f"{name} has shape {a.shape}, expected {shape}")
        out[name] = torch.as_tensor(a).to(device=dev, dtype=transformer.DTYPES[dtype])
    return out
