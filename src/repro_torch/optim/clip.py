"""Global-norm gradient clipping (port of ``repro.optim.clip``)."""

from __future__ import annotations

import torch

__all__ = ["global_norm", "clip_by_global_norm"]


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the fp32 sum of squares over every leaf, in sorted key order
    (``jax.tree.leaves``' order of a dict)."""
    return torch.sqrt(sum(tree[k].to(torch.float32).square().sum() for k in sorted(tree)))


@torch.no_grad()
def clip_by_global_norm(grads: dict, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, each cast back
    to its own dtype; the norm before clipping)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return {k: (g.to(torch.float32) * scale).to(g.dtype) for k, g in grads.items()}, norm
