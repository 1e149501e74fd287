"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions."""

from __future__ import annotations

import torch

__all__ = ["refuse_autograd"]


def refuse_autograd(kernel: str, plain: str, *tensors) -> None:
    """Raise where autograd would record a call of ``kernel``.

    The attention kernels (K4, K5) fill their output through ctypes: it
    carries no graph back to its inputs, so a gradient taken through it
    would skip the attention silently.  The reference refuses too
    (``jax.grad`` through its Pallas kernels raises) and trains through its
    plain versions; ``plain`` names the one to call instead.  Under
    ``torch.no_grad()`` or ``torch.inference_mode()`` nothing is refused.
    """
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel} has no backward: it would drop the gradient of its inputs. "
            f"Differentiate through {plain} instead, or call it under torch.no_grad()"
        )
