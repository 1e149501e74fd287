"""The port's one device rule.

``device=None`` means ``"cuda"``.  A CUDA device that is not available is
an error, never a silent move to the CPU: a caller that wants the CPU (the
tests) asks for it.  On first use of CUDA the fp32 matmul and cuDNN paths
are pinned to full fp32, because the reference computes in fp32 throughout
(``preferred_element_type=jnp.float32``) and TF32 keeps only ~3 digits.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """Return the ``torch.device`` to run on (default ``cuda``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run the plain PyTorch path"
            )
        # full fp32 on the card, matching the reference's fp32 arithmetic
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
