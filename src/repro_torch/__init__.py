"""PyTorch/CUDA port of the ADC-aware printed-MLP co-design system.

A second package beside the JAX reference ``repro``: the same subpackage
layout (``core``, ``kernels``, ``data``, ``configs``, ``models``,
``launch``, ``checkpoint``, ``runtime``), plain PyTorch on tensors with an explicit ``device``, and
hand-written CUDA kernels for Hopper (``sm_90a``) where the reference has
Pallas TPU kernels.  It imports neither ``jax`` nor anything of ``repro``.

Entry points take ``device=None``, which means ``"cuda"``; they raise when
CUDA is absent and never fall back to the CPU on their own.  Pass
``device="cpu"`` to run the plain PyTorch versions of the kernels.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
