"""PrunedQuantFrontend: the paper's technique as a model frontend (port of
``repro.core.frontend``).

The per-sensor pruned flash ADC applied to any model input made of
continuous channels (ViT patch embeddings, audio frame embeddings), and
``kv_codebook_quantize``, the same nearest-lower-level rule over a
per-channel codebook for serving-time tensors.

Routing of the levels.  The reference's models build
``FrontendConfig(d_model, adc_bits)``, whose ``use_pallas`` is False, so in
JAX the model path takes the searchsorted ``adc.quantize_pruned`` (which
also clips x) and never the Pallas kernel.  Here, as the models send
attention to the hand-written kernels, **a CUDA tensor always takes K1**
(``kernels/pruned_quant``); on the CPU ``use_pallas`` picks K1's plain
version (True) or ``adc.quantize_pruned_ste`` (False).  The two routes give
equal levels for every input, NaN, +-inf, negatives, inputs at or above
vref and inputs exactly on a threshold included (``tests/test_frontend.py``
in the reference, ``tests/test_torch_frontend.py`` here): the clip moves x
only where no comparator's outcome changes.  The output is ``x + (v - x)``
on both routes, as in the reference: not ``v`` bit for bit, and NaN where x
is +-inf.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.core import adc
from repro_torch.kernels.pruned_quant import ops as pq_ops

__all__ = ["FrontendConfig", "PrunedQuantFrontend", "kv_codebook_quantize"]


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    n_channels: int
    adc_bits: int = 4
    vref: float = 1.0
    use_pallas: bool = False  # on the CPU: K1's plain version instead of searchsorted


class PrunedQuantFrontend(nn.Module):
    """Per-channel pruned flash ADCs; the (searched) mask is a buffer."""

    def __init__(self, cfg: FrontendConfig, mask: torch.Tensor | None = None):
        super().__init__()
        self.cfg = cfg
        if mask is None:
            mask = torch.ones((cfg.n_channels, 1 << cfg.adc_bits), dtype=torch.bool)
        self.register_buffer("mask", torch.as_tensor(mask, dtype=torch.bool))

    def levels(self, x: torch.Tensor) -> torch.Tensor:
        """(..., n_channels) int32 level indices: K1 on CUDA."""
        if x.is_cuda or self.cfg.use_pallas:
            return pq_ops.pruned_quantize(x, self.mask, self.cfg.adc_bits, self.cfg.vref)
        return adc.quantize_pruned(x, self.mask, self.cfg.adc_bits, self.cfg.vref)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., n_channels) in [0, vref) -> dequantized STE output."""
        v = adc.levels_to_values(self.levels(x), self.cfg.adc_bits, self.cfg.vref)
        return x + (v - x).detach()

    def kept_levels(self) -> torch.Tensor:
        return self.mask[..., 1:].sum(-1) + 1


def kv_codebook_quantize(
    kv: torch.Tensor, levels: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pruned-level codebook quantization of a KV-cache tensor (plain PyTorch).

    Args:
      kv:     (..., d) values (any real range).
      levels: (d, L) per-channel sorted codebook (the kept levels).
    Returns:
      (codes uint8 (..., d), dequantized (..., d)).  An input falls to the
      next-lower kept level, as in the pruned flash ADC; below the lowest it
      takes the lowest.
    """
    L = levels.shape[-1]
    cnt = torch.sum(kv.unsqueeze(-1) >= levels, dim=-1)
    idx = torch.clamp(cnt - 1, 0, L - 1)
    deq = torch.gather(levels.expand(kv.shape + (L,)), -1, idx.unsqueeze(-1)).squeeze(-1)
    return idx.to(torch.uint8), deq
