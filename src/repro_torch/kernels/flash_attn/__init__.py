"""Causal flash-attention forward for prefill (kernel K4)."""

from repro_torch.kernels.flash_attn.ops import flash_attention
