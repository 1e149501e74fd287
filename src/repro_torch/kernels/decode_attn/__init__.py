"""Flash-decode GQA attention for one new token (kernel K5)."""

from repro_torch.kernels.decode_attn.ops import decode_attention
