"""Plain PyTorch version of flash-decode GQA attention (what K5 computes).

The port of the JAX package's oracle ``kernels/decode_attn/ref.py``, taking
the model's cache layout directly: q (B, Hq, d), caches (B, S, Hkv, d),
kv_len (B,).  Scores and softmax in fp32, positions ``>= kv_len`` masked
out, output in q's dtype.
"""

from __future__ import annotations

import torch

__all__ = ["decode_attention_ref"]


def decode_attention_ref(q, k_cache, v_cache, kv_len) -> torch.Tensor:
    B, Hq, d = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, d)
    scale = 1.0 / (d ** 0.5)
    s = torch.einsum(
        "bhgd,bshd->bhgs", qg.to(torch.float32), k_cache.to(torch.float32)
    ) * scale
    mask = torch.arange(S, device=q.device)[None, None, None, :] < kv_len[:, None, None, None]
    s = s.masked_fill(~mask, float("-inf"))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgs,bshd->bhgd", p, v_cache.to(torch.float32))
    return o.reshape(B, Hq, d).to(q.dtype)
