"""Plain PyTorch version of the flash-attention forward (what K4 computes).

The port of the JAX package's oracle ``kernels/flash_attn/ref.py`` behind
the model-layout wrapper of ``kernels/flash_attn/ops.py``: q (B, Sq, Hq, d),
k/v (B, Sk, Hkv, d); the GQA group of query head ``h`` reads KV head
``h // G``.  Full fp32 softmax, causal mask ``qpos >= kpos`` with no offset,
output in q's dtype.
"""

from __future__ import annotations

import torch

__all__ = ["NEG_INF", "flash_attention_ref"]

NEG_INF = -1e30


def flash_attention_ref(q, k, v, causal: bool = True) -> torch.Tensor:
    d = q.shape[-1]
    G = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).to(torch.float32)                    # (B, Hq, Sq, d)
    kt = k.repeat_interleave(G, dim=2).transpose(1, 2).to(torch.float32)
    vt = v.repeat_interleave(G, dim=2).transpose(1, 2).to(torch.float32)
    s = torch.einsum("bhqd,bhkd->bhqk", qt, kt) / (d ** 0.5)
    if causal:
        Sq, Sk = s.shape[-2], s.shape[-1]
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, vt).transpose(1, 2).to(q.dtype)
