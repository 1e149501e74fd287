"""Plain PyTorch version of flash-decode GQA attention (what K5 computes).

The port of the JAX package's oracle ``kernels/decode_attn/ref.py``, taking
the model's cache layout directly: q (B, Hq, d), caches (B, S, Hkv, d),
kv_len (B,).  Scores and softmax in fp32, positions ``>= kv_len`` masked
out, output in q's dtype.  A row with ``kv_len <= 0`` has every score
masked, and its softmax, like the reference's, is NaN.

``decode_attention_split_emulation`` repeats on the CPU what the kernel does
with the cache split into chunks: a partial (m, l, acc) per chunk in log2
units, an empty partial for a chunk at or past kv_len, and the merge in
split order.  Only the tests call it; no path of the port does.
"""

from __future__ import annotations

import torch

__all__ = ["decode_attention_ref", "decode_attention_split_emulation"]


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


def decode_attention_split_emulation(q, k_cache, v_cache, kv_len, n_split: int,
                                     chunk: int) -> torch.Tensor:
    """K5's split-then-merge in fp32: split s covers positions [s * chunk,
    (s + 1) * chunk) clipped to kv_len; its partial is m (log2 units), l and
    acc; the merge weighs each non-empty partial by 2^(m_s - M).  A row with
    no position (kv_len <= 0) has L = 0 and is NaN (0 / 0), as the kernels'
    merges give it."""
    B, Hq, d = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    scale_log2 = (1.0 / d ** 0.5) * 1.4426950408889634
    qg = q.reshape(B, Hkv, G, d).to(torch.float32)
    kf, vf = k_cache.to(torch.float32), v_cache.to(torch.float32)
    ms, ls, accs = [], [], []
    for s in range(n_split):
        lo = s * chunk
        hi = torch.clamp(kv_len.to(torch.int64), max=min(lo + chunk, S))  # (B,)
        pos = torch.arange(lo, min(lo + chunk, S))
        sc = torch.einsum("bhgd,bshd->bhgs", qg, kf[:, lo:lo + chunk]) * scale_log2
        sc = sc.masked_fill(~(pos[None, :] < hi[:, None])[:, None, None, :], -1e30)
        m = sc.amax(dim=-1, keepdim=True)
        p = torch.exp2(sc - m)
        empty = (hi <= lo)[:, None, None, None]
        ms.append(torch.where(empty, torch.tensor(-1e30), m))
        ls.append(torch.where(empty, torch.tensor(0.0), p.sum(dim=-1, keepdim=True)))
        accs.append(torch.where(empty, torch.tensor(0.0),
                                torch.einsum("bhgs,bshd->bhgd", p, vf[:, lo:lo + chunk])))
    M = torch.stack(ms).amax(dim=0)
    L = torch.zeros_like(M)
    out = torch.zeros(B, Hkv, G, d)
    for m, l, acc in zip(ms, ls, accs):  # split order, as the kernel merges
        w = torch.where(l > 0, torch.exp2(m - M), torch.tensor(0.0))
        L = L + w * l
        out = out + w * acc
    return (out / L).reshape(B, Hq, d).to(q.dtype)
