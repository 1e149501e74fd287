"""Plain PyTorch version of the flash-attention forward (what K4 computes).

The port of the JAX package's oracle ``kernels/flash_attn/ref.py`` behind
the model-layout wrapper of ``kernels/flash_attn/ops.py``: q (B, Sq, Hq, d),
k (B, Sk, Hkv, d), v (B, Sk, Hkv, dv); the GQA group of query head ``h``
reads KV head ``h // G``.  Full fp32 softmax of the scores times ``scale``
(None: d^-1/2), causal mask ``qpos >= kpos`` with no offset, output
(B, Sq, Hq, dv) in q's dtype.  v is as wide as q and k but in latent
attention, whose heads attend at d 192 and give dv 128.

``flash_attention_tc_emulation`` repeats on the CPU the numerics of the
bf16 tensor-core kernel (``csrc/flash_attn_tc.cu``): fp32 scores, the
online softmax over the kernel's key tiles (``tc_key_tile``: 128 keys
where dv <= 128, 64 for dv 160 and 256) in log2 units with the scale fused
into exp2's argument, and P rounded to bf16 before P.V.  It does not flush
exp2's subnormal results to zero as the kernel does: such a probability
adds nothing visible to a row whose max contributes 1.  Only the tests call
it; no path of the port does.
"""

from __future__ import annotations

import torch

__all__ = ["NEG_INF", "flash_attention_ref", "flash_attention_tc_emulation", "tc_key_tile"]

NEG_INF = -1e30


def _keep(Sq: int, Sk: int, window: int | None, device, q_offset: int = 0) -> torch.Tensor:
    """(Sq, Sk) causal mask, and with ``window`` the keys j > i - window only;
    query row r is position r + ``q_offset`` of the keys' axis."""
    qpos = torch.arange(Sq, device=device)[:, None] + q_offset
    kpos = torch.arange(Sk, device=device)[None, :]
    keep = qpos >= kpos
    return keep & (qpos - kpos < window) if window else keep


def flash_attention_ref(q, k, v, causal: bool = True, window: int | None = None,
                        block_q: int = 0, scale: float | None = None) -> torch.Tensor:
    """``window`` (causal only): query i keeps the keys i - window < j <= i.
    ``block_q``: the queries in blocks of that many (0: all at once), each
    block over the keys in its reach only, so that a long windowed sequence
    never holds its (Sq, Sk) scores."""
    if block_q and q.shape[1] > block_q:
        out = q.new_empty(q.shape[:3] + v.shape[3:])
        for s0 in range(0, q.shape[1], block_q):
            s1 = min(s0 + block_q, q.shape[1])
            k0 = max(0, s0 - window + 1) if causal and window else 0
            k1 = s1 if causal else k.shape[1]
            out[:, s0:s1] = _attention(q[:, s0:s1], k[:, k0:k1], v[:, k0:k1], causal, window,
                                       s0 - k0, scale)
        return out
    return _attention(q, k, v, causal, window, 0, scale)


def _attention(q, k, v, causal: bool, window: int | None, q_offset: int,
               scale: float | None = None) -> torch.Tensor:
    d = q.shape[-1]
    G = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).to(torch.float32)                    # (B, Hq, Sq, d)
    kt = k.repeat_interleave(G, dim=2).transpose(1, 2).to(torch.float32)
    vt = v.repeat_interleave(G, dim=2).transpose(1, 2).to(torch.float32)
    s = torch.einsum("bhqd,bhkd->bhqk", qt, kt)
    s = s / (d ** 0.5) if scale is None else s * scale
    if causal:
        s = s.masked_fill(~_keep(s.shape[-2], s.shape[-1], window, q.device, q_offset), NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, vt).transpose(1, 2).to(q.dtype)


def tc_key_tile(d: int, dv: int | None = None) -> int:
    """Keys a tile of the tensor-core kernel at head dims ``d`` (q, k) and
    ``dv`` (v; None: d), its ``Cfg<D, DV>::BK``: O's registers, which dv
    sets, leave room for a 128-key S up to dv 128."""
    return 128 if (dv or d) <= 128 else 64


def flash_attention_tc_emulation(q, k, v, causal: bool = True, block_k: int | None = None,
                                 p_dtype=torch.bfloat16, window: int | None = None,
                                 scale: float | None = None) -> torch.Tensor:
    """The tensor-core K4's arithmetic, tile by tile: s = q.k in fp32, masked
    to -inf; the running max m in log2 units, max(s) times the fp32 scale
    (``scale``, None: d^-1/2) times log2(e); p = exp2(s * scale - m) with
    the product and the difference rounded once, as the kernel's fused
    multiply-add (here in float64, then to fp32); l sums the fp32 p, and P.V
    takes p rounded to ``p_dtype``.  ``block_k`` None: the kernel's tile for
    the head dims (``tc_key_tile``).  With ``window`` every tile runs,
    masked: the kernel skips the tiles wholly outside a row's window, which
    adds p = 0."""
    d = q.shape[-1]
    block_k = block_k or tc_key_tile(d, v.shape[-1])
    G = q.shape[2] // k.shape[2]
    qt = q.transpose(1, 2).to(torch.float32)                    # (B, Hq, Sq, d)
    kt = k.repeat_interleave(G, dim=2).transpose(1, 2).to(torch.float32)
    vt = v.repeat_interleave(G, dim=2).transpose(1, 2).to(torch.float32)
    Sq, Sk = qt.shape[2], kt.shape[2]
    # the host's fp32 scale * log2(e)
    f32 = torch.float32
    scale = 1.0 / d ** 0.5 if scale is None else scale
    scale_log2 = torch.tensor(scale, dtype=f32) * torch.tensor(1.4426950408889634, dtype=f32)
    qpos = torch.arange(Sq)[:, None]
    m = torch.full(qt.shape[:3] + (1,), NEG_INF)
    l = torch.zeros_like(m)
    acc = qt.new_zeros(qt.shape[:3] + vt.shape[3:])
    for k0 in range(0, Sk, block_k):
        kpos = torch.arange(k0, k0 + block_k)[None, :]
        kb = kt[:, :, k0:k0 + block_k]
        s = torch.einsum("bhqd,bhkd->bhqk", qt, kb)
        s = torch.nn.functional.pad(s, (0, block_k - s.shape[-1]), value=-torch.inf)
        valid = kpos < Sk
        if causal:
            valid = valid & (qpos >= kpos)
            if window:
                valid = valid & (qpos - kpos < window)
        s = s.masked_fill(~valid, -torch.inf)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True) * scale_log2)
        p = torch.exp2((s.double() * scale_log2.double() - m_new.double()).float())
        alpha = torch.exp2(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        pv = p[..., :kb.shape[2]].to(p_dtype).to(torch.float32)
        acc = alpha * acc + torch.einsum("bhqk,bhkd->bhqd", pv, vt[:, :, k0:k0 + block_k])
        m = m_new
    return (acc / l.clamp(min=1e-30)).transpose(1, 2).to(q.dtype)
