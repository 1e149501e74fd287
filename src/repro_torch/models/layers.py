"""Shared model layers: norms, RoPE, GQA attention (plain + blocked), SwiGLU,
the cross-entropy loss.

The port of the JAX package's ``models/layers.py``: the same functions, the
same layouts ((B, S, H, hd) activations) and the bf16/fp32 casts at the same
places.  These are the plain PyTorch versions; on a CUDA tensor the model
sends attention to the hand-written kernels instead (``kernels/flash_attn``,
``kernels/decode_attn``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.parallel.sharding import is_dtensor

__all__ = [
    "NEG_INF",
    "embed",
    "rms_norm",
    "yarn_mscale",
    "rope_frequencies",
    "rope_angles",
    "rotate",
    "apply_rope",
    "repeat_kv",
    "plain_attention",
    "flash_attention",
    "decode_attention_plain",
    "dense",
    "swiglu",
    "softmax_cross_entropy",
]

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# embedding
# ---------------------------------------------------------------------------

def embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` of ``table`` (the reference's ``jnp.take``): indexing on a
    plain tensor, a vocab-parallel lookup on a DTensor
    (``parallel.local.embedding``)."""
    if is_dtensor(table):
        from repro_torch.parallel import local

        return local.embedding(table, ids)
    return table[ids]


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Variance in fp32, the normalise in x's dtype (as the reference)."""
    var = x.to(torch.float32).square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * scale


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's magnitude scale at a context ``factor``: 0.1 mscale ln(factor)
    + 1, and 1 where the factor does not stretch."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def _yarn_dim(rotations: float, head_dim: int, theta: float, max_pos: int) -> float:
    """The frequency index that turns ``rotations`` times over ``max_pos`` positions."""
    return head_dim * math.log(max_pos / (rotations * 2 * math.pi)) / (2 * math.log(theta))


def rope_frequencies(head_dim: int, theta: float, device=None, scaling=None) -> torch.Tensor:
    """The rotary frequencies; with ``scaling`` (``config.RopeScaling``),
    YaRN's: interpolated (over the factor) below the correction range,
    extrapolated (as without scaling) above it, a linear ramp between."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    if scaling is None:
        return 1.0 / (theta ** exps)
    n = scaling.original_max_position_embeddings
    lo = max(math.floor(_yarn_dim(scaling.beta_fast, head_dim, theta, n)), 0)
    hi = min(math.ceil(_yarn_dim(scaling.beta_slow, head_dim, theta, n)), head_dim - 1)
    ramp = (torch.arange(head_dim // 2, dtype=torch.float32, device=device) - lo) / (
        (hi + 0.001 if hi == lo else hi) - lo)
    keep = 1.0 - ramp.clamp(0, 1)  # the extrapolated share of each frequency
    inter = 1.0 / (scaling.factor * theta ** exps)
    return inter * (1 - keep) + 1.0 / (theta ** exps) * keep


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float, scaling=None):
    """(cos, sin) of the rotary angles, fp32, shaped (..., S, 1, hd/2) for
    ``rotate``; positions broadcastable to (..., S).  A model computes them
    once per call and rotates every layer's q and k with them.  With YaRN's
    ``scaling``, its frequencies, and cos and sin times
    mscale(factor, mscale) / mscale(factor, mscale_all_dim)."""
    freqs = rope_frequencies(head_dim, theta, positions.device, scaling)  # (hd/2,)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    if scaling is not None:
        m = (yarn_mscale(scaling.factor, scaling.mscale)
             / yarn_mscale(scaling.factor, scaling.mscale_all_dim))
        cos, sin = cos * m, sin * m
    return cos[..., None, :], sin[..., None, :]


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate x (..., S, H, hd) by ``rope_angles``; in fp32, cast back."""
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S).  Angles in fp32."""
    return rotate(x, *rope_angles(positions, x.shape[-1], theta))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, Hkv, d) -> (B, S, Hkv*groups, d) for GQA broadcast."""
    if groups == 1:
        return k
    return torch.repeat_interleave(k, groups, dim=2)


def plain_attention(
    q: torch.Tensor,  # (B, Sq, Hq, d)
    k: torch.Tensor,  # (B, Sk, Hkv, d)
    v: torch.Tensor,  # (B, Sk, Hkv, d)
    causal: bool = True,
    q_offset: int = 0,
    window: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Reference O(S^2)-materialising attention, fp32 scores.  ``window``
    (causal only): query i keeps the keys j with i - window < j <= i.
    ``scale``: the scores' (None: d^-1/2); v may be narrower than q/k."""
    B, Sq, Hq, d = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, d)
    scale = 1.0 / (d ** 0.5) if scale is None else scale
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(torch.float32), k.to(torch.float32))
    s = s * scale
    if causal:
        qpos = torch.arange(Sq, device=q.device) + q_offset
        kpos = torch.arange(k.shape[1], device=q.device)
        mask = qpos[:, None] >= kpos[None, :]
        if window:
            mask = mask & (qpos[:, None] - kpos[None, :] < window)
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(torch.float32))
    return o.reshape(B, Sq, Hq, v.shape[-1]).to(q.dtype)


def flash_attention(
    q: torch.Tensor,  # (B, Sq, Hq, d)
    k: torch.Tensor,  # (B, Sk, Hkv, d)
    v: torch.Tensor,  # (B, Sk, Hkv, d)
    causal: bool = True,
    block_k: int = 1024,
    q_offset: int = 0,
    p_dtype: torch.dtype = torch.float32,
    window: int | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Blocked online-softmax attention: the reference's ``lax.scan`` over KV
    blocks as a Python loop.  Never materialises the (Sq, Sk) score matrix.
    ``window`` and ``scale`` as in :func:`plain_attention`."""
    B, Sq, Hq, d = q.shape
    Sk, Hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    G = Hq // Hkv
    k = repeat_kv(k, G)
    v = repeat_kv(v, G)
    pad = (-Sk) % block_k
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    n_blocks = k.shape[1] // block_k
    scale = 1.0 / (d ** 0.5) if scale is None else scale
    qg = (q * scale).transpose(1, 2).to(torch.float32)  # (B, Hq, Sq, d)
    kb = k.reshape(B, n_blocks, block_k, Hq, d).permute(1, 0, 3, 2, 4)
    vb = v.reshape(B, n_blocks, block_k, Hq, dv).permute(1, 0, 3, 2, 4)
    qpos = torch.arange(Sq, device=q.device) + q_offset

    m = torch.full((B, Hq, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    den = torch.zeros((B, Hq, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Hq, Sq, dv), dtype=torch.float32, device=q.device)
    for j in range(n_blocks):
        s = torch.einsum("bhqd,bhkd->bhqk", qg, kb[j].to(torch.float32))
        kpos = j * block_k + torch.arange(block_k, device=q.device)
        valid = (kpos[None, :] < Sk).expand(Sq, block_k)
        if causal:
            valid = valid & (qpos[:, None] >= kpos[None, :])
            if window:
                valid = valid & (qpos[:, None] - kpos[None, :] < window)
        s = s.masked_fill(~valid, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None]).to(p_dtype)
        alpha = torch.exp(m - m_new)
        den = den * alpha + p.to(torch.float32).sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(torch.float32), vb[j].to(p_dtype).to(torch.float32)
        )
        m = m_new
    out = acc / torch.clamp(den[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)


def decode_attention_plain(
    q: torch.Tensor,  # (B, Hq, d) one token
    k_cache: torch.Tensor,  # (B, S, Hkv, d)
    v_cache: torch.Tensor,
    kv_len: torch.Tensor,  # (B,)
) -> torch.Tensor:
    """Serving decode attention: the reference's ``decode_attention_jnp``."""
    B, Hq, d = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, d)
    scale = 1.0 / (d ** 0.5)
    s = torch.einsum(
        "bhgd,bshd->bhgs", qg.to(torch.float32), k_cache.to(torch.float32)
    ) * scale
    mask = torch.arange(S, device=q.device)[None, None, None, :] < kv_len[:, None, None, None]
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p, v_cache.to(torch.float32))
    return o.reshape(B, Hq, d).to(q.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``; a DTensor activation split over its sequence takes
    ``parallel.local.project`` (the weight gathered, as context parallelism
    runs it)."""
    if is_dtensor(x):
        from repro_torch.parallel import local

        if local.splits_sequence(x):
            return local.project(x, w)
    return torch.matmul(x, w)


def swiglu(x, w_gate, w_up, w_down):
    g = dense(x, w_gate)
    u = dense(x, w_up)
    return dense(F.silu(g) * u, w_down)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, vocab: int):
    """Mean next-token CE; logits (..., V), labels (...) integer.  The padding
    columns beyond ``vocab`` are masked to ``NEG_INF`` (they get no
    gradient); the mean is ``sum * fp32(1/n)``, as XLA computes ``jnp.mean``."""
    logits32 = logits.to(torch.float32)
    col = torch.arange(logits.shape[-1], device=logits.device)
    logits32 = logits32.masked_fill(col >= vocab, NEG_INF)
    logz = torch.logsumexp(logits32, dim=-1)
    if not is_dtensor(logits):
        gold = torch.gather(logits32, -1, labels.long()[..., None])[..., 0]
    else:  # a vocab-sharded DTensor: the gold logit by an exact masked sum
        gold = torch.where(col == labels.long()[..., None], logits32, 0.0).sum(-1)
    return (logz - gold).sum() * (1.0 / logz.numel())
