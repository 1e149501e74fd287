"""Multi-head latent attention (DeepSeek-V2/V3's MLA) in the transformer family.

A layer with ``cfg.kv_lora_rank > 0`` attends through this block in place
of the GQA one (``transformer._layer``).  From x (B, S, d), normed by
``ln1``, with H heads, r = ``kv_lora_rank``, n = ``qk_nope_head_dim``,
p = ``qk_rope_head_dim`` and e = ``v_head_dim``:

    q          = RMSNorm(x W_qa) W_qb                    (B, S, H, n + p)
    c, k_pe    = x W_kva, split at r                     a latent of r, one rotary key of p
    c          = RMSNorm(c)
    k_nope, v  = c W_kvb, per head split at n            (B, S, H, n), (B, S, H, e)
    q_pe, k_pe = RoPE(q_pe), RoPE(k_pe)                  k_pe shared by every head
    o          = softmax(scale [q_nope, q_pe] . [k_nope, k_pe]) v, causal
    x          = x + o W_o

The rope dims of q and of ``W_kva``'s output lie in the published
interleaved layout (pairs) and are de-interleaved before the rotation, as
``deepseek_v3``'s modelling code does; the angles are YaRN's where
``cfg.rope_scaling`` is set (``layers.rope_angles``).  The softmax scale is
(n + p)^-1/2 times mscale(factor, mscale_all_dim)^2 (:func:`softmax_scale`).
On a CUDA tensor the attention is K4's bf16 instance at q/k 192 and v 128
with that scale; v is not padded.

The cache of a layer holds c (normed) and k_pe (rotated): r + p values a
token (576 at DeepSeek-V3's widths), as ``c_kv`` (L, B, Smax, 1, r) and
``k_pe`` (L, B, Smax, 1, p), one latent "head" each, written by
``transformer.cache_write`` as a KV cache is.  ``LATENT_BYTES["prefill"]``
counts the bytes prefills write into it.  A decode step attends over the
latent in the absorbed form: W_kvb's key part folded into the query
(q_lat = q_nope W_uk^T, scores q_lat . c + q_pe . k_pe) and its value part
into the output (o = (p . c) W_uv), as plain torch products (fp32 scores
and softmax, as ``layers.decode_attention_plain``).
"""

from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.parallel.sharding import act_constrain, lm_act_axes

__all__ = ["LATENT_BYTES", "reset_latent_bytes", "param_specs", "cache_specs", "softmax_scale",
           "attention_block", "decode_block"]

# bytes of latent cache (c_kv and k_pe) the prefills wrote since the last reset
LATENT_BYTES = {"prefill": 0}


def reset_latent_bytes() -> None:
    LATENT_BYTES["prefill"] = 0


def param_specs(cfg: ModelConfig) -> dict:
    """The attention's weights (in place of wq/wk/wv/wo), and for an expert
    model the router's selection-only bias (fp32, beside ``router``)."""
    d, nl, H, dt = cfg.d_model, cfg.n_layers, cfg.n_heads, cfg.dtype
    r, qr = cfg.kv_lora_rank, cfg.q_lora_rank
    s = {
        "wq_a": ((nl, d, qr), (None, "embed", None), dt),
        "q_a_norm": ((nl, qr), (None, None), dt),
        "wq_b": ((nl, qr, H * cfg.qk_head_dim), (None, None, "heads"), dt),
        "wkv_a": ((nl, d, r + cfg.qk_rope_head_dim), (None, "embed", None), dt),
        "kv_a_norm": ((nl, r), (None, None), dt),
        "wkv_b": ((nl, r, H * (cfg.qk_nope_head_dim + cfg.v_head_dim)), (None, None, "heads"), dt),
        "wo": ((nl, H * cfg.v_head_dim, d), (None, "heads", "embed"), dt),
    }
    if cfg.family == "moe":
        s["router_bias"] = ((nl - cfg.first_dense_layers, cfg.n_experts), (None, None), "float32")
    return s


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """The latent caches: c_kv (L, batch, max_len, 1, r), k_pe (L, batch, max_len, 1, p)."""
    axes = (None, "batch", None, "kv_heads", "head_dim")
    lead = (cfg.n_layers, batch, max_len, 1)
    return {"c_kv": (lead + (cfg.kv_lora_rank,), axes, cfg.dtype),
            "k_pe": (lead + (cfg.qk_rope_head_dim,), axes, cfg.dtype)}


def softmax_scale(cfg: ModelConfig) -> float:
    """(n + p)^-1/2, times YaRN's mscale(factor, mscale_all_dim)^2 where it has one."""
    scale = cfg.qk_head_dim ** -0.5
    y = cfg.rope_scaling
    if y is not None and y.mscale_all_dim:
        scale *= L.yarn_mscale(y.factor, y.mscale_all_dim) ** 2
    return scale


def _deinterleave(t: torch.Tensor) -> torch.Tensor:
    """(..., p) in pairs (x0, y0, x1, y1, ...) -> (x0, x1, ..., y0, y1, ...)."""
    return t.unflatten(-1, (-1, 2)).transpose(-1, -2).flatten(-2)


def _kv_b(lp, cfg: ModelConfig):
    """W_kvb's key and value parts, each (r, H, n) and (r, H, e) views."""
    w = lp["wkv_b"].view(cfg.kv_lora_rank, cfg.n_heads, -1)
    return w[..., :cfg.qk_nope_head_dim], w[..., cfg.qk_nope_head_dim:]


def _latent(h, lp, cfg: ModelConfig, norm, train: bool = False):
    """The query (..., H, n + p) and the normed latent c (..., r) and
    de-interleaved, unrotated rotary key (..., p) of normed inputs h (..., d)."""
    r, eps = cfg.kv_lora_rank, cfg.rms_norm_eps
    q = L.dense(norm(L.dense(h, lp["wq_a"]), lp["q_a_norm"], eps, train), lp["wq_b"])
    q = q.unflatten(-1, (cfg.n_heads, cfg.qk_head_dim))
    ckv = L.dense(h, lp["wkv_a"])
    c = norm(ckv[..., :r].contiguous(), lp["kv_a_norm"], eps, train)
    return q, c, _deinterleave(ckv[..., r:])


def attention_block(x, lp, cfg: ModelConfig, rope, plain, train: bool, norm, attend):
    """x: (B, S, d); lp: one layer's params; rope: ``layers.rope_angles`` of
    the positions at the rope dims; ``norm`` and ``attend``: the
    transformer's (``transformer.norm``, ``transformer.attend``).  Returns
    (x + the attention's output, (c (B, S, 1, r), k_pe (B, S, 1, p))), the
    latent to cache."""
    B, S, _ = x.shape
    H, n = cfg.n_heads, cfg.qk_nope_head_dim
    h = norm(x, lp["ln1"], cfg.rms_norm_eps, train)
    q, c, k_pe = _latent(h, lp, cfg, norm, train)
    q = torch.cat([q[..., :n], L.rotate(_deinterleave(q[..., n:]), *rope)], dim=-1)
    k_pe = L.rotate(k_pe[:, :, None], *rope)  # (B, S, 1, p)
    w_uk, w_uv = _kv_b(lp, cfg)
    k_nope = L.dense(c, w_uk.reshape(cfg.kv_lora_rank, H * n)).view(B, S, H, n)
    v = L.dense(c, w_uv.reshape(cfg.kv_lora_rank, -1)).view(B, S, H, cfg.v_head_dim)
    k = torch.cat([k_nope, k_pe.expand(B, S, H, -1)], dim=-1)
    o = attend(q, k, v, True, plain, train, scale=softmax_scale(cfg))
    o = L.dense(o.reshape(B, S, H * cfg.v_head_dim), lp["wo"])
    return x + act_constrain(o, lm_act_axes(H)), (c[:, :, None], k_pe)


def decode_block(x, lp, cfg: ModelConfig, cache: dict, j: int, rows, at, inside, pos, attn_len,
                 cos, sin, norm, cache_write):
    """One token x (B, d) through layer j's attention, absorbed over its
    latent cache; writes the token's latent at ``pos`` with ``cache_write``
    (``transformer.cache_write``; ``norm``: ``transformer.norm``).  Returns
    the attention's output after W_o, (B, d)."""
    B = x.shape[0]
    H, n, e = cfg.n_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    h = norm(x, lp["ln1"], cfg.rms_norm_eps)
    q, c, k_pe = _latent(h, lp, cfg, norm)  # (B, H, n + p), (B, r), (B, p)
    q_pe = L.rotate(_deinterleave(q[:, None, :, n:]), cos, sin)[:, 0]
    k_pe = L.rotate(k_pe[:, None, None], cos, sin)[:, 0]  # (B, 1, p)
    cc, pc = cache_write(cache["c_kv"][j], cache["k_pe"][j], c[:, None], k_pe, rows, at,
                         inside, pos)  # in place: latent layers take no DTensor
    w_uk, w_uv = _kv_b(lp, cfg)
    f32 = torch.float32
    q_lat = torch.einsum("bhn,rhn->bhr", q[..., :n], w_uk)
    s = (torch.einsum("bhr,bsr->bhs", q_lat.to(f32), cc[:, :, 0].to(f32))
         + torch.einsum("bhp,bsp->bhs", q_pe.to(f32), pc[:, :, 0].to(f32))) * softmax_scale(cfg)
    live = torch.arange(cc.shape[1], device=x.device)[None, None, :] < attn_len[:, None, None]
    p = torch.softmax(s.masked_fill(~live, L.NEG_INF), dim=-1)
    o_lat = torch.einsum("bhs,bsr->bhr", p, cc[:, :, 0].to(f32)).to(x.dtype)
    o = torch.einsum("bhr,rhe->bhe", o_lat, w_uv)
    return torch.matmul(o.reshape(B, H * e), lp["wo"])
