"""Whisper-medium backbone: encoder-decoder transformer, served and trained.

The port of the JAX package's ``models/whisper.py``: the same parameter
names, shapes and layouts (layer parameters stacked on a leading axis), the
same entry points.  The conv/mel frontend is a stub there as here: the
encoder takes precomputed frame embeddings (B, T, d) in [0, 1), which the
paper's ``PrunedQuantFrontend`` digitises when ``cfg.use_pruned_frontend``
(K1 on a CUDA tensor, ``core/frontend``).  Sinusoidal positions on the
encoder, learned positions on the decoder (``max_target_len``), tanh-GELU
MLPs (``jax.nn.gelu``'s default), cross-attention K/V precomputed once for
decode.  What differs from the reference, and why:

* **``act_constrain`` at the reference's sites** (``parallel.sharding``),
  a no-op on plain tensors and outside a mesh; on DTensors the head splits
  go through ``act_reshape``, each block's attention and MLP outputs are
  constrained to ``("batch", None, None)`` as the transformer's attention
  output is (else DTensor may reduce-scatter a partial sum over the
  sequence, which the next product cannot take), and ``decode_step`` takes
  the reference's where-update of the self cache.  Layers run as a Python
  loop; the serving entry points run under ``torch.inference_mode()``
  (``decode_train`` is the teacher-forced full-sequence decoder, used there
  to check the decode steps).
  ``loss_fn`` (``encode`` + ``decode_train`` with ``train``) runs with
  gradients on, each block recomputed in the backward pass with
  ``cfg.remat``; K1 still digitises the frames once, and its
  straight-through output passes the gradient as ``stop_gradient`` does.
* **Attention on a CUDA tensor goes to the hand-written kernels when
  serving**:
  K4 (``kernels/flash_attn``) in ``encode`` (non-causal) and in
  ``decode_train`` (causal self-attention, non-causal cross-attention); K5
  (``kernels/decode_attn``) in ``decode_step``, for self-attention and for
  cross-attention over all Te encoder positions, through
  ``transformer.attend`` and ``transformer.decode_attend``.  On the CPU,
  and in training on every device, the plain versions the reference picks
  run.
* **``decode_step`` writes the new k/v into the self cache in place** at
  ``kv_len``, and nothing at or past ``max_target_len``, as the reference's
  where-update; the decoder position is clamped at ``max_target_len - 1``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.frontend import FrontendConfig, PrunedQuantFrontend
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import DTYPES, Specs, StateWriter, cache_write, remat
from repro_torch.parallel.sharding import act_constrain, act_reshape, is_dtensor

__all__ = [
    "param_specs",
    "init_params",
    "encode",
    "decode_train",
    "loss_fn",
    "cache_specs",
    "build_cross_cache",
    "decode_step",
]

_BLOCK = ("ln1", "wq", "wk", "wv", "wo", "ln2", "w1", "w2")


def param_specs(cfg: ModelConfig) -> Specs:
    d, V, dt = cfg.d_model, cfg.padded_vocab, cfg.dtype
    ne, nd = cfg.encoder_layers, cfg.n_layers
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    hd = d // H
    ff = cfg.d_ff
    s: Specs = {
        "embed": ((V, d), ("vocab", "embed"), dt),
        "pos_dec": ((cfg.max_target_len, d), (None, "embed"), dt),
        "final_norm": ((d,), (None,), dt),
        "enc_final_norm": ((d,), (None,), dt),
        "lm_head": ((d, V), ("embed", "vocab"), dt),
    }

    def attn(prefix, n):
        return {
            f"{prefix}_ln1": ((n, d), (None, None), dt),
            f"{prefix}_wq": ((n, d, H * hd), (None, "embed", "heads"), dt),
            f"{prefix}_wk": ((n, d, Hkv * hd), (None, "embed", "kv_heads"), dt),
            f"{prefix}_wv": ((n, d, Hkv * hd), (None, "embed", "kv_heads"), dt),
            f"{prefix}_wo": ((n, H * hd, d), (None, "heads", "embed"), dt),
            f"{prefix}_ln2": ((n, d), (None, None), dt),
            f"{prefix}_w1": ((n, d, ff), (None, "embed", "ffn"), dt),
            f"{prefix}_w2": ((n, ff, d), (None, "ffn", "embed"), dt),
        }

    s.update(attn("enc", ne))
    s.update(attn("dec", nd))
    # decoder cross-attention
    s.update({
        "x_ln": ((nd, d), (None, None), dt),
        "x_wq": ((nd, d, H * hd), (None, "embed", "heads"), dt),
        "x_wk": ((nd, d, Hkv * hd), (None, "embed", "kv_heads"), dt),
        "x_wv": ((nd, d, Hkv * hd), (None, "embed", "kv_heads"), dt),
        "x_wo": ((nd, H * hd, d), (None, "heads", "embed"), dt),
    })
    return s


def init_params(gen: torch.Generator, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """Random parameters on ``gen``'s device, as the reference draws them.

    Norms ones, ``pos_dec`` 0.02 * normal, the rest fp32
    ``normal / sqrt(fan_in)`` cast to the config's dtype, names in sorted
    order.  The bits differ from JAX's; parity tests carry the reference's
    parameters across with ``convert.lm_params_from_jax``.
    """
    params = {}
    for name, (shape, _, dtype) in sorted(param_specs(cfg).items()):
        if "ln" in name or "norm" in name:
            params[name] = torch.ones(shape, dtype=DTYPES[dtype], device=gen.device)
            continue
        w = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
        if name == "pos_dec":
            w.mul_(0.02)
        else:
            w.div_(math.sqrt(shape[-2] if len(shape) >= 2 else shape[-1]))
        params[name] = w.to(DTYPES[dtype])
        del w
    return params


def _sinusoid(S: int, d: int, dtype, device) -> torch.Tensor:
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(10000.0, 2.0 * dim / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1).to(dtype)


def _mlp(x, w1, w2):
    return torch.matmul(F.gelu(torch.matmul(x, w1), approximate="tanh"), w2)


def _layer(params, prefix: str, i: int, keys=_BLOCK) -> dict[str, torch.Tensor]:
    return {k: params[f"{prefix}_{k}"][i] for k in keys}


def _attend(q, k, v, causal: bool, train: bool = False):
    """Full-sequence attention; on the CPU, or with ``train``, the reference's
    choice (the plain version; the blocked scan for non-causal attention
    over more than 8192 keys)."""
    if not causal and k.shape[1] > 8192:
        return T.attend(q, k, v, causal, L.flash_attention, train)
    return T.attend(q, k, v, causal, train=train)


def _heads(cfg: ModelConfig) -> tuple[int, int, int]:
    return cfg.n_heads, cfg.n_kv_heads, cfg.d_model // cfg.n_heads


_ACT = ("batch", None, None)  # (B, S, d) activations
_Q = ("batch", None, "heads", None)
_KV = ("batch", None, "kv_heads", None)
_Q1 = ("batch", "heads", None)
_KV1 = ("batch", "kv_heads", None)


def _enc_block(x, lp, cfg: ModelConfig, train: bool):
    B, S, _ = x.shape
    H, Hkv, hd = _heads(cfg)
    x = act_constrain(x, ("batch", None, None))
    h = L.rms_norm(x, lp["ln1"])
    q = act_reshape(torch.matmul(h, lp["wq"]), (B, S, H, hd), _Q)
    k = act_reshape(torch.matmul(h, lp["wk"]), (B, S, Hkv, hd), _KV)
    v = act_reshape(torch.matmul(h, lp["wv"]), (B, S, Hkv, hd), _KV)
    o = _attend(q, k, v, causal=False, train=train)
    x = x + act_constrain(torch.matmul(o.reshape(B, S, H * hd), lp["wo"]), _ACT)
    return x + act_constrain(_mlp(L.rms_norm(x, lp["ln2"]), lp["w1"], lp["w2"]), _ACT)


def encode(params, frames, cfg: ModelConfig, train: bool = False) -> torch.Tensor:
    """frames: (B, T, d) fp32 stub embeddings in [0, 1) -> (B, T, d) states
    (``train``: plain attention on every device, blocks rematted by
    ``cfg.remat``)."""
    x = frames
    if cfg.use_pruned_frontend:
        fe = PrunedQuantFrontend(FrontendConfig(cfg.d_model, cfg.frontend_adc_bits))
        x = fe.to(x.device)(x)
    x = act_constrain(x.to(params["embed"].dtype), ("batch", None, None))
    B, T, d = x.shape
    x = x + _sinusoid(T, d, x.dtype, x.device)
    for i in range(cfg.encoder_layers):
        x = remat(_enc_block, x, _layer(params, "enc", i), cfg, train, train=train, cfg=cfg)
    return L.rms_norm(x, params["enc_final_norm"])


def _cross_kv(enc_states, lx, cfg: ModelConfig):
    B, Te, _ = enc_states.shape
    _, Hkv, hd = _heads(cfg)
    k = act_reshape(torch.matmul(enc_states, lx["wk"]), (B, Te, Hkv, hd), _KV)
    v = act_reshape(torch.matmul(enc_states, lx["wv"]), (B, Te, Hkv, hd), _KV)
    return k, v


def _dec_block(x, lp, lx, enc_states, cfg: ModelConfig, train: bool):
    B, S, _ = x.shape
    H, Hkv, hd = _heads(cfg)
    h = L.rms_norm(x, lp["ln1"])
    q = act_reshape(torch.matmul(h, lp["wq"]), (B, S, H, hd), _Q)
    k = act_reshape(torch.matmul(h, lp["wk"]), (B, S, Hkv, hd), _KV)
    v = act_reshape(torch.matmul(h, lp["wv"]), (B, S, Hkv, hd), _KV)
    o = _attend(q, k, v, causal=True, train=train)
    x = x + act_constrain(torch.matmul(o.reshape(B, S, H * hd), lp["wo"]), _ACT)
    # cross-attention
    hc = L.rms_norm(x, lx["ln"])
    qc = act_reshape(torch.matmul(hc, lx["wq"]), (B, S, H, hd), _Q)
    kc, vc = _cross_kv(enc_states, lx, cfg)
    oc = _attend(qc, kc, vc, causal=False, train=train)
    x = x + act_constrain(torch.matmul(oc.reshape(B, S, H * hd), lx["wo"]), _ACT)
    return x + act_constrain(_mlp(L.rms_norm(x, lp["ln2"]), lp["w1"], lp["w2"]), _ACT)


def _pos_dec(params, S: int):
    """The decoder's first S learned positions: a slice, or on a DTensor the
    rows by ``layers.embed`` (a DTensor slice of them has no strategy in some
    torch releases)."""
    if is_dtensor(params["pos_dec"]):
        return L.embed(params["pos_dec"], torch.arange(S, device=params["pos_dec"].device))
    return params["pos_dec"][:S]


def decode_train(params, tokens, enc_states, cfg: ModelConfig,
                 train: bool = False) -> torch.Tensor:
    """Teacher-forced decoder over (B, S <= max_target_len) tokens -> logits
    (B, S, V) (``train``: plain attention on every device, blocks rematted
    by ``cfg.remat``)."""
    S = tokens.shape[1]
    x = act_constrain(L.embed(params["embed"], tokens) + _pos_dec(params, S), _ACT)
    for i in range(cfg.n_layers):
        lp = _layer(params, "dec", i)
        lx = _layer(params, "x", i, ("ln", "wq", "wk", "wv", "wo"))
        x = remat(_dec_block, x, lp, lx, enc_states, cfg, train, train=train, cfg=cfg)
    x = L.rms_norm(x, params["final_norm"])
    return act_constrain(torch.matmul(x, params["lm_head"]), ("batch", None, "vocab"))


def loss_fn(params, batch, cfg: ModelConfig) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` ({"frames", "tokens",
    "labels"}): ``encode`` of the frames, the teacher-forced decoder."""
    enc = encode(params, batch["frames"], cfg, train=True)
    logits = decode_train(params, batch["tokens"], enc, cfg, train=True)
    return L.softmax_cross_entropy(logits, batch["labels"], cfg.vocab_size)


def cache_specs(cfg: ModelConfig, batch: int, enc_len: int) -> Specs:
    """Self caches of ``max_target_len`` positions, cross caches of ``enc_len``
    (the reference's ``whisper.init_cache``, which returns these specs)."""
    _, Hkv, hd = _heads(cfg)
    self_shape = (cfg.n_layers, batch, cfg.max_target_len, Hkv, hd)
    cross_shape = (cfg.n_layers, batch, enc_len, Hkv, hd)
    axes = (None, "batch", None, "kv_heads", "head_dim")
    return {
        "self_k": (self_shape, axes, cfg.dtype),
        "self_v": (self_shape, axes, cfg.dtype),
        "cross_k": (cross_shape, axes, cfg.dtype),
        "cross_v": (cross_shape, axes, cfg.dtype),
    }


def build_cross_cache(params, enc_states, cfg: ModelConfig):
    """Per-layer cross-attention K/V of the encoder states: (ks, vs), each
    (n_layers, B, Te, Hkv, hd)."""
    kvs = [_cross_kv(enc_states, _layer(params, "x", i, ("wk", "wv")), cfg)
           for i in range(cfg.n_layers)]
    return torch.stack([k for k, _ in kvs]), torch.stack([v for _, v in kvs])


def decode_step(params, token, cache, kv_len, cfg: ModelConfig):
    """One decoder token; the cross K/V already in ``cache``.

    Args:
      token: (B,) integer current token.
      cache: {"self_k", "self_v"}: (L, B, max_target_len, Hkv, hd), position
        ``kv_len`` written in place; {"cross_k", "cross_v"}: (L, B, Te, Hkv, hd).
      kv_len: (B,) int32 self-attention lengths.
    Returns: (logits (B, V), the same cache dict).
    """
    B = token.shape[0]
    H, Hkv, hd = _heads(cfg)
    Smax = cache["self_k"].shape[2]
    pos = kv_len
    x = L.embed(params["embed"], token) + L.embed(params["pos_dec"],
                                                  pos.clamp(max=cfg.max_target_len - 1))
    rows = torch.arange(B, device=x.device)
    inside = (pos < Smax)[:, None, None]
    at = pos.clamp(max=Smax - 1)
    attn_len = pos + 1
    Te = cache["cross_k"].shape[2]
    cross_len = torch.full((B,), Te, dtype=torch.int32, device=x.device)
    states = StateWriter(cache, is_dtensor(cache["self_k"]))
    for i in range(cfg.n_layers):
        lp = _layer(params, "dec", i)
        lx = _layer(params, "x", i, ("ln", "wq", "wo"))
        h = L.rms_norm(x, lp["ln1"])
        # the reference constrains none of these; a DTensor must (act_reshape)
        q = act_reshape(torch.matmul(h, lp["wq"]), (B, H, hd), _Q1)
        k = act_reshape(torch.matmul(h, lp["wk"]), (B, Hkv, hd), _KV1)
        v = act_reshape(torch.matmul(h, lp["wv"]), (B, Hkv, hd), _KV1)
        kc, vc = cache_write(cache["self_k"][i], cache["self_v"][i], k, v, rows, at, inside,
                             pos)
        if states.stacked:  # a plain cache was written in place
            states.put(i, self_k=kc, self_v=vc)
        o = T.decode_attend(q, kc, vc, attn_len)
        x = x + torch.matmul(o.reshape(B, H * hd), lp["wo"])
        hc = L.rms_norm(x, lx["ln"])
        qc = act_reshape(torch.matmul(hc, lx["wq"]), (B, H, hd), _Q1)
        oc = T.decode_attend(qc, cache["cross_k"][i], cache["cross_v"][i], cross_len)
        x = x + torch.matmul(oc.reshape(B, H * hd), lx["wo"])
        x = x + _mlp(L.rms_norm(x, lp["ln2"]), lp["w1"], lp["w2"])
    x = L.rms_norm(x, params["final_norm"])
    if states.stacked:
        cache = {**cache, **states.done()}
    return torch.matmul(x, params["lm_head"]), cache
