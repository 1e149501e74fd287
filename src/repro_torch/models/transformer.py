"""Dense / MoE / VLM transformer family (yi, qwen3, command-r, mistral-nemo,
phi3.5-moe, arctic, the internvl2 backbone): serving and training.

The port of the JAX package's ``models/transformer.py``: the same parameter
names, shapes and layouts (layer parameters stacked on a leading
``n_layers`` axis), the same entry points.  What differs, and why:

* **``act_constrain`` at the reference's sites** (``parallel.sharding``):
  inside ``activation_mesh`` it redistributes a DTensor activation to the
  layout of its logical axes, as the reference's sharding constraints do;
  on a plain tensor, and outside a mesh, it returns its input, so one card
  runs exactly as without it.
* **Layers run as a Python loop** over the stacked parameters in place of
  ``lax.scan``.  The serving entry points run under
  ``torch.inference_mode()``; ``loss_fn`` runs with gradients on, and with
  ``cfg.remat`` each layer is recomputed in the backward pass
  (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``).
* **Attention on a CUDA tensor goes to the hand-written kernels when
  serving**: K4 (``kernels/flash_attn``) in ``forward`` and ``prefill``, K5
  (``kernels/decode_attn``) in ``decode_step``.  ``cfg.attention_impl``
  chooses among the plain versions only on the CPU, where ``_choose_attn``
  keeps the reference's meaning ("pallas" takes K4's plain version).
  **Training (``loss_fn``, ``forward(..., train=True)``) takes the plain
  version on every device**, as the reference trains through
  ``_choose_attn``'s plain versions: K4 has no backward, and refuses to
  run under autograd.  ``attend`` and ``decode_attend`` hold this routing
  for whisper and zamba2 too.
* **``decode_step`` writes the new k/v into the cache in place** at
  ``kv_len``, where the reference rebuilds the whole cache with
  ``jnp.where``: the values are identical (a position past the cache is
  written nowhere, as there), and a step does not rewrite the cache (1.6 GB
  for yi-9b at 4 slots x 4096 positions).
* **The VLM patch branch** (``_full_sequence``, so ``forward``, ``prefill``
  and ``loss_fn``) runs the fp32 patch embeddings through the paper's
  ``PrunedQuantFrontend`` (``core/frontend``: K1 on a CUDA tensor; its
  straight-through output passes the gradient as ``stop_gradient`` does),
  casts them to the model's dtype, projects them with ``patch_proj`` and
  puts them before the token embeddings, as the reference does.  RoPE
  positions and the cache run over all P + S positions; decode goes on at
  P + S.
* **MoE** is the reference's capacity-bounded index dispatch, line for
  line: fp32 router, top-k (a stable descending sort, so ties give the
  lower expert first, as ``lax.top_k``), slot positions as an integer
  exclusive cumsum over the flattened (S, K) order of each batch row,
  dropped pairs on the overflow slot ``E*C`` (cut away; the sentinel token
  ``S`` gathers a zero row, so a dropped pair gets no gradient), the
  expert products as ``torch.matmul`` over the expert axis, the combine in
  the model's dtype; the gradient reaches the router through the gates and
  the experts through the gathers.  The capacity
  ``C = max(int(cf * S * K / E), 1)`` depends on S, so a prefill drops pairs
  that one-token decode steps keep, as in the reference.  Arctic's dense
  residual MLP is ``cfg.moe_dense_residual``.  ``init_params`` draws the
  expert tensors a layer at a time (phi3.5-moe's ``we_gate`` alone would
  be 40 GB drawn whole in fp32).
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import spans
from repro_torch.core.frontend import FrontendConfig, PrunedQuantFrontend
from repro_torch.kernels.decode_attn import ops as decode_ops
from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import local as local_ops
from repro_torch.parallel.sharding import (
    act_constrain,
    act_reshape,
    attn_q_axes,
    is_dtensor,
    lm_act_axes,
    moe_stationary,
)

__all__ = [
    "DTYPES",
    "param_specs",
    "init_params",
    "forward",
    "loss_fn",
    "prefill",
    "decode_step",
    "cache_specs",
    "attend",
    "decode_attend",
    "cache_write",
    "StateWriter",
    "normal_init",
]

Specs = dict[str, tuple[tuple[int, ...], tuple[str | None, ...], str]]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

def param_specs(cfg: ModelConfig) -> Specs:
    d, hd, nl = cfg.d_model, cfg.hd, cfg.n_layers
    Hq, Hkv, V = cfg.n_heads, cfg.n_kv_heads, cfg.padded_vocab
    dt = cfg.dtype
    s: Specs = {
        "embed": ((V, d), ("vocab", "embed"), dt),
        "final_norm": ((d,), (None,), dt),
        "ln1": ((nl, d), (None, None), dt),
        "ln2": ((nl, d), (None, None), dt),
        "wq": ((nl, d, Hq * hd), (None, "embed", "heads"), dt),
        "wk": ((nl, d, Hkv * hd), (None, "embed", "kv_heads"), dt),
        "wv": ((nl, d, Hkv * hd), (None, "embed", "kv_heads"), dt),
        "wo": ((nl, Hq * hd, d), (None, "heads", "embed"), dt),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = ((d, V), ("embed", "vocab"), dt)
    if cfg.qk_norm:
        s["q_norm"] = ((nl, hd), (None, None), dt)
        s["k_norm"] = ((nl, hd), (None, None), dt)
    if cfg.family == "moe":
        eff = cfg.expert_d_ff or cfg.d_ff
        s["router"] = ((nl, d, cfg.n_experts), (None, "embed", None), "float32")
        e_in = (None, "experts", "expert_embed", "expert_ffn")
        e_out = (None, "experts", "expert_ffn", "expert_embed")
        s["we_gate"] = ((nl, cfg.n_experts, d, eff), e_in, dt)
        s["we_up"] = ((nl, cfg.n_experts, d, eff), e_in, dt)
        s["we_down"] = ((nl, cfg.n_experts, eff, d), e_out, dt)
        if cfg.moe_dense_residual:
            s["w_gate"] = ((nl, d, cfg.d_ff), (None, "embed", "ffn"), dt)
            s["w_up"] = ((nl, d, cfg.d_ff), (None, "embed", "ffn"), dt)
            s["w_down"] = ((nl, cfg.d_ff, d), (None, "ffn", "embed"), dt)
    else:
        s["w_gate"] = ((nl, d, cfg.d_ff), (None, "embed", "ffn"), dt)
        s["w_up"] = ((nl, d, cfg.d_ff), (None, "embed", "ffn"), dt)
        s["w_down"] = ((nl, cfg.d_ff, d), (None, "ffn", "embed"), dt)
    if cfg.family == "vlm":
        s["patch_proj"] = ((d, d), ("embed", "embed_out"), dt)
    return s


def init_params(gen: torch.Generator, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """Random parameters on ``gen``'s device, as the reference draws them.

    fp32 ``normal / sqrt(fan_in)`` cast to the config's dtype, norms set to
    ones, names in sorted order.  The bits differ from JAX's (another
    generator); parity tests carry the reference's parameters across with
    ``convert.lm_params_from_jax``.  The MoE expert tensors (``we_*``) are
    drawn one layer slice at a time, so the fp32 draw never holds more than
    one layer's experts.
    """
    params = {}
    for name, (shape, _, dtype) in sorted(param_specs(cfg).items()):
        if "norm" in name or name.startswith("ln"):
            params[name] = torch.ones(shape, dtype=DTYPES[dtype], device=gen.device)
        elif name.startswith("we_"):
            out = torch.empty(shape, dtype=DTYPES[dtype], device=gen.device)
            for i in range(shape[0]):
                out[i] = normal_init(gen, shape[1:], dtype)
            params[name] = out
        else:
            params[name] = normal_init(gen, shape, dtype)
    return params


def normal_init(gen: torch.Generator, shape, dtype: str) -> torch.Tensor:
    """fp32 ``normal / sqrt(fan_in)`` on ``gen``'s device, cast to ``dtype``
    (a name of ``DTYPES``); fan_in is the second-to-last dim (the last for
    a vector)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return w.div_(math.sqrt(fan_in)).to(DTYPES[dtype])


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def attend(q, k, v, causal: bool, plain=L.plain_attention, train: bool = False):
    """Full-sequence attention: K4 on a CUDA tensor; on the CPU, or with
    ``train`` on any device, ``plain``, the plain version the reference's
    model picks (and trains through); on a DTensor, the same choice on
    each device's shards (``parallel.local``)."""
    if is_dtensor(q):
        return local_ops.attention(plain, q, k, v, causal, train)
    if q.is_cuda and not train:
        return flash_ops.flash_attention(q, k, v, causal=causal)
    return plain(q, k, v, causal=causal)


def decode_attend(q, k_cache, v_cache, kv_len):
    """One-token attention: K5 on CUDA, the reference's jnp twin on the CPU;
    on a DTensor, the same choice on each device's shards."""
    if is_dtensor(q):
        return local_ops.decode_attention(q, k_cache, v_cache, kv_len)
    if q.is_cuda:
        return decode_ops.decode_attention(q, k_cache, v_cache, kv_len)
    return L.decode_attention_plain(q, k_cache, v_cache, kv_len)


def _attention_block(x, lp, cfg: ModelConfig, rope, plain, train: bool):
    """x: (B, S, d); lp: one layer's params (leading axis stripped); rope:
    ``layers.rope_angles`` of the positions."""
    B, S, d = x.shape
    hd, Hq, Hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    h = L.rms_norm(x, lp["ln1"])
    kv_axes = ("batch", None, "kv_heads", None)
    q = act_reshape(L.dense(h, lp["wq"]), (B, S, Hq, hd), attn_q_axes(Hq))
    k = act_reshape(L.dense(h, lp["wk"]), (B, S, Hkv, hd), kv_axes)
    v = act_reshape(L.dense(h, lp["wv"]), (B, S, Hkv, hd), kv_axes)
    if cfg.qk_norm:
        q = L.rms_norm(q, lp["q_norm"])
        k = L.rms_norm(k, lp["k_norm"])
    q = L.rotate(q, *rope)
    k = L.rotate(k, *rope)
    o = attend(q, k, v, True, plain, train)
    o = L.dense(o.reshape(B, S, Hq * hd), lp["wo"])
    return x + act_constrain(o, lm_act_axes(Hq)), (k, v)


def _moe_route(h, lp, cfg: ModelConfig):
    """Top-k routing + capacity assignment. h: (B, S, d).

    Returns (topv (B,S,K) fp32, topi (B,S,K), pos (B,S,K) int32, keep
    (B,S,K) bool, C) where ``pos`` is each (token, k)'s slot within its
    expert queue."""
    B, S, _ = h.shape
    E, K = cfg.n_experts, cfg.top_k
    C = max(int(cfg.capacity_factor * S * K / E), 1)
    logits = torch.matmul(h.to(torch.float32), lp["router"])
    gates = torch.softmax(logits, dim=-1)
    # lax.top_k: descending, the lower index first on ties
    topv, topi = torch.sort(gates, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :K], topi[..., :K]
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    flat = topi.reshape(B, 1, S * K)
    # one-hot laid out (B, E, S*K): the count runs along the last dim
    em = (flat == torch.arange(E, device=h.device)[None, :, None]).to(torch.int32)
    cum = torch.cumsum(em, dim=-1, dtype=torch.int32) - em  # exclusive count per expert
    pos = torch.gather(cum, 1, flat)[:, 0].reshape(B, S, K)
    return topv, topi, pos, pos < C, C


def _moe_dispatch(h, lp, cfg: ModelConfig):
    """Route (B, S, d) tokens and gather each expert's queue: token indices
    are scattered into the (E * C [+1 overflow]) expert queues and the
    activations gathered by index.  Returns (xe (E, B, C, d), slot (B, S*K),
    topv (B, S, K))."""
    B, S, d = h.shape
    E, K = cfg.n_experts, cfg.top_k
    topv, topi, pos, keep, C = _moe_route(h, lp, cfg)
    slot = torch.where(keep, topi * C + pos, E * C).reshape(B, S * K)  # dropped -> overflow
    tok_of_slot = torch.full((B, E * C + 1), S, dtype=torch.int64, device=h.device)
    token_ids = (torch.arange(S * K, device=h.device) // K).expand(B, S * K)
    tok_of_slot.scatter_(1, slot, token_ids)  # the overflow slot's winner is cut away
    h_pad = torch.cat([h, h.new_zeros(B, 1, d)], dim=1)  # sentinel S -> zero row
    idx = tok_of_slot[:, : E * C, None].expand(B, E * C, d)
    xe = torch.gather(h_pad, 1, idx).reshape(B, E, C, d).transpose(0, 1)  # (E,B,C,d)
    return xe, slot, topv


def _moe_combine(y, slot, topv):
    """(E, B, C, d) expert outputs -> (B, S, d): each (token, k)'s output
    gathered by its slot (the overflow slot a zero row) and weighted by its
    gate."""
    E, B, C, d = y.shape
    S, K = topv.shape[1], topv.shape[2]
    yb = y.transpose(0, 1).reshape(B, E * C, d)
    yb = torch.cat([yb, yb.new_zeros(B, 1, d)], dim=1)
    per_k = torch.gather(yb, 1, slot[..., None].expand(B, S * K, d))
    per_k = per_k.reshape(B, S, K, d) * topv[..., None].to(y.dtype)
    return per_k.sum(2)


def _moe_block(h, lp, cfg: ModelConfig):
    """Capacity-bounded top-k MoE over (B, S, d) activations, index dispatch
    (:func:`_moe_dispatch`), the expert products batched over the expert
    axis, each (token, k)'s output gathered back and weighted by its gate
    (:func:`_moe_combine`).  A DTensor step dispatches and combines on each
    batch shard (``parallel.local``)."""
    distributed = is_dtensor(h)
    if distributed:
        xe, slot, topv = local_ops.moe_dispatch(_moe_dispatch, h, lp["router"], cfg)
    else:
        xe, slot, topv = _moe_dispatch(h, lp, cfg)
    E, B, C, d = xe.shape
    if moe_stationary():
        # weights-stationary EP: gather the token batch into the expert
        # compute, keep eff sharded on the weights, partial-sum the down-proj
        xe = act_constrain(xe, ("experts", None, None, None)).reshape(E, B * C, d)
        f_axes = ("experts", None, None, "expert_ffn")
        g = torch.matmul(xe, lp["we_gate"])
        u = torch.matmul(xe, lp["we_up"])
        eff = g.shape[-1]
        g = act_constrain(g.reshape(E, B, C, eff), f_axes).reshape(E, B * C, eff)
        u = act_constrain(u.reshape(E, B, C, eff), f_axes).reshape(E, B * C, eff)
    else:
        xe = act_constrain(xe, ("experts", "batch", None, None))  # all-to-all
        xe = xe.reshape(E, B * C, d)
        g = torch.matmul(xe, lp["we_gate"])
        u = torch.matmul(xe, lp["we_up"])
    y = torch.matmul(F.silu(g) * u, lp["we_down"])  # (E, B*C, d)
    y = act_constrain(y.reshape(E, B, C, d), ("experts", "batch", None, None))
    if distributed:
        out = local_ops.moe_combine(_moe_combine, y, slot, topv)
    else:
        out = _moe_combine(y, slot, topv)
    out = act_constrain(out, lm_act_axes(cfg.n_heads))
    if cfg.moe_dense_residual:
        out = out + L.swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"])
    return out


def _mlp(h, lp, cfg: ModelConfig):
    """SwiGLU, or the MoE block.  h: (B, S, d), or (B, d) for a decode token,
    which the MoE block sees as (B, 1, d), as in the reference."""
    if cfg.family == "moe":
        if h.dim() == 2:
            return _moe_block(h[:, None], lp, cfg)[:, 0]
        return _moe_block(h, lp, cfg)
    return L.swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"])


def _layer(x, lp, cfg: ModelConfig, rope, plain, train: bool = False):
    x = act_constrain(x, lm_act_axes(cfg.n_heads))
    x, kv = _attention_block(x, lp, cfg, rope, plain, train)
    x = x + _mlp(L.rms_norm(x, lp["ln2"]), lp, cfg)
    return act_constrain(x, lm_act_axes(cfg.n_heads)), kv


_LAYER_KEYS = (
    "ln1", "ln2", "wq", "wk", "wv", "wo", "q_norm", "k_norm",
    "router", "we_gate", "we_up", "we_down", "w_gate", "w_up", "w_down",
)


def _split_layer_params(params):
    stacked = {k: v for k, v in params.items() if k in _LAYER_KEYS}
    rest = {k: v for k, v in params.items() if k not in _LAYER_KEYS}
    return stacked, rest


def _layer_params(stacked, i: int):
    return {k: v[i] for k, v in stacked.items()}


def unstack(stacked: dict) -> list[dict]:
    """Every layer's parameter dict, views made by one ``unbind`` a stacked
    tensor: its backward stacks the layers' gradients once, where indexing a
    layer at a time adds a full-size zero gradient per layer."""
    names = list(stacked)
    return [dict(zip(names, views)) for views in zip(*(stacked[n].unbind(0) for n in names))]


def remat(fn, *args, train: bool, cfg: ModelConfig):
    """``fn(*args)``, recomputed in the backward pass when training with
    ``cfg.remat`` (the reference's ``jax.checkpoint`` around a block)."""
    if train and cfg.remat:
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def _choose_attn(cfg: ModelConfig, seq_len: int):
    """The plain version the CPU and training run (serving on a CUDA tensor
    takes K4)."""
    impl = cfg.attention_impl
    if impl == "auto":
        impl = "flash" if seq_len > 8192 else "plain"
    if impl == "pallas":
        return flash_ops.flash_attention
    if impl == "flash":
        return functools.partial(
            L.flash_attention, p_dtype=DTYPES[cfg.flash_p_dtype], block_k=cfg.flash_block_k
        )
    return L.plain_attention


def _head(x, rest, cfg: ModelConfig):
    x = L.rms_norm(x, rest["final_norm"])
    head = rest["embed"].T if cfg.tie_embeddings else rest["lm_head"]
    return L.dense(x, head)


# ---------------------------------------------------------------------------
# forward / prefill (one body) and decode
# ---------------------------------------------------------------------------

# the spans of a full sequence (``repro_torch.spans``): a prefill; its inputs
# (embeddings, the patches through the ADC frontend, RoPE, the cache); each
# decoder layer; the final norm and lm head.  ``decode_step`` records none
SPAN_PREFILL, SPAN_INPUTS = "model.prefill", "model.inputs"
SPAN_LAYER, SPAN_HEAD = "model.layer", "model.head"


def _patches(pe, rest, cfg: ModelConfig, dtype):
    """(B, P, d) fp32 patch embeddings -> projected (B, P, d) in ``dtype``."""
    if cfg.use_pruned_frontend:
        fe = PrunedQuantFrontend(FrontendConfig(cfg.d_model, cfg.frontend_adc_bits))
        pe = fe.to(pe.device)(pe)
    return torch.matmul(pe.to(dtype), rest["patch_proj"])


def _full_sequence(params, tokens, cfg: ModelConfig, patch_embeds, keep_cache: bool,
                   train: bool = False):
    with spans.span(SPAN_INPUTS):
        stacked, rest = _split_layer_params(params)
        x = act_constrain(L.embed(rest["embed"], tokens), lm_act_axes(cfg.n_heads))  # (B,S,d)
        if cfg.family == "vlm" and patch_embeds is not None:
            x = torch.cat([_patches(patch_embeds, rest, cfg, x.dtype), x], dim=1)
        B, S = x.shape[:2]
        rope = L.rope_angles(torch.arange(S, device=x.device), cfg.hd, cfg.rope_theta)
        plain = _choose_attn(cfg, S)
        cache = None
        if keep_cache and not is_dtensor(x):
            shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.hd)
            cache = {n: torch.empty(shape, dtype=x.dtype, device=x.device) for n in ("k", "v")}
        states = StateWriter(cache, keep_cache and cache is None)
        layers = unstack(stacked)
    for i, lp in enumerate(layers):
        # around the call, never inside _layer: a checkpointed recompute records nothing
        with spans.span(SPAN_LAYER):
            x, (k, v) = remat(_layer, x, lp, cfg, rope, plain, train, train=train, cfg=cfg)
            if keep_cache:
                states.put(i, k=k, v=v)
    with spans.span(SPAN_HEAD):
        logit_axes = ("batch", lm_act_axes(cfg.n_heads)[1], "vocab")
        logits = act_constrain(_head(x, rest, cfg), logit_axes)
    return logits, states.done() if keep_cache else None


def forward(params, tokens, cfg: ModelConfig, patch_embeds=None,
            train: bool = False) -> torch.Tensor:
    """Logits (B, P + S, V) of a full sequence; tokens (B, S) integer, and for
    the VLM ``patch_embeds`` (B, P, d) fp32 or None (P = 0).  ``train``:
    plain attention on every device, layers rematted by ``cfg.remat``."""
    return _full_sequence(params, tokens, cfg, patch_embeds, keep_cache=False, train=train)[0]


def loss_fn(params, batch, cfg: ModelConfig) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` ({"tokens", "labels"}, and
    "patch_embeds" for the VLM, whose logits are taken after the patches)."""
    logits = forward(params, batch["tokens"], cfg, batch.get("patch_embeds"), train=True)
    if cfg.family == "vlm" and "patch_embeds" in batch:
        logits = logits[:, batch["patch_embeds"].shape[1]:]
    return L.softmax_cross_entropy(logits, batch["labels"], cfg.vocab_size)


@spans.spanned(SPAN_PREFILL)
def prefill(params, tokens, cfg: ModelConfig, patch_embeds=None):
    """Full-sequence forward that also returns the KV cache.

    Returns (logits (B, P + S, V), cache {k,v: (L, B, P + S, Hkv, hd)}).
    """
    return _full_sequence(params, tokens, cfg, patch_embeds, keep_cache=True)


def decode_step(params, token, cache, kv_len, cfg: ModelConfig):
    """One-token decode against a (L, B, Smax, Hkv, hd) KV cache.

    Args:
      token: (B,) integer current token.
      cache: {"k","v"}: (L, B, Smax, Hkv, hd); position ``kv_len`` is written
        in place.
      kv_len: (B,) int32 current lengths (same for all layers).
    Returns: (logits (B, V), the same cache dict).  A DTensor cache (a plan
    traced on a mesh) is rebuilt as the reference does, by its where-update,
    and returned as a new dict.
    """
    stacked, rest = _split_layer_params(params)
    B = token.shape[0]
    hd, Hq, Hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    Smax = cache["k"].shape[2]
    x = act_constrain(L.embed(rest["embed"], token), ("batch", None))  # (B, d)
    states = StateWriter(cache, is_dtensor(cache["k"]))
    pos = kv_len
    rows = torch.arange(B, device=x.device)
    # the reference's where-update writes nothing for a row at or past Smax
    inside = (pos < Smax)[:, None, None]
    at = pos.clamp(max=Smax - 1)
    attn_len = pos + 1
    cos, sin = L.rope_angles(pos[:, None], hd, cfg.rope_theta)
    for i in range(cfg.n_layers):
        lp = _layer_params(stacked, i)
        x = act_constrain(x, ("batch", None))
        h = L.rms_norm(x, lp["ln1"])
        # the reference constrains none of these; a DTensor must (act_reshape)
        q = act_reshape(torch.matmul(h, lp["wq"]), (B, Hq, hd), ("batch", "heads", None))
        k = act_reshape(torch.matmul(h, lp["wk"]), (B, Hkv, hd), ("batch", "kv_heads", None))
        v = act_reshape(torch.matmul(h, lp["wv"]), (B, Hkv, hd), ("batch", "kv_heads", None))
        if cfg.qk_norm:
            q = L.rms_norm(q, lp["q_norm"])
            k = L.rms_norm(k, lp["k_norm"])
        q = L.rotate(q[:, None], cos, sin)[:, 0]
        k = L.rotate(k[:, None], cos, sin)[:, 0]
        kc, vc = cache_write(cache["k"][i], cache["v"][i], k, v, rows, at, inside, pos)
        if states.stacked:  # a plain cache was written in place
            states.put(i, k=kc, v=vc)
        o = decode_attend(q, kc, vc, attn_len)
        x = x + torch.matmul(o.reshape(B, Hq * hd), lp["wo"])
        x = x + _mlp(L.rms_norm(x, lp["ln2"]), lp, cfg)
    return act_constrain(_head(x, rest, cfg), ("batch", "vocab")), states.done()


def cache_write(kc, vc, k, v, rows, at, inside, pos):
    """One token's k/v (B, Hkv, hd) written into a layer's (B, Smax, Hkv, hd)
    cache at ``pos``, nothing at or past Smax: in place (``rows``, ``at`` the
    clamped position, ``inside`` its mask), or on a DTensor cache by the
    reference's where-update into a new tensor.  Returns the layer's cache."""
    if is_dtensor(kc):
        upd = (torch.arange(kc.shape[1], device=pos.device)[None, :, None, None]
               == pos[:, None, None, None])
        return torch.where(upd, k[:, None], kc), torch.where(upd, v[:, None], vc)
    kc[rows, at] = torch.where(inside, k, kc[rows, at])
    vc[rows, at] = torch.where(inside, v, vc[rows, at])
    return kc, vc


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> Specs:
    hd, Hkv = cfg.hd, cfg.n_kv_heads
    shape = (cfg.n_layers, batch, max_len, Hkv, hd)
    axes = (None, "batch", None, "kv_heads", "head_dim")
    return {"k": (shape, axes, cfg.dtype), "v": (shape, axes, cfg.dtype)}


class StateWriter:
    """The serving state a step writes a layer at a time: in place into
    ``cache``, or (a DTensor step, ``stacked``) collected and stacked, as the
    reference's scan stacks it."""

    def __init__(self, cache, stacked: bool):
        self.cache, self.stacked = cache, stacked
        self.rows: dict[str, list] = {}

    def put(self, i: int, **state) -> None:
        for name, t in state.items():
            if self.stacked:
                self.rows.setdefault(name, []).append(t)
            else:
                self.cache[name][i] = t

    def done(self) -> dict:
        if self.stacked:
            return {name: torch.stack(ts) for name, ts in self.rows.items()}
        return self.cache
