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
* **RMS norms on a CUDA tensor go to a hand-written kernel when serving**
  (``kernels/rms_norm``, through :func:`norm`), where ``attend`` takes K4:
  one read and one write a norm, the post-norm residual add in its
  epilogue.  Training, DTensors and the CPU keep ``layers.rms_norm``, as
  the reference has it.
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

Beyond the reference (no twin in the JAX package; k-exaone-236b-a23b):

* **Sliding-window layers** (``cfg.window``, ``cfg.window_pattern``): a
  window layer's query i keeps the keys i - window < j <= i (K4's windowed
  instance on the card); the global layers of such a model apply no RoPE
  (EXAONE 4.0's rule).  Their caches differ: a global layer keeps ``k``/``v`` of
  (B, Smax, Hkv, hd), a window layer a ring ``k_win``/``v_win`` of
  (B, window, Hkv, hd) that position p writes at slot p % window; K5 reads
  ``min(p + 1, window)`` slots of a ring in any order (keys are rotated
  before they are cached).
* **Post-norms** (``cfg.post_norm``): ``ln1``/``ln2`` norm the attention's
  and the MLP's outputs, not their inputs; every norm takes
  ``cfg.rms_norm_eps``.
* **Leading dense layers** (``cfg.first_dense_layers``): ``w_gate``/``w_up``/
  ``w_down`` stack those layers, the MoE tensors the rest.
* **The dropless expert layer** (``cfg.experts_held``): one card's share of
  an expert-parallel layer.  The router (DeepSeek-V3's: sigmoid scores, the
  top-k weights normalised and scaled by ``cfg.routed_scale``) scores all
  ``n_experts``; the card computes every (token, expert) pair that picked
  one of its ``experts_held`` experts, with no capacity and no drop, adds
  the shared experts (``ws_*``) and leaves out what the absent experts
  would add.  The held experts' products are batched over zero-padded
  slabs of one row count, which the groups' sizes set: they reach the host
  once a layer; ``MOE_PAIRS`` counts the pairs.

Beyond the reference (deepseek-v3):

* **Multi-head latent attention** (``cfg.kv_lora_rank``): such a layer
  attends through ``models/mla.py``, K4 at q/k 192 and v 128 with MLA's
  softmax scale, inside the span ``model.mla``; its cache is the latent
  (``c_kv``, ``k_pe``), and a decode step attends over it in the absorbed
  form.  RoPE takes the rope dims (``cfg.rope_dim``) and YaRN's scaling
  (``cfg.rope_scaling``).
* **Group-limited routing** (``cfg.n_group`` > 1) with a selection-only
  bias (``router_bias``): DeepSeek-V3's noaux_tc in the dropless layer.
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
from repro_torch.kernels.rms_norm import ops as norm_ops
from repro_torch.models import layers as L
from repro_torch.models import mla
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
    "norm",
    "cache_write",
    "StateWriter",
    "normal_init",
    "MOE_PAIRS",
    "reset_moe_pairs",
]

Specs = dict[str, tuple[tuple[int, ...], tuple[str | None, ...], str]]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# the dropless expert layer's slabs: rows a multiple of this, so few shapes recur
EXPERT_ROWS = 128

# (token, expert) pairs of the dropless expert layer since the last reset:
# routed to an expert held here (every one computed: the layer has no
# capacity) and routed to one held elsewhere
MOE_PAIRS = {"held": 0, "elsewhere": 0}


def reset_moe_pairs() -> None:
    for k in MOE_PAIRS:
        MOE_PAIRS[k] = 0


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
        nm = nl - cfg.first_dense_layers  # the MoE layers
        E = cfg.experts_held or cfg.n_experts  # the experts held here
        s["router"] = ((nm, d, cfg.n_experts), (None, "embed", None), "float32")
        e_in = (None, "experts", "expert_embed", "expert_ffn")
        e_out = (None, "experts", "expert_ffn", "expert_embed")
        s["we_gate"] = ((nm, E, d, eff), e_in, dt)
        s["we_up"] = ((nm, E, d, eff), e_in, dt)
        s["we_down"] = ((nm, E, eff, d), e_out, dt)
        if cfg.n_shared_experts:
            fs = cfg.n_shared_experts * eff
            s["ws_gate"] = ((nm, d, fs), (None, "embed", "ffn"), dt)
            s["ws_up"] = ((nm, d, fs), (None, "embed", "ffn"), dt)
            s["ws_down"] = ((nm, fs, d), (None, "ffn", "embed"), dt)
        if cfg.moe_dense_residual or cfg.first_dense_layers:
            nw = cfg.first_dense_layers or nl
            s["w_gate"] = ((nw, d, cfg.d_ff), (None, "embed", "ffn"), dt)
            s["w_up"] = ((nw, d, cfg.d_ff), (None, "embed", "ffn"), dt)
            s["w_down"] = ((nw, cfg.d_ff, d), (None, "ffn", "embed"), dt)
    else:
        s["w_gate"] = ((nl, d, cfg.d_ff), (None, "embed", "ffn"), dt)
        s["w_up"] = ((nl, d, cfg.d_ff), (None, "embed", "ffn"), dt)
        s["w_down"] = ((nl, cfg.d_ff, d), (None, "ffn", "embed"), dt)
    if cfg.family == "vlm":
        s["patch_proj"] = ((d, d), ("embed", "embed_out"), dt)
    if cfg.kv_lora_rank:  # latent attention's weights in place of wq/wk/wv/wo
        for name in ("wq", "wk", "wv", "wo"):
            del s[name]
        s.update(mla.param_specs(cfg))
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

def attend(q, k, v, causal: bool, plain=L.plain_attention, train: bool = False,
           window: int | None = None, scale: float | None = None):
    """Full-sequence attention: K4 on a CUDA tensor; on the CPU, or with
    ``train`` on any device, ``plain``, the plain version the reference's
    model picks (and trains through); on a DTensor, the same choice on
    each device's shards (``parallel.local``).  ``window``: a sliding
    window of that many keys; ``scale``: the scores' (None: d^-1/2) (plain
    tensors only)."""
    kw = {"window": window} if window else {}
    if scale is not None:
        kw["scale"] = scale
    if is_dtensor(q):
        if kw:
            raise NotImplementedError("sliding-window or scaled attention on a DTensor")
        return local_ops.attention(plain, q, k, v, causal, train)
    if q.is_cuda and not train:
        return flash_ops.flash_attention(q, k, v, causal=causal, **kw)
    return plain(q, k, v, causal=causal, **kw)


def decode_attend(q, k_cache, v_cache, kv_len):
    """One-token attention: K5 on CUDA, the reference's jnp twin on the CPU;
    on a DTensor, the same choice on each device's shards."""
    if is_dtensor(q):
        return local_ops.decode_attention(q, k_cache, v_cache, kv_len)
    if q.is_cuda:
        return decode_ops.decode_attention(q, k_cache, v_cache, kv_len)
    return L.decode_attention_plain(q, k_cache, v_cache, kv_len)


def norm(x, scale, eps: float, train: bool = False, residual=None, axes=None):
    """``layers.rms_norm(x, scale, eps)``, and ``residual +`` it where given
    (a post-norm site): the kernel (``kernels/rms_norm``) on a plain CUDA
    tensor outside training, as ``attend`` takes K4; otherwise the plain
    norm, then ``residual + act_constrain(norm, axes)`` (``axes`` None: no
    constraint)."""
    if x.is_cuda and not train and not is_dtensor(x):
        return norm_ops.rms_norm(x, scale, eps, residual)
    y = L.rms_norm(x, scale, eps)
    if residual is None:
        return y
    return residual + (act_constrain(y, axes) if axes else y)


def _attention_block(x, lp, cfg: ModelConfig, rope, plain, train: bool, window=None):
    """x: (B, S, d); lp: one layer's params (leading axis stripped); rope:
    ``layers.rope_angles`` of the positions, or None (no positions);
    ``window``: the layer's sliding window, or None."""
    B, S, d = x.shape
    hd, Hq, Hkv, eps = cfg.hd, cfg.n_heads, cfg.n_kv_heads, cfg.rms_norm_eps
    h = x if cfg.post_norm else norm(x, lp["ln1"], eps, train)
    kv_axes = ("batch", None, "kv_heads", None)
    q = act_reshape(L.dense(h, lp["wq"]), (B, S, Hq, hd), attn_q_axes(Hq))
    k = act_reshape(L.dense(h, lp["wk"]), (B, S, Hkv, hd), kv_axes)
    v = act_reshape(L.dense(h, lp["wv"]), (B, S, Hkv, hd), kv_axes)
    if cfg.qk_norm:
        q = norm(q, lp["q_norm"], eps, train)
        k = norm(k, lp["k_norm"], eps, train)
    if rope is not None:
        q = L.rotate(q, *rope)
        k = L.rotate(k, *rope)
    o = attend(q, k, v, True, plain, train, window)
    o = L.dense(o.reshape(B, S, Hq * hd), lp["wo"])
    if cfg.post_norm:
        return norm(o, lp["ln1"], eps, train, residual=x, axes=lm_act_axes(Hq)), (k, v)
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


def _limited_topk(scores, bias, cfg: ModelConfig):
    """DeepSeek-V3's noaux_tc selection over (T, E) sigmoid scores: the
    choice scores + ``bias`` (None: none); with ``cfg.n_group`` > 1 each
    group of E / n_group experts scored by the sum of its two best choice
    scores and the top-k chosen from the best ``topk_group`` groups only.
    Returns the chosen experts' unbiased scores and their indices."""
    choice = scores if bias is None else scores + bias
    if cfg.n_group > 1:
        T_, E = choice.shape
        grouped = choice.view(T_, cfg.n_group, E // cfg.n_group)
        best = grouped.topk(2, dim=-1)[0].sum(-1).topk(cfg.topk_group, dim=-1)[1]
        keep = torch.zeros(grouped.shape[:2], dtype=torch.bool, device=choice.device)
        keep.scatter_(1, best, True)
        choice = grouped.masked_fill(~keep[..., None], float("-inf")).view(T_, E)
    topi = torch.topk(choice, cfg.top_k, dim=-1)[1]
    return scores.gather(1, topi), topi


def _moe_dropless(h, lp, cfg: ModelConfig):
    """One card's share of a dropless expert-parallel layer over (B, S, d)
    activations, DeepSeek-V3's router: sigmoid scores of the fp32 router
    over all ``n_experts``, the top-k of them (chosen by
    :func:`_limited_topk`: group-limited and biased where the config and
    the layer ask)
    normalised over their sum + 1e-20 and scaled by ``routed_scale``; every
    pair that picked one of the experts held here (the first
    ``experts_held``) is computed, weighted in
    fp32 and summed into its token; the shared experts are added in the
    model's dtype.  The absent experts' part is left out.

    The held experts run as three batched products over (held, M, d): each
    expert's pairs in token order from row 0 of its slab, the rest zero, M
    the largest group rounded up to ``EXPERT_ROWS``.  M is the layer's one
    wait for the device."""
    B, S, d = h.shape
    K, H = cfg.top_k, cfg.experts_held
    x = h.reshape(B * S, d)
    logits = torch.matmul(x.to(torch.float32), lp["router"].to(torch.float32))
    topv, topi = _limited_topk(torch.sigmoid(logits), lp.get("router_bias"), cfg)
    w = (topv / (topv.sum(-1, keepdim=True) + 1e-20) * cfg.routed_scale).reshape(-1)
    key = torch.clamp(topi.reshape(-1), max=H)  # H: held elsewhere
    sizes = torch.zeros(H + 1, dtype=torch.int64, device=h.device).index_add_(
        0, key, torch.ones_like(key))
    counts = sizes.tolist()  # on the host: the one synchronisation of the layer
    n_held = sum(counts[:H])
    MOE_PAIRS["held"] += n_held
    MOE_PAIRS["elsewhere"] += counts[H]
    out = torch.zeros((B * S, d), dtype=torch.float32, device=h.device)
    if n_held:
        M = -(-max(counts[:H]) // EXPERT_ROWS) * EXPERT_ROWS
        pairs = torch.argsort(key, stable=True)[:n_held]  # grouped by expert, in token order
        tok, e = pairs // K, key[pairs]
        first = torch.cumsum(sizes, 0) - sizes  # each group's first pair
        row = e * M + torch.arange(n_held, device=h.device) - first[e]
        xe = x.new_zeros((H * M, d)).index_copy_(0, row, x[tok]).view(H, M, d)
        y = torch.bmm(F.silu(torch.bmm(xe, lp["we_gate"])) * torch.bmm(xe, lp["we_up"]),
                      lp["we_down"])
        out.index_add_(0, tok, y.view(H * M, d)[row].to(torch.float32) * w[pairs, None])
    out = out.to(h.dtype)
    if cfg.n_shared_experts:
        out = out + L.swiglu(x, lp["ws_gate"], lp["ws_up"], lp["ws_down"])
    return out.reshape(B, S, d)


def _moe_block(h, lp, cfg: ModelConfig):
    """Capacity-bounded top-k MoE over (B, S, d) activations, index dispatch
    (:func:`_moe_dispatch`), the expert products batched over the expert
    axis, each (token, k)'s output gathered back and weighted by its gate
    (:func:`_moe_combine`).  A DTensor step dispatches and combines on each
    batch shard (``parallel.local``).  With ``cfg.experts_held``, the
    dropless layer (:func:`_moe_dropless`)."""
    if cfg.experts_held:
        return _moe_dropless(h, lp, cfg)
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
    """SwiGLU, or the MoE block (a layer that holds a router).  h: (B, S, d),
    or (B, d) for a decode token, which the MoE block sees as (B, 1, d), as
    in the reference.  The MoE block of a full sequence is a span."""
    if "router" in lp:
        if h.dim() == 2:
            return _moe_block(h[:, None], lp, cfg)[:, 0]
        with spans.span(SPAN_MOE):
            return _moe_block(h, lp, cfg)
    return L.swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"])


def _layer(x, lp, cfg: ModelConfig, rope, plain, train: bool = False, window=None):
    eps = cfg.rms_norm_eps
    x = act_constrain(x, lm_act_axes(cfg.n_heads))
    if cfg.kv_lora_rank:
        with spans.span(SPAN_MLA):
            x, kv = mla.attention_block(x, lp, cfg, rope, plain, train, norm, attend)
    else:
        x, kv = _attention_block(x, lp, cfg, rope, plain, train, window)
    if cfg.post_norm:
        x = norm(_mlp(x, lp, cfg), lp["ln2"], eps, train, residual=x)
    else:
        x = x + _mlp(norm(x, lp["ln2"], eps, train), lp, cfg)
    return act_constrain(x, lm_act_axes(cfg.n_heads)), kv


_DENSE_KEYS = ("w_gate", "w_up", "w_down")
_MOE_KEYS = ("router", "router_bias", "we_gate", "we_up", "we_down", "ws_gate", "ws_up",
             "ws_down")
_MLA_KEYS = ("wq_a", "q_a_norm", "wq_b", "wkv_a", "kv_a_norm", "wkv_b")
_LAYER_KEYS = (("ln1", "ln2", "wq", "wk", "wv", "wo", "q_norm", "k_norm") + _MOE_KEYS + _DENSE_KEYS
               + _MLA_KEYS)


def _split_layer_params(params):
    stacked = {k: v for k, v in params.items() if k in _LAYER_KEYS}
    rest = {k: v for k, v in params.items() if k not in _LAYER_KEYS}
    return stacked, rest


def _first(k: str, cfg: ModelConfig | None) -> tuple[int, int]:
    """The layers [first, end) whose parameter ``k`` is stacked: with
    ``cfg.first_dense_layers`` the dense MLP stacks the leading layers and
    the MoE tensors the others; every other parameter stacks all layers."""
    nd = cfg.first_dense_layers if cfg is not None else 0
    if nd and k in _MOE_KEYS:
        return nd, cfg.n_layers
    if nd and k in _DENSE_KEYS:
        return 0, nd
    return 0, 1 << 30


def _layer_params(stacked, i: int, cfg: ModelConfig | None = None):
    """Layer i's parameters (see :func:`_first`)."""
    if cfg is None or not cfg.first_dense_layers:
        return {k: v[i] for k, v in stacked.items()}
    out = {}
    for k, v in stacked.items():
        a, b = _first(k, cfg)
        if a <= i < b:
            out[k] = v[i - a]
    return out


def _layers(stacked, cfg: ModelConfig) -> list[dict]:
    """Every layer's parameters as :func:`unstack` makes them, views by one
    ``unbind`` a stacked tensor, for stacks that start at another layer too."""
    if not cfg.first_dense_layers:
        return unstack(stacked)
    out = [{} for _ in range(cfg.n_layers)]
    for k, v in stacked.items():
        a = _first(k, cfg)[0]
        for j, view in enumerate(v.unbind(0)):
            out[a + j][k] = view
    return out


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


def _head(x, rest, cfg: ModelConfig, train: bool = False):
    x = norm(x, rest["final_norm"], cfg.rms_norm_eps, train)
    head = rest["embed"].T if cfg.tie_embeddings else rest["lm_head"]
    return L.dense(x, head)


# ---------------------------------------------------------------------------
# forward / prefill (one body) and decode
# ---------------------------------------------------------------------------

# the spans of a full sequence (``repro_torch.spans``): a prefill; its inputs
# (embeddings, the patches through the ADC frontend, RoPE, the cache); each
# decoder layer, and inside it each latent attention block and each MoE
# block; the final norm and lm head.  ``decode_step`` records none
SPAN_PREFILL, SPAN_INPUTS = "model.prefill", "model.inputs"
SPAN_LAYER, SPAN_HEAD, SPAN_MOE = "model.layer", "model.head", "model.moe"
SPAN_MLA = "model.mla"


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
        rope = L.rope_angles(torch.arange(S, device=x.device), cfg.rope_dim, cfg.rope_theta,
                             cfg.rope_scaling)
        plain = _choose_attn(cfg, S)
        if (cfg.window or cfg.kv_lora_rank) and is_dtensor(x):
            raise NotImplementedError("sliding-window or latent attention layers on a DTensor")
        cache = None
        if keep_cache and not is_dtensor(x):
            cache = _prefill_cache(cfg, B, S, x.dtype, x.device)
        states = StateWriter(cache, keep_cache and cache is None)
        layers = _layers(stacked, cfg)
    slot = _cache_slots(cfg)
    for i, lp in enumerate(layers):
        win = cfg.window if cfg.windowed(i) else None
        lrope = rope if win or not cfg.window else None
        # around the call, never inside _layer: a checkpointed recompute records nothing
        with spans.span(SPAN_LAYER):
            x, (k, v) = remat(_layer, x, lp, cfg, lrope, plain, train, win, train=train,
                              cfg=cfg)
            if keep_cache and win:
                _ring_fill(cache["k_win"][slot[i]], k)
                _ring_fill(cache["v_win"][slot[i]], v)
            elif keep_cache and cfg.kv_lora_rank:  # the latent: c_kv and k_pe
                states.put(slot[i], c_kv=k, k_pe=v)
                mla.LATENT_BYTES["prefill"] += k.nbytes + v.nbytes
            elif keep_cache:
                states.put(slot[i], k=k, v=v)
    with spans.span(SPAN_HEAD):
        logit_axes = ("batch", lm_act_axes(cfg.n_heads)[1], "vocab")
        logits = act_constrain(_head(x, rest, cfg, train), logit_axes)
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

    Returns (logits (B, P + S, V), cache {k,v: (L, B, P + S, Hkv, hd)}); with
    a sliding window, k/v hold the global layers and k_win/v_win the window
    layers' rings (L_win, B, window, Hkv, hd), holding the last ``window``
    positions; with latent attention, the latent {c_kv, k_pe} (``mla``).
    """
    return _full_sequence(params, tokens, cfg, patch_embeds, keep_cache=True)


def decode_step(params, token, cache, kv_len, cfg: ModelConfig):
    """One-token decode against a (L, B, Smax, Hkv, hd) KV cache.

    Args:
      token: (B,) integer current token.
      cache: {"k","v"}: (L, B, Smax, Hkv, hd); position ``kv_len`` is written
        in place.  With a sliding window, k/v hold the global layers and
        {"k_win","v_win"} (L_win, B, window, Hkv, hd) the window layers'
        rings, written at ``kv_len % window`` and read over
        ``min(kv_len + 1, window)`` slots.
      kv_len: (B,) int32 current lengths (same for all layers).
    With latent attention the cache is {"c_kv", "k_pe"} (``mla.cache_specs``),
    attended in the absorbed form.
    Returns: (logits (B, V), the same cache dict).  A DTensor cache (a plan
    traced on a mesh) is rebuilt as the reference does, by its where-update,
    and returned as a new dict.
    """
    stacked, rest = _split_layer_params(params)
    B = token.shape[0]
    hd, Hq, Hkv, eps, W = cfg.hd, cfg.n_heads, cfg.n_kv_heads, cfg.rms_norm_eps, cfg.window
    first = cache["c_kv" if cfg.kv_lora_rank else "k"]
    Smax = first.shape[2]
    x = act_constrain(L.embed(rest["embed"], token), ("batch", None))  # (B, d)
    if (W or cfg.kv_lora_rank) and is_dtensor(first):
        raise NotImplementedError("sliding-window or latent attention layers on a DTensor")
    states = StateWriter(cache, is_dtensor(first))
    pos = kv_len
    rows = torch.arange(B, device=x.device)
    # the reference's where-update writes nothing for a row at or past Smax
    inside = (pos < Smax)[:, None, None]
    at = pos.clamp(max=Smax - 1)
    attn_len = pos + 1
    cos, sin = L.rope_angles(pos[:, None], cfg.rope_dim, cfg.rope_theta, cfg.rope_scaling)
    slot = _cache_slots(cfg)
    for i in range(cfg.n_layers):
        lp = _layer_params(stacked, i, cfg)
        win = cfg.windowed(i)
        x = act_constrain(x, ("batch", None))
        if cfg.kv_lora_rank:  # pre-norm layers attending over their latent
            x = x + mla.decode_block(x, lp, cfg, cache, slot[i], rows, at, inside, pos, attn_len,
                                     cos, sin, norm, cache_write)
            x = x + _mlp(norm(x, lp["ln2"], eps), lp, cfg)
            continue
        h = x if cfg.post_norm else norm(x, lp["ln1"], eps)
        # the reference constrains none of these; a DTensor must (act_reshape)
        q = act_reshape(torch.matmul(h, lp["wq"]), (B, Hq, hd), ("batch", "heads", None))
        k = act_reshape(torch.matmul(h, lp["wk"]), (B, Hkv, hd), ("batch", "kv_heads", None))
        v = act_reshape(torch.matmul(h, lp["wv"]), (B, Hkv, hd), ("batch", "kv_heads", None))
        if cfg.qk_norm:
            q = norm(q, lp["q_norm"], eps)
            k = norm(k, lp["k_norm"], eps)
        if win or not W:
            q = L.rotate(q[:, None], cos, sin)[:, 0]
            k = L.rotate(k[:, None], cos, sin)[:, 0]
        if win:
            j = slot[i]
            kc, vc = cache_write(cache["k_win"][j], cache["v_win"][j], k, v, rows, pos % W,
                                 inside, pos)
            o = decode_attend(q, kc, vc, torch.clamp(attn_len, max=W))
        else:
            kc, vc = cache_write(cache["k"][slot[i]], cache["v"][slot[i]], k, v, rows, at,
                                 inside, pos)
            if states.stacked:  # a plain cache was written in place
                states.put(slot[i], k=kc, v=vc)
            o = decode_attend(q, kc, vc, attn_len)
        o = torch.matmul(o.reshape(B, Hq * hd), lp["wo"])
        if cfg.post_norm:
            x = norm(o, lp["ln1"], eps, residual=x)
            x = norm(_mlp(x, lp, cfg), lp["ln2"], eps, residual=x)
        else:
            x = x + o
            x = x + _mlp(norm(x, lp["ln2"], eps), lp, cfg)
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
    """k/v (L, batch, max_len, Hkv, hd); with a sliding window, k/v of the
    global layers and rings k_win/v_win (L_win, batch, window, Hkv, hd);
    with latent attention, the latent c_kv/k_pe (``mla.cache_specs``)."""
    if cfg.kv_lora_rank:
        return mla.cache_specs(cfg, batch, max_len)
    hd, Hkv = cfg.hd, cfg.n_kv_heads
    n_win = sum(map(cfg.windowed, range(cfg.n_layers)))
    shape = (cfg.n_layers - n_win, batch, max_len, Hkv, hd)
    axes = (None, "batch", None, "kv_heads", "head_dim")
    specs = {"k": (shape, axes, cfg.dtype), "v": (shape, axes, cfg.dtype)}
    if cfg.window:
        ring = (n_win, batch, cfg.window, Hkv, hd)
        specs.update(k_win=(ring, axes, cfg.dtype), v_win=(ring, axes, cfg.dtype))
    return specs


def _cache_slots(cfg: ModelConfig) -> list[int]:
    """Each layer's index among the layers of its kind (global or window)."""
    seen = [0, 0]
    out = []
    for i in range(cfg.n_layers):
        w = int(cfg.windowed(i))
        out.append(seen[w])
        seen[w] += 1
    return out


def _prefill_cache(cfg: ModelConfig, B: int, S: int, dtype, device) -> dict:
    """The caches a prefill of S positions fills: ``cache_specs`` at
    max_len S (the rings zeroed: a prompt shorter than the window fills part)."""
    return {n: (torch.zeros if n.endswith("_win") else torch.empty)(
                shape, dtype=dtype, device=device)
            for n, (shape, _, _) in cache_specs(cfg, B, S).items()}


def _ring_fill(ring, t) -> None:
    """A window layer's ring (B, W, Hkv, hd) given the last W positions of
    t (B, S, Hkv, hd), position p at slot p % W."""
    W, S = ring.shape[1], t.shape[1]
    n = min(S, W)
    ring[:, torch.arange(S - n, S, device=t.device) % W] = t[:, S - n:]


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
