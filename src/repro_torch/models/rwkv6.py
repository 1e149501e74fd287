"""RWKV-6 "Finch": attention-free LM with data-dependent decay.

The port of the JAX package's ``models/rwkv6.py``: the same parameter names,
shapes and layouts (layer parameters stacked on a leading ``n_layers``
axis), the same entry points and the same recurrence, per head (dk = dv =
head_dim):

    S_t = diag(w_t) S_{t-1} + k_t (x) v_t
    o_t = r_t . (S_{t-1} + diag(u) k_t (x) v_t)

with w_t = exp(-exp(w0 + tanh(x_w A) B)) and token-shift mixing on every
branch.  Every decay factor is ``exp`` of a sum of log-decays <= 0.  The
two chunked forms of the reference are both here, as two computations of
that recurrence: ``forward`` runs ``_wkv_chunked`` (intra-chunk scores by
the recursive block factorisation, base blocks of <= 8 tokens, the score
tensors in ``cfg.chunk_dtype``), ``prefill`` runs
``_wkv_chunked_with_state`` (the explicit (B, T, T, H, hd) decay tensor,
fp32).  ``decode_step`` applies the recurrence one token at a time against
the carried state.  What differs from the reference, and why:

* **``act_constrain`` at the reference's sites** (``parallel.sharding``),
  a no-op on plain tensors and outside a mesh; a DTensor step runs the WKV
  (both chunked forms and the decode recurrence) on each device's batch
  rows and heads (``parallel.local.heads``) and stacks its serving state
  instead of writing it in place.  Layers run as a Python
  loop, the serving entry points under ``torch.inference_mode()``.
  ``loss_fn`` differentiates the recursive form (``forward``), each layer
  recomputed in the backward pass with ``cfg.remat``
  (``transformer.remat``).
* **Chunks in parallel, the carry alone in sequence.** The reference scans
  chunk by chunk.  Here every chunk's intra-chunk scores, outputs and state
  contribution are computed at once (chunks folded into the batch), and
  only the (B, H, hd, hd) state carry ``S = exp(cum_T) S + contribution``
  runs as a loop over chunks: the same arithmetic for every element, far
  fewer launches.  The explicit form builds its decay tensor a chunk at a
  time (2.1 GB in fp32 at chunk 512, d 2048, B = 1).  The recursive form
  handles every block of one level at once.
* **``decode_step`` writes the states into the cache in place** and returns
  the same dict; ``kv_len`` is unused, as in the reference.
* **No TPU kernel.** The reference computes the WKV scans in plain ``jnp``,
  outside any Pallas kernel, so this module runs none of K1-K5.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (
    DTYPES,
    Specs,
    StateWriter,
    normal_init,
    remat,
    unstack,
)
from repro_torch.parallel import local as local_ops
from repro_torch.parallel.sharding import act_constrain, is_dtensor

__all__ = [
    "param_specs",
    "init_params",
    "forward",
    "loss_fn",
    "prefill",
    "decode_step",
    "cache_specs",
]

_DECAY_RANK = 64
_ACT = ("batch", None, None)  # (B, S, d) activations
_BASE_BLOCK = 8  # intra_scores' explicit base blocks (the reference's ``Tb <= 8``)


def param_specs(cfg: ModelConfig) -> Specs:
    d, nl, V = cfg.d_model, cfg.n_layers, cfg.padded_vocab
    ff = cfg.d_ff
    dt = cfg.dtype
    s: Specs = {
        "embed": ((V, d), ("vocab", "embed"), dt),
        "final_norm": ((d,), (None,), dt),
        "lm_head": ((d, V), ("embed", "vocab"), dt),
        "ln1": ((nl, d), (None, None), dt),
        "ln2": ((nl, d), (None, None), dt),
    }
    for mu in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w"):
        s[mu] = ((nl, d), (None, None), dt)
    for w in ("w_r", "w_k", "w_v", "w_g"):
        s[w] = ((nl, d, d), (None, "embed", "heads"), dt)
    s["w_o"] = ((nl, d, d), (None, "heads", "embed"), dt)
    s["w0"] = ((nl, d), (None, None), "float32")
    s["wA"] = ((nl, d, _DECAY_RANK), (None, "embed", None), dt)
    s["wB"] = ((nl, _DECAY_RANK, d), (None, None, "heads"), dt)
    s["u"] = ((nl, d), (None, None), "float32")
    s["ln_x"] = ((nl, d), (None, None), dt)
    s["mu_ck"] = ((nl, d), (None, None), dt)
    s["mu_cr"] = ((nl, d), (None, None), dt)
    s["w_ck"] = ((nl, d, ff), (None, "embed", "ffn"), dt)
    s["w_cv"] = ((nl, ff, d), (None, "ffn", "embed"), dt)
    s["w_cr"] = ((nl, d, d), (None, "embed", "heads"), dt)
    return s


def init_params(gen: torch.Generator, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """Random parameters on ``gen``'s device, by the reference's rules: norms
    and ``ln_x`` ones, ``mu_*`` and ``w0`` 0.5, ``u`` 0, the rest fp32
    ``normal / sqrt(fan_in)`` cast to their dtype, names in sorted order."""
    params = {}
    for name, (shape, _, dtype) in sorted(param_specs(cfg).items()):
        dev, dt = gen.device, DTYPES[dtype]
        if name.startswith(("ln", "final")):
            params[name] = torch.ones(shape, dtype=dt, device=dev)
        elif name.startswith("mu") or name == "w0":
            params[name] = torch.full(shape, 0.5, dtype=dt, device=dev)
        elif name == "u":
            params[name] = torch.zeros(shape, dtype=dt, device=dev)
        else:
            params[name] = normal_init(gen, shape, dtype)
    return params


def _shift(x: torch.Tensor, x_prev: torch.Tensor | None = None) -> torch.Tensor:
    """Token shift: x_{t-1} (zeros / carried state at t=0). x: (B, S, d)."""
    if x_prev is None:
        x_prev = torch.zeros_like(x[:, :1])
    return torch.cat([x_prev, x[:, :-1]], dim=1)


def _decay_logs(xw, lp):
    """log w_t <= 0: (B, S, d) data-dependent decay (fp32).  On a DTensor the
    low-rank factor is kept whole a row and the decays split by heads (a
    DTensor would split the rank and then meet a sequence-split gradient it
    cannot multiply)."""
    lead = ("batch",) + (None,) * (xw.dim() - 2)
    a = act_constrain(torch.tanh(torch.matmul(xw.to(torch.float32),
                                              lp["wA"].to(torch.float32))), lead + (None,))
    lora = act_constrain(torch.matmul(a, lp["wB"].to(torch.float32)), lead + ("heads",))
    return -torch.exp(lp["w0"].to(torch.float32) + lora)


# ---------------------------------------------------------------------------
# the chunked WKV: two forms of one recurrence
# ---------------------------------------------------------------------------

def _chunks(r, k, v, logw, H, chunk):
    """(B, S, d) inputs -> fp32 (B, N, T, H, hd) chunks, and the inclusive and
    exclusive cumulative log-decays within each chunk."""
    B, S, d = r.shape
    hd = d // H
    T = min(chunk, S)
    assert S % T == 0, (S, T)
    N = S // T
    rs, ks, vs = (t.to(torch.float32).reshape(B, N, T, H, hd) for t in (r, k, v))
    lw = logw.reshape(B, N, T, H, hd)
    cum = torch.cumsum(lw, dim=2)  # inclusive cumulative log-decay
    return rs, ks, vs, cum, cum - lw  # exclusive: before step t's decay


def _carry(rs, ks, vs, cum, cum_prev, u, o_intra):
    """What the chunks add to each other: the state entering each chunk (the
    only sequential part), its inter-chunk output, the diagonal bonus term.

    Returns (out (B, S, d), the state after the last chunk (B, H, hd, hd))."""
    B, N, T, H, hd = rs.shape
    uu = u.reshape(H, hd)
    # state update: S_out = diag(exp(cum_T)) S_in + sum_j exp(cum_T - cum_j) k_j (x) v_j
    cum_T = cum[:, :, -1:]  # (B, N, 1, H, hd)
    kd = ks * torch.exp(cum_T - cum)
    contrib = torch.einsum("bnjhk,bnjhv->bnhkv", kd, vs)
    decay = torch.exp(cum_T[:, :, 0])[..., None]  # (B, N, H, hd, 1)
    state = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=rs.device)
    s_in = []
    for n in range(N):
        s_in.append(state)
        state = decay[:, n] * state + contrib[:, n]
    # inter-chunk: o_t += (r_t * exp(cum_prev_t)) . S_in
    q_eff = rs * torch.exp(cum_prev)
    o_inter = torch.einsum("bnthk,bnhkv->bnthv", q_eff, torch.stack(s_in, 1))
    # diagonal bonus term: r_t . (u * k_t) v_t
    o_diag = (rs * uu * ks).sum(-1, keepdim=True) * vs
    out = o_inter + o_intra + o_diag
    return out.reshape(B, N * T, H * hd), state


def _scores_dot(a, b, chunk_dtype):
    """``einsum("bthk,bjhk->btjh")`` on inputs rounded to ``chunk_dtype`` and
    summed in fp32 (the reference's ``preferred_element_type``)."""
    a, b = a.to(chunk_dtype).to(torch.float32), b.to(chunk_dtype).to(torch.float32)
    return torch.einsum("...thk,...jhk->...tjh", a, b)


def _intra_scores(rc, kc, cum, cum_prev, chunk_dtype):
    """Strict-lower-triangular intra-chunk scores of nb blocks at once.

    Inputs (B, nb, Tb, H, hd) -> (B, nb, Tb, Tb, H).  The reference's
    recursive block factorisation: a block of more than 8 tokens splits in
    halves A | B; the B x A cross block is ``(r_B exp(cum_prev_B - c_mid)) .
    (k_A exp(c_mid - cum_A))`` (both exponents <= 0), where c_mid is the
    inclusive decay through A; the halves recurse, here every block of a
    level at once; base blocks keep the explicit decay tensor."""
    B, nb, Tb, H, hd = rc.shape
    if Tb <= _BASE_BLOCK:
        expo = cum_prev[:, :, :, None] - cum[:, :, None, :]  # (B, nb, t, j, H, hd)
        tri = torch.ones(Tb, Tb, dtype=torch.bool, device=rc.device).tril(-1)
        dec = torch.exp(expo.masked_fill_(~tri[:, :, None, None], -torch.inf))
        dec = dec.to(chunk_dtype).to(torch.float32)
        r_, k_ = (t.to(chunk_dtype).to(torch.float32) for t in (rc, kc))
        return (r_[:, :, :, None] * k_[:, :, None, :] * dec).sum(-1)
    m = Tb // 2
    if Tb % 2:  # unequal halves: recurse on each
        s_aa = _intra_scores(rc[:, :, :m], kc[:, :, :m], cum[:, :, :m], cum_prev[:, :, :m],
                             chunk_dtype)
        s_bb = _intra_scores(rc[:, :, m:], kc[:, :, m:], cum[:, :, m:], cum_prev[:, :, m:],
                             chunk_dtype)
    else:  # equal halves: the next level is 2 nb blocks of m
        def halves(t):
            return t.reshape(B, 2 * nb, m, *t.shape[3:])

        s = _intra_scores(halves(rc), halves(kc), halves(cum), halves(cum_prev), chunk_dtype)
        s = s.reshape(B, nb, 2, m, m, H)
        s_aa, s_bb = s[:, :, 0], s[:, :, 1]
    c_mid = cum[:, :, m - 1 : m]  # inclusive decay through the A half
    rB = rc[:, :, m:] * torch.exp(cum_prev[:, :, m:] - c_mid)  # exponent <= 0
    kA = kc[:, :, :m] * torch.exp(c_mid - cum[:, :, :m])  # exponent <= 0
    s_ba = _scores_dot(rB, kA, chunk_dtype)
    zero = s_ba.new_zeros(B, nb, m, Tb - m, H)
    top = torch.cat([s_aa, zero], dim=3)
    bot = torch.cat([s_ba, s_bb], dim=3)
    return torch.cat([top, bot], dim=2)


def _wkv_chunked(r, k, v, logw, u, H, chunk, chunk_dtype=torch.float32):
    """Chunked linear attention, the recursive form (``forward``).
    r, k, v: (B, S, d); logw: (B, S, d) (<= 0).  Returns fp32 (B, S, d).
    ``chunk_dtype``: dtype of the intra-chunk decay/score tensors (fp32 or
    bf16), summed in fp32."""
    rs, ks, vs, cum, cum_prev = _chunks(r, k, v, logw, H, chunk)
    scores = _intra_scores(rs, ks, cum, cum_prev, chunk_dtype)  # (B, N, T, T, H)
    o_intra = torch.einsum("bntjh,bnjhv->bnthv", scores, vs)
    return _carry(rs, ks, vs, cum, cum_prev, u, o_intra)[0]


def _wkv_chunked_with_state(r, k, v, logw, u, H, chunk):
    """The explicit form (``prefill``): the (B, T, T, H, hd) decay tensor of
    each chunk, fp32.  Returns (fp32 (B, S, d), final (B, H, hd, hd) state)."""
    rs, ks, vs, cum, cum_prev = _chunks(r, k, v, logw, H, chunk)
    T = rs.shape[2]
    tri = torch.ones(T, T, dtype=torch.bool, device=rs.device).tril(-1)[:, :, None, None]
    o_intra = torch.empty_like(vs)
    for n in range(rs.shape[1]):  # a chunk at a time: its decay tensor is T^2 * d
        expo = cum_prev[:, n, :, None] - cum[:, n, None, :]  # (B, T, T, H, hd)
        dec = expo.masked_fill_(~tri, -torch.inf).exp_()
        scores = (rs[:, n, :, None] * ks[:, n, None, :]).mul_(dec).sum(-1)
        del dec, expo
        o_intra[:, n] = torch.einsum("btjh,bjhv->bthv", scores, vs[:, n])
    return _carry(rs, ks, vs, cum, cum_prev, u, o_intra)


def _wkv_step(r, k, v, logw, S_in, u, H):
    """The recurrence for one token: r, k, v, logw (B, H * hd), the state
    (B, H, hd, hd) -> (o (B, H, hd) fp32, the next state)."""
    B = r.shape[0]
    hd = r.shape[-1] // H
    r, k, v, logw = (t.reshape(B, H, hd) for t in (r, k, v, logw))
    u = u.reshape(H, hd)
    kv = k.to(torch.float32)[..., :, None] * v.to(torch.float32)[..., None, :]
    o = torch.einsum("bhk,bhkv->bhv", r.to(torch.float32), S_in + u[None, :, :, None] * kv)
    return o, torch.exp(logw)[..., None] * S_in + kv


def _on_heads(fn, xs, params, H, outs):
    """``fn(*xs, *params, H)``; on DTensors on each device's batch rows and
    heads (``parallel.local.heads``).  An input of ``xs`` given bare has its
    heads in its last dim; else it is (tensor, head dim).  ``params`` are
    per-channel (H * hd,) parameters."""
    xs = tuple(x if isinstance(x, tuple) else (x, x.dim() - 1) for x in xs)
    if not is_dtensor(xs[0][0]):
        return fn(*(t for t, _ in xs), *params, H)
    return local_ops.heads(fn, xs, tuple((p, 0) for p in params), H, outs)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _mix_inputs(h, xx, lp):
    """Token-shift mixing of the time-mix branch: r, k, v (model dtype), the
    gate g (silu), the log-decays (fp32)."""
    xr, xk, xv, xg, xw = (h + xx * lp[m] for m in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w"))
    r = torch.matmul(xr, lp["w_r"])
    k = torch.matmul(xk, lp["w_k"])
    v = torch.matmul(xv, lp["w_v"])
    g = F.silu(torch.matmul(xg, lp["w_g"]))
    return r, k, v, g, _decay_logs(xw, lp)


def _mix_output(o, lp, g, dtype):
    """Per-head RMS normalisation (the GroupNorm stand-in) of the fp32 WKV
    output o (..., H, hd), ``ln_x``, cast to the model's dtype, gated."""
    shape = o.shape[:-2] + (o.shape[-2] * o.shape[-1],)
    o = L.rms_norm(o, o.new_ones(o.shape[-1])).reshape(shape)
    return (o * lp["ln_x"].to(o.dtype)).to(dtype) * g


def _time_mix(x, lp, cfg: ModelConfig, x_prev=None):
    B, S, d = x.shape
    H = cfg.n_heads
    r, k, v, g, logw = _mix_inputs(x, _shift(x, x_prev) - x, lp)

    def wkv(r, k, v, logw, u, H):
        return _wkv_chunked(r, k, v, logw, u, H, cfg.ssm_chunk,
                            chunk_dtype=DTYPES[cfg.chunk_dtype])

    o = _on_heads(wkv, (r, k, v, logw), (lp["u"].to(torch.float32),), H, outs=(2,))
    o = _mix_output(o.reshape(B, S, H, d // H), lp, g, x.dtype)
    return act_constrain(torch.matmul(o, lp["w_o"]), _ACT)


def _channel_mix(x, lp, x_prev=None, xx=None):
    if xx is None:
        xx = _shift(x, x_prev) - x
    xk = x + xx * lp["mu_ck"]
    xr = x + xx * lp["mu_cr"]
    k = torch.square(F.relu(torch.matmul(xk, lp["w_ck"])))
    kv = torch.matmul(k, lp["w_cv"])
    return torch.sigmoid(torch.matmul(xr, lp["w_cr"])) * kv


_LAYER_KEYS = (
    "ln1", "ln2", "mu_r", "mu_k", "mu_v", "mu_g", "mu_w", "w_r", "w_k", "w_v",
    "w_g", "w_o", "w0", "wA", "wB", "u", "ln_x", "mu_ck", "mu_cr", "w_ck",
    "w_cv", "w_cr",
)


def _split(params):
    return (
        {k: v for k, v in params.items() if k in _LAYER_KEYS},
        {k: v for k, v in params.items() if k not in _LAYER_KEYS},
    )


def _layer_params(stacked, i: int):
    return {k: v[i] for k, v in stacked.items()}


def _head(x, rest):
    return torch.matmul(L.rms_norm(x, rest["final_norm"]), rest["lm_head"])


def _block(x, lp, cfg: ModelConfig):
    x = act_constrain(x, _ACT)
    x = x + _time_mix(L.rms_norm(x, lp["ln1"]), lp, cfg)
    return act_constrain(x + _channel_mix(L.rms_norm(x, lp["ln2"]), lp), _ACT)


def forward(params, tokens, cfg: ModelConfig, train: bool = False) -> torch.Tensor:
    """Logits (B, S, V) of a full sequence, the recursive chunked form
    (``train``: layers rematted by ``cfg.remat``)."""
    stacked, rest = _split(params)
    x = act_constrain(L.embed(rest["embed"], tokens), _ACT)
    for lp in unstack(stacked):
        x = remat(_block, x, lp, cfg, train=train, cfg=cfg)
    return act_constrain(_head(x, rest), ("batch", None, "vocab"))


def loss_fn(params, batch, cfg: ModelConfig) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` ({"tokens", "labels"})."""
    logits = forward(params, batch["tokens"], cfg, train=True)
    return L.softmax_cross_entropy(logits, batch["labels"], cfg.vocab_size)


# ---------------------------------------------------------------------------
# serving: state-carrying decode (O(1) per token)
# ---------------------------------------------------------------------------

def cache_specs(cfg: ModelConfig, batch: int) -> Specs:
    """The serving state (the reference's ``init_cache``, which returns these
    specs): per layer the fp32 wkv state and the token-shift buffers."""
    d, H = cfg.d_model, cfg.n_heads
    hd = d // H
    return {
        "wkv_state": (
            (cfg.n_layers, batch, H, hd, hd),
            (None, "batch", "ssm_heads", None, None),
            "float32",
        ),
        "tm_prev": ((cfg.n_layers, batch, d), (None, "batch", None), cfg.dtype),
        "cm_prev": ((cfg.n_layers, batch, d), (None, "batch", None), cfg.dtype),
    }


def decode_step(params, token, cache, kv_len, cfg: ModelConfig):
    """One-token recurrent step.  cache: ``cache_specs``' stacked (L, ...)
    states, updated in place.  ``kv_len`` is unused (the state carries the
    position).  Returns (logits (B, V), the same cache dict)."""
    stacked, rest = _split(params)
    H = cfg.n_heads
    x = act_constrain(L.embed(rest["embed"], token), ("batch", None))  # (B, d)
    states = StateWriter(cache, is_dtensor(x))
    for i in range(cfg.n_layers):
        lp = _layer_params(stacked, i)
        S_in = cache["wkv_state"][i]
        x = act_constrain(x, ("batch", None))
        h = L.rms_norm(x, lp["ln1"])
        r, k, v, g, logw = _mix_inputs(h, cache["tm_prev"][i] - h, lp)
        o, S_out = _on_heads(_wkv_step, ((r, 1), (k, 1), (v, 1), (logw, 1), (S_in, 1)),
                             (lp["u"].to(torch.float32),), H, outs=(1, 1))
        x = x + torch.matmul(_mix_output(o, lp, g, x.dtype), lp["w_o"])
        h2 = L.rms_norm(x, lp["ln2"])
        x = x + _channel_mix(h2, lp, xx=cache["cm_prev"][i] - h2)
        states.put(i, wkv_state=S_out, tm_prev=h, cm_prev=h2)
    return act_constrain(_head(x, rest), ("batch", "vocab")), states.done()


def prefill(params, tokens, cfg: ModelConfig):
    """Full-sequence forward that also returns the serving state.

    Returns (logits (B, S, V), cache) matching ``cache_specs``: the per-layer
    wkv state after the last token (the explicit chunked form) plus the
    token-shift buffers needed to continue decoding at position S.
    """
    stacked, rest = _split(params)
    x = act_constrain(L.embed(rest["embed"], tokens), _ACT)
    B, S, d = x.shape
    H = cfg.n_heads
    nl = cfg.n_layers
    cache = None
    if not is_dtensor(x):
        cache = {
            "wkv_state": torch.empty((nl, B, H, d // H, d // H), dtype=torch.float32,
                                     device=x.device),
            "tm_prev": torch.empty((nl, B, d), dtype=x.dtype, device=x.device),
            "cm_prev": torch.empty((nl, B, d), dtype=x.dtype, device=x.device),
        }
    states = StateWriter(cache, cache is None)
    for i in range(nl):
        lp = _layer_params(stacked, i)
        h = L.rms_norm(x, lp["ln1"])
        r, k, v, g, logw = _mix_inputs(h, _shift(h) - h, lp)

        def wkv(r, k, v, logw, u, H):
            return _wkv_chunked_with_state(r, k, v, logw, u, H, cfg.ssm_chunk)

        o, state = _on_heads(wkv, (r, k, v, logw), (lp["u"].to(torch.float32),), H,
                             outs=(2, 1))
        o = _mix_output(o.reshape(B, S, H, d // H), lp, g, x.dtype)
        # the time-mix output in the batch layout (else DTensor may
        # reduce-scatter it over the sequence, which the next product cannot take)
        x = x + act_constrain(torch.matmul(o, lp["w_o"]), _ACT)
        h2 = L.rms_norm(x, lp["ln2"])
        x = act_constrain(x + _channel_mix(h2, lp), _ACT)
        states.put(i, wkv_state=state, tm_prev=h[:, -1], cm_prev=h2[:, -1])
    return act_constrain(_head(x, rest), ("batch", None, "vocab")), states.done()

