"""Zamba2 hybrid: a Mamba2 (SSD) backbone + one shared attention block.

The port of the JAX package's ``models/hybrid.py``: the same parameter
names, shapes and layouts, the same entry points.  Mamba2 blocks use the
chunked SSD form (a scalar decay a head, so the intra-chunk decay matrix is
only (B, T, T, H), its mask inclusive); the shared attention block (one
parameter set, invoked every ``cfg.attn_every`` layers with its own KV
cache per invocation) provides the global mixing.  Decode carries
{ssm_state, conv_state} per Mamba layer and a KV cache per shared-attention
invocation.  What differs from the reference, and why:

* **``act_constrain`` at the reference's sites** (``parallel.sharding``),
  and on the shared block's attention and MLP outputs (as whisper's), a
  no-op on plain tensors and outside a mesh; a DTensor step runs the
  chunked SSD on each device's batch rows and heads
  (``parallel.local.heads``) and stacks its serving state instead of
  writing it in place.  Layers run as a Python
  loop, the serving entry points under ``torch.inference_mode()``.
  ``loss_fn`` runs with gradients on, each Mamba2 block recomputed in the
  backward pass with ``cfg.remat`` (the shared block is not, as in the
  reference).
* **Chunks in parallel, the carry alone in sequence.** The reference scans
  chunk by chunk.  Here every chunk's intra-chunk output and state
  contribution are computed at once, and only the (B, H, hd, N) state
  carry ``h = exp(cum_T) h + contribution`` loops over chunks: the same
  arithmetic for every element, far fewer launches.
* **Attention on a CUDA tensor goes to the hand-written kernels**, through
  ``transformer.attend`` and ``transformer.decode_attend``: K4 in the
  shared block of ``forward`` and ``prefill``, K5 in ``decode_step`` (once
  per invocation, ``n_super`` a step).  On the CPU, and in ``loss_fn`` on
  every device, the plain versions the reference uses run
  (``plain_attention`` up to 8192 positions, the blocked scan beyond;
  ``decode_attention_jnp``'s twin).
* **``decode_step`` writes the states and the new k/v into the cache in
  place** and returns the same dict; a row at or past the cache's length is
  written nowhere, as the reference's where-update.
* A Mamba block's ``S > 1`` path starts from a zero SSM state whatever
  ``ssm_state`` it is given, as in the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import DTYPES, Specs, StateWriter, normal_init, remat
from repro_torch.parallel import local as local_ops
from repro_torch.parallel.sharding import act_constrain, act_reshape, is_dtensor

__all__ = [
    "param_specs",
    "init_params",
    "forward",
    "loss_fn",
    "prefill",
    "decode_step",
    "cache_specs",
]

_CONV_K = 4
_ACT = ("batch", None, None)  # (B, S, d) activations


def _dims(cfg: ModelConfig):
    d = cfg.d_model
    d_inner = 2 * d
    hd = cfg.ssm_head_dim
    Hm = d_inner // hd
    N = cfg.ssm_state
    conv_dim = d_inner + 2 * N
    return d, d_inner, Hm, hd, N, conv_dim


def param_specs(cfg: ModelConfig) -> Specs:
    d, d_inner, Hm, hd, N, conv_dim = _dims(cfg)
    nl, V, dt = cfg.n_layers, cfg.padded_vocab, cfg.dtype
    proj_out = 2 * d_inner + 2 * N + Hm  # z, x, B, C, dt
    s: Specs = {
        "embed": ((V, d), ("vocab", "embed"), dt),
        "final_norm": ((d,), (None,), dt),
        "lm_head": ((d, V), ("embed", "vocab"), dt),
        # mamba2 stack
        "ln": ((nl, d), (None, None), dt),
        "in_proj": ((nl, d, proj_out), (None, "embed", "ssm_heads"), dt),
        "conv_w": ((nl, _CONV_K, conv_dim), (None, None, "ssm_heads"), dt),
        "conv_b": ((nl, conv_dim), (None, "ssm_heads"), dt),
        "A_log": ((nl, Hm), (None, None), "float32"),
        "Dskip": ((nl, Hm), (None, None), "float32"),
        "dt_bias": ((nl, Hm), (None, None), "float32"),
        "gn": ((nl, d_inner), (None, "ssm_heads"), dt),
        "out_proj": ((nl, d_inner, d), (None, "ssm_heads", "embed"), dt),
    }
    if cfg.attn_every:
        Hq, Hkv, ahd = cfg.n_heads, cfg.n_kv_heads, cfg.d_model // cfg.n_heads
        s["sa_ln"] = ((d,), (None,), dt)
        s["sa_wq"] = ((d, Hq * ahd), ("embed", "heads"), dt)
        s["sa_wk"] = ((d, Hkv * ahd), ("embed", "kv_heads"), dt)
        s["sa_wv"] = ((d, Hkv * ahd), ("embed", "kv_heads"), dt)
        s["sa_wo"] = ((Hq * ahd, d), ("heads", "embed"), dt)
        s["sa_ln2"] = ((d,), (None,), dt)
        s["sa_wg"] = ((d, cfg.d_ff), ("embed", "ffn"), dt)
        s["sa_wu"] = ((d, cfg.d_ff), ("embed", "ffn"), dt)
        s["sa_wd"] = ((cfg.d_ff, d), ("ffn", "embed"), dt)
    return s


def init_params(gen: torch.Generator, cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """Random parameters on ``gen``'s device, by the reference's rules: norms
    ones; ``A_log`` (A = -1), ``Dskip``, ``dt_bias``, ``conv_b`` zeros; the
    rest fp32 ``normal / sqrt(fan_in)`` cast to their dtype."""
    params = {}
    for name, (shape, _, dtype) in sorted(param_specs(cfg).items()):
        dev, dt = gen.device, DTYPES[dtype]
        if name in ("final_norm", "sa_ln", "sa_ln2", "ln", "gn"):
            params[name] = torch.ones(shape, dtype=dt, device=dev)
        elif name in ("A_log", "Dskip", "dt_bias", "conv_b"):
            params[name] = torch.zeros(shape, dtype=dt, device=dev)
        else:
            params[name] = normal_init(gen, shape, dtype)
    return params


# ---------------------------------------------------------------------------
# mamba2 (SSD) block: chunked
# ---------------------------------------------------------------------------

def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv, kernel K.  x: (B, S, C); w: (K, C).

    ``state``: (B, K-1, C) history for decode; None -> zero history.
    Returns (silu(conv), the last K-1 inputs: the next call's history)."""
    B, S, C = x.shape
    K = w.shape[0]
    if state is None:
        state = x.new_zeros(B, K - 1, C)
    xp = torch.cat([state, x], dim=1)  # (B, S+K-1, C)
    out = sum(xp[:, i : i + S] * w[i] for i in range(K)) + b
    return F.silu(out), xp[:, -(K - 1) :]


def _ssd_chunked(x, Bm, Cm, dtv, A_log, Dskip, chunk):
    """Chunked SSD. x: (B,S,H,hd); Bm/Cm: (B,S,N); dtv: (B,S,H) (softplus'd).

    h_t = exp(A*dt_t) h_{t-1} + dt_t * x_t (x) B_t ;  y_t = C_t . h_t + D x_t

    Returns (y fp32 (B,S,H,hd), the state after the last chunk (B,H,hd,N)).
    """
    Bsz, S, H, hd = x.shape
    N = Bm.shape[-1]
    T = min(chunk, S)
    assert S % T == 0
    nC = S // T
    lA = -torch.exp(A_log.to(torch.float32))  # (H,) negative
    ld = lA[None, None, :] * dtv  # (B,S,H) log-decay <= 0
    xs = x.to(torch.float32).reshape(Bsz, nC, T, H, hd)
    Bs = Bm.to(torch.float32).reshape(Bsz, nC, T, N)
    Cs = Cm.to(torch.float32).reshape(Bsz, nC, T, N)
    ds = dtv.reshape(Bsz, nC, T, H)
    cum = torch.cumsum(ld.reshape(Bsz, nC, T, H), dim=2)  # inclusive
    # intra-chunk (inclusive diag): decay exp(cum_t - cum_j), j <= t
    expo = cum[:, :, :, None] - cum[:, :, None, :]  # (B,nC,T,T,H)
    tri = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()[:, :, None]
    dec = expo.masked_fill_(~tri, -torch.inf).exp_()
    scores = torch.einsum("bctn,bcjn->bctj", Cs, Bs)[..., None] * dec  # (B,nC,T,T,H)
    y_intra = torch.einsum("bctjh,bcjhv->bcthv", scores * ds[:, :, None], xs)
    # state update: what each chunk adds, then the carry across chunks
    cum_T = cum[:, :, -1]  # (B,nC,H)
    w = torch.exp(cum_T[:, :, None] - cum) * ds  # (B,nC,T,H)
    contrib = torch.einsum("bcjhv,bcjn->bchvn", w[..., None] * xs, Bs)
    decay = torch.exp(cum_T)[..., None, None]  # (B,nC,H,1,1)
    h = torch.zeros((Bsz, H, hd, N), dtype=torch.float32, device=x.device)
    h_in = []
    for c in range(nC):
        h_in.append(h)
        h = decay[:, c] * h + contrib[:, c]
    # inter-chunk: y_t += exp(cum_t) C_t . h_in
    y_inter = torch.exp(cum)[..., None] * torch.einsum(
        "bctn,bchvn->bcthv", Cs, torch.stack(h_in, 1))
    y = (y_inter + y_intra).reshape(Bsz, S, H, hd)
    y = y + Dskip.to(torch.float32)[None, None, :, None] * x.to(torch.float32)
    return y, h


def _ssd_step(x, Bm, Cm, dtv, A_log, Dskip, h):
    """Single-token SSD update (decode). Shapes as chunked with S=1."""
    lA = -torch.exp(A_log.to(torch.float32))
    ld = lA[None, None, :] * dtv  # (B,1,H)
    a = torch.exp(ld)[:, 0][:, :, None, None]  # (B,H,1,1)
    x0 = x[:, 0].to(torch.float32)  # (B,H,hd)
    contrib = (dtv[:, 0][:, :, None] * x0)[..., None] * Bm[:, 0].to(torch.float32)[:, None, None]
    h = a * h + contrib
    y = torch.einsum("bn,bhvn->bhv", Cm[:, 0].to(torch.float32), h)
    y = y + Dskip.to(torch.float32)[None, :, None] * x0
    return y[:, None], h


def _mamba_block(x, lp, cfg: ModelConfig, conv_state=None, ssm_state=None):
    """Full mamba2 block. x: (B, S, d). Returns (out, conv_state, ssm_state)."""
    d, d_inner, Hm, hd, N, conv_dim = _dims(cfg)
    B, S, _ = x.shape
    h = L.rms_norm(x, lp["ln"])
    proj = act_constrain(torch.matmul(h, lp["in_proj"]), ("batch", None, "ssm_heads"))
    z, xbc, dt_raw = torch.split(proj, [d_inner, conv_dim, Hm], dim=-1)
    xbc, conv_state = _causal_conv(xbc, lp["conv_w"], lp["conv_b"], conv_state)
    xm, Bm, Cm = torch.split(xbc, [d_inner, N, N], dim=-1)
    dtv = F.softplus(dt_raw.to(torch.float32) + lp["dt_bias"])  # (B,S,Hm)
    xm = xm.reshape(B, S, Hm, hd)
    if S > 1 and is_dtensor(xm):  # each device's batch rows and heads (parallel.local)
        def ssd(x, Bm, Cm, dtv, A_log, Dskip, H):
            return _ssd_chunked(x, Bm, Cm, dtv, A_log, Dskip, cfg.ssm_chunk)

        y, ssm_state = local_ops.heads(
            ssd, ((xm, 2), (Bm, None), (Cm, None), (dtv, 2)),
            ((lp["A_log"], 0), (lp["Dskip"], 0)), Hm, outs=(2, 1))
    elif S > 1:  # a zero initial state, whatever ssm_state is (as the reference)
        y, ssm_state = _ssd_chunked(xm, Bm, Cm, dtv, lp["A_log"], lp["Dskip"], cfg.ssm_chunk)
    else:
        if ssm_state is None:
            ssm_state = torch.zeros((B, Hm, hd, N), dtype=torch.float32, device=x.device)
        y, ssm_state = _ssd_step(xm, Bm, Cm, dtv, lp["A_log"], lp["Dskip"], ssm_state)
    y = y.reshape(B, S, d_inner).to(x.dtype)
    y = L.rms_norm(y * F.silu(z), lp["gn"])
    return torch.matmul(y, lp["out_proj"]), conv_state, ssm_state


# ---------------------------------------------------------------------------
# shared attention block (zamba2)
# ---------------------------------------------------------------------------

def _shared_attn(x, rest, cfg: ModelConfig, rope=None, kv=None, kv_len=None,
                 train: bool = False):
    """Full sequence (kv=None; ``rope``: ``layers.rope_angles`` of the
    positions; ``train``: the plain attention on every device) or decode
    (kv=(kc, vc), written in place at kv_len).
    Returns (x, (k, v)): the new keys/values, or the caches."""
    B = x.shape[0]
    d = cfg.d_model
    Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
    ahd = d // Hq
    h = L.rms_norm(x, rest["sa_ln"])
    if kv is None:
        S = x.shape[1]
        kv_axes = ("batch", None, "kv_heads", None)
        q = act_reshape(torch.matmul(h, rest["sa_wq"]), (B, S, Hq, ahd),
                        ("batch", None, "heads", None))
        k = act_reshape(torch.matmul(h, rest["sa_wk"]), (B, S, Hkv, ahd), kv_axes)
        v = act_reshape(torch.matmul(h, rest["sa_wv"]), (B, S, Hkv, ahd), kv_axes)
        q = L.rotate(q, *rope)
        k = L.rotate(k, *rope)
        plain = L.flash_attention if S > 8192 else L.plain_attention
        o = transformer.attend(q, k, v, True, plain, train)
        o = torch.matmul(o.reshape(B, S, Hq * ahd), rest["sa_wo"])
        new_kv = (k, v)
    else:
        kc, vc = kv
        Smax = kc.shape[1]
        q = act_reshape(torch.matmul(h, rest["sa_wq"]), (B, Hq, ahd), ("batch", "heads", None))
        k = act_reshape(torch.matmul(h, rest["sa_wk"]), (B, Hkv, ahd), ("batch", "kv_heads", None))
        v = act_reshape(torch.matmul(h, rest["sa_wv"]), (B, Hkv, ahd), ("batch", "kv_heads", None))
        cos, sin = L.rope_angles(kv_len[:, None], ahd, cfg.rope_theta)
        q = L.rotate(q[:, None], cos, sin)[:, 0]
        k = L.rotate(k[:, None], cos, sin)[:, 0]
        # the reference's where-update writes nothing for a row at or past Smax
        rows = torch.arange(B, device=x.device)
        inside = (kv_len < Smax)[:, None, None]
        at = kv_len.clamp(max=Smax - 1)
        kc, vc = transformer.cache_write(kc, vc, k, v, rows, at, inside, kv_len)
        o = transformer.decode_attend(q, kc, vc, kv_len + 1)
        o = torch.matmul(o.reshape(B, Hq * ahd), rest["sa_wo"])
        new_kv = (kc, vc)
    axes = _ACT if x.dim() == 3 else ("batch", None)
    x = x + act_constrain(o, axes)
    h2 = L.rms_norm(x, rest["sa_ln2"])
    x = x + act_constrain(L.swiglu(h2, rest["sa_wg"], rest["sa_wu"], rest["sa_wd"]), axes)
    return x, new_kv


_LAYER_KEYS = (
    "ln", "in_proj", "conv_w", "conv_b", "A_log", "Dskip", "dt_bias", "gn", "out_proj",
)


def _split(params):
    return (
        {k: v for k, v in params.items() if k in _LAYER_KEYS},
        {k: v for k, v in params.items() if k not in _LAYER_KEYS},
    )


def _n_super(cfg: ModelConfig) -> tuple[int, int]:
    """(shared-attention invocations, Mamba layers before each)."""
    if not cfg.attn_every:
        return 1, cfg.n_layers
    assert cfg.n_layers % cfg.attn_every == 0
    return cfg.n_layers // cfg.attn_every, cfg.attn_every


def _head(x, rest):
    return torch.matmul(L.rms_norm(x, rest["final_norm"]), rest["lm_head"])


def _mamba_residual(x, lp, cfg: ModelConfig):
    x = act_constrain(x, _ACT)
    o, cs, ss = _mamba_block(x, lp, cfg)
    return act_constrain(x + o, _ACT), cs, ss


def _full_sequence(params, tokens, cfg: ModelConfig, keep_cache: bool, train: bool = False):
    stacked, rest = _split(params)
    x = act_constrain(L.embed(rest["embed"], tokens), _ACT)
    B, S, _ = x.shape
    _, _, Hm, hd, N, conv_dim = _dims(cfg)
    n_super, per = _n_super(cfg)
    rope = L.rope_angles(torch.arange(S, device=x.device), cfg.d_model // cfg.n_heads,
                         cfg.rope_theta)
    layers = transformer.unstack(stacked)
    cache = None
    if keep_cache and not is_dtensor(x):
        nl = cfg.n_layers
        cache = {
            "ssm_state": torch.empty((nl, B, Hm, hd, N), dtype=torch.float32, device=x.device),
            "conv_state": torch.empty((nl, B, _CONV_K - 1, conv_dim), dtype=x.dtype,
                                      device=x.device),
        }
        if cfg.attn_every:
            kv_shape = (n_super, B, S, cfg.n_kv_heads, cfg.d_model // cfg.n_heads)
            for n in ("sa_k", "sa_v"):
                cache[n] = torch.empty(kv_shape, dtype=x.dtype, device=x.device)
    states = StateWriter(cache, keep_cache and cache is None)
    for s in range(n_super):
        for i in range(s * per, (s + 1) * per):
            x, cs, ss = remat(_mamba_residual, x, layers[i], cfg, train=train, cfg=cfg)
            if keep_cache:
                states.put(i, conv_state=cs, ssm_state=ss)
        if cfg.attn_every:
            x, (k, v) = _shared_attn(x, rest, cfg, rope, train=train)
            if keep_cache:
                states.put(s, sa_k=k, sa_v=v)
    logits = act_constrain(_head(x, rest), ("batch", None, "vocab"))
    return logits, states.done() if keep_cache else None


def forward(params, tokens, cfg: ModelConfig, train: bool = False) -> torch.Tensor:
    """Logits (B, S, V) of a full sequence (``train``: plain attention on every
    device, Mamba2 blocks rematted by ``cfg.remat``)."""
    return _full_sequence(params, tokens, cfg, keep_cache=False, train=train)[0]


def loss_fn(params, batch, cfg: ModelConfig) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` ({"tokens", "labels"})."""
    logits = forward(params, batch["tokens"], cfg, train=True)
    return L.softmax_cross_entropy(logits, batch["labels"], cfg.vocab_size)


def prefill(params, tokens, cfg: ModelConfig):
    """Full-sequence forward returning (logits, serving cache).

    The cache matches ``cache_specs``: per-layer {ssm_state, conv_state}
    plus one KV cache per shared-attention invocation (filled to S).
    """
    return _full_sequence(params, tokens, cfg, keep_cache=True)


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> Specs:
    """The serving state (the reference's ``init_cache``, which returns these
    specs)."""
    d, d_inner, Hm, hd, N, conv_dim = _dims(cfg)
    n_super, _ = _n_super(cfg)
    ahd = d // cfg.n_heads
    s: Specs = {
        "ssm_state": (
            (cfg.n_layers, batch, Hm, hd, N),
            (None, "batch", "ssm_heads", None, None),
            "float32",
        ),
        "conv_state": (
            (cfg.n_layers, batch, _CONV_K - 1, conv_dim),
            (None, "batch", None, "ssm_heads"),
            cfg.dtype,
        ),
    }
    if cfg.attn_every:
        kv_shape = (n_super, batch, max_len, cfg.n_kv_heads, ahd)
        kv_axes = (None, "batch", None, "kv_heads", "head_dim")
        s["sa_k"] = (kv_shape, kv_axes, cfg.dtype)
        s["sa_v"] = (kv_shape, kv_axes, cfg.dtype)
    return s


def decode_step(params, token, cache, kv_len, cfg: ModelConfig):
    """One-token step.  cache: ``cache_specs``' states and KV caches, updated
    in place (position ``kv_len`` of each shared-attention cache written).
    Returns (logits (B, V), the same cache dict)."""
    stacked, rest = _split(params)
    x = act_constrain(L.embed(rest["embed"], token), ("batch", None))[:, None]  # (B,1,d)
    n_super, per = _n_super(cfg)
    states = StateWriter(cache, is_dtensor(x))
    for s in range(n_super):
        for i in range(s * per, (s + 1) * per):
            o, cs, ss = _mamba_block(x, {k: v[i] for k, v in stacked.items()}, cfg,
                                     conv_state=cache["conv_state"][i],
                                     ssm_state=cache["ssm_state"][i])
            x = x + o
            states.put(i, conv_state=cs, ssm_state=ss)
        if cfg.attn_every:
            x2, (kc, vc) = _shared_attn(x[:, 0], rest, cfg,
                                        kv=(cache["sa_k"][s], cache["sa_v"][s]), kv_len=kv_len)
            x = x2[:, None]
            if states.stacked:
                states.put(s, sa_k=kc, sa_v=vc)
    return act_constrain(_head(x[:, 0], rest), ("batch", "vocab")), states.done()
