"""Plain reference of DeepSeek-V3's language model, one card's expert share.

The layer equations of DeepSeek-V3 (arXiv:2412.19437; the ``deepseek_v3``
modelling code of its config.json), for every layer i:

    q        = RMSNorm(x W_qa) W_qb, per head (nope 128 | rope 64)
    c, k_pe  = x W_kva, split at kv_lora_rank;  c = RMSNorm(c)
    k_nope, v = c W_kvb, per head (nope 128 | v 128)
    q_pe, k_pe = RoPE(q_pe), RoPE(k_pe)      YaRN angles; k_pe one for all heads
    o = softmax(scale [q_nope, q_pe] . [k_nope, k_pe]^T, j <= i) v
    x = x + o W_o
    x = x + FFN(RMSNorm(x))

with the attention's q and x pre-normed (``ln1``, ``ln2``), MLA in its
unabsorbed form.  The rope dims lie interleaved in pairs and are
de-interleaved before the rotation (``apply_rotary_pos_emb`` there).  YaRN
(``DeepseekV3YarnRotaryEmbedding``): frequencies 1 / theta^(2j/p),
extrapolated below the correction range of beta_fast and beta_slow
rotations over ``original_max_position_embeddings`` positions, divided by
``factor`` above it, a linear ramp between; cos and sin times
mscale(factor, mscale) / mscale(factor, mscale_all_dim), mscale(f, m) =
0.1 m ln f + 1; the softmax scale (nope + rope)^-1/2 times
mscale(factor, mscale_all_dim)^2.  FFN is a SwiGLU of
``intermediate_size`` in the first ``first_k_dense_replace`` layers and
else the expert layer: s = sigmoid(x_fp32 W_router) over all
``n_routed_experts``; the choice scores s + b (``e_score_correction_bias``,
selection only); each of ``n_group`` groups scored by the sum of its two
best choice scores, the top ``num_experts_per_tok`` chosen among the
``topk_group`` best groups only; their weights s (unbiased) / (sum + 1e-20)
times ``routed_scaling_factor``; FFN(x) = the sum over the chosen experts
held here of w E(x), plus the shared expert.

Departures from the source, each for the benchmark's cut: this card holds
experts [0, ``experts_held``) of each expert layer (rank 0 of an EP pool);
the absent experts' part is left out, as in the program; only the first
``num_hidden_layers`` layers run (a pipeline's first stage), then the final
norm and the head; the multi-token-prediction layer is not run; the
weights are random (the driver's).

Everything is computed in fp32 from the bf16 weights it is handed, one
layer at a time (a layer's weights widened only while it runs), the
attention in blocks of queries over the keys up to each block's end, the
experts as a loop over the held ones with boolean selection.
``precision="fp8"`` computes every product from e4m3 inputs instead: the
control.  Weight layout (``weight_shapes``): layer weights stacked on a
leading axis (the dense MLP over the leading dense layers, the expert
layer's over the rest), ``x @ w`` with ``w`` (d_in, d_out).
"""

from __future__ import annotations

import math

import torch

from cardbench.reference.precision import matmul

__all__ = ["weight_shapes", "rope_tables", "softmax_scale", "logits_at"]

Q_BLOCK = 128  # queries a block: 128 heads x 128 x 32768 fp32 scores are 2.1 GB


def weight_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Every weight's shape, from the configuration file's keys (the
    source's names), ``experts_held`` and ``padded_vocab``."""
    L, d, V = cfg["num_hidden_layers"], cfg["hidden_size"], cfg["padded_vocab"]
    H, nd, r = cfg["num_attention_heads"], cfg["first_k_dense_replace"], cfg["kv_lora_rank"]
    qr, n, p, e = (cfg["q_lora_rank"], cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                   cfg["v_head_dim"])
    f, fe = cfg["intermediate_size"], cfg["moe_intermediate_size"]
    fs, nm, E = cfg["n_shared_experts"] * fe, L - nd, cfg["experts_held"]
    return {
        "embed": (V, d), "lm_head": (d, V), "final_norm": (d,), "ln1": (L, d), "ln2": (L, d),
        "wq_a": (L, d, qr), "q_a_norm": (L, qr), "wq_b": (L, qr, H * (n + p)),
        "wkv_a": (L, d, r + p), "kv_a_norm": (L, r), "wkv_b": (L, r, H * (n + e)),
        "wo": (L, H * e, d),
        "w_gate": (nd, d, f), "w_up": (nd, d, f), "w_down": (nd, f, d),
        "router": (nm, d, cfg["n_routed_experts"]), "router_bias": (nm, cfg["n_routed_experts"]),
        "we_gate": (nm, E, d, fe), "we_up": (nm, E, d, fe), "we_down": (nm, E, fe, d),
        "ws_gate": (nm, d, fs), "ws_up": (nm, d, fs), "ws_down": (nm, fs, d),
    }


def _mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def rope_tables(cfg: dict, S: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """YaRN's cos and sin (S, p), each frequency twice (``cat(freqs, freqs)``)."""
    p, base = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    y = cfg["rope_scaling"]
    factor = float(y["factor"])
    pos = torch.arange(0, p, 2, dtype=torch.float32, device=device) / p
    extra = 1.0 / base ** pos
    inter = 1.0 / (factor * base ** pos)

    def dim(rot):  # the frequency index that turns ``rot`` times over the original positions
        return (p * math.log(y["original_max_position_embeddings"] / (rot * 2 * math.pi))
                / (2 * math.log(base)))

    lo, hi = max(math.floor(dim(y["beta_fast"])), 0), min(math.ceil(dim(y["beta_slow"])), p - 1)
    if lo == hi:
        hi += 0.001
    ramp = ((torch.arange(p // 2, dtype=torch.float32, device=device) - lo) / (hi - lo)).clamp(0, 1)
    mask = 1.0 - ramp
    inv_freq = inter * (1 - mask) + extra * mask
    freqs = torch.outer(torch.arange(S, dtype=torch.float32, device=device), inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    m = _mscale(factor, y["mscale"]) / _mscale(factor, y["mscale_all_dim"])
    return emb.cos() * m, emb.sin() * m


def softmax_scale(cfg: dict) -> float:
    scale = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    y = cfg["rope_scaling"]
    if y.get("mscale_all_dim"):
        scale *= _mscale(float(y["factor"]), y["mscale_all_dim"]) ** 2
    return scale


def _rms(x, scale, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def _rope(x, cos, sin):
    """x (S, H, p) in interleaved pairs: de-interleaved, then x cos + rotate_half(x) sin."""
    S, H, p = x.shape
    x = x.view(S, H, p // 2, 2).transpose(3, 2).reshape(S, H, p)
    half = torch.cat([-x[..., p // 2:], x[..., : p // 2]], dim=-1)
    return x * cos[:, None] + half * sin[:, None]


def _attention(q, k, v, scale: float, precision: str):
    """Causal attention over one sequence, q/k (S, H, dqk), v (S, H, dv)."""
    S = q.shape[0]
    kk, vv = k.permute(1, 2, 0), v.transpose(0, 1)          # (H, dqk, S), (H, S, dv)
    out = q.new_empty(q.shape[:2] + v.shape[2:])
    for s0 in range(0, S, Q_BLOCK):
        s1 = min(s0 + Q_BLOCK, S)
        qb = q[s0:s1].transpose(0, 1)                       # (H, b, dqk)
        s = matmul(qb, kk[:, :, :s1], precision) * scale    # (H, b, s1)
        keep = (torch.arange(s1, device=q.device)[None]
                <= torch.arange(s0, s1, device=q.device)[:, None])
        p = torch.softmax(s.masked_fill_(~keep, float("-inf")), dim=-1)
        out[s0:s1] = matmul(p, vv[:, :s1], precision).transpose(0, 1)
    return out


def _mla(x, lw, cfg: dict, cos, sin, precision: str):
    """The attention's output o W_o at x (S, d)."""
    S = x.shape[0]
    H, r, eps = cfg["num_attention_heads"], cfg["kv_lora_rank"], float(cfg["rms_norm_eps"])
    n, e = cfg["qk_nope_head_dim"], cfg["v_head_dim"]
    q = matmul(_rms(matmul(x, lw["wq_a"], precision), lw["q_a_norm"], eps), lw["wq_b"],
               precision).view(S, H, -1)
    ckv = matmul(x, lw["wkv_a"], precision)
    kv = matmul(_rms(ckv[:, :r], lw["kv_a_norm"], eps), lw["wkv_b"], precision).view(S, H, n + e)
    k_pe = _rope(ckv[:, None, r:], cos, sin)
    q = torch.cat([q[..., :n], _rope(q[..., n:], cos, sin)], dim=-1)
    k = torch.cat([kv[..., :n], k_pe.expand(S, H, -1)], dim=-1)
    o = _attention(q, k, kv[..., n:], softmax_scale(cfg), precision)
    return matmul(o.reshape(S, H * e), lw["wo"], precision)


def _swiglu(x, g, u, dn, precision):
    return matmul(torch.nn.functional.silu(matmul(x, g, precision)) * matmul(x, u, precision),
                  dn, precision)


def route(x, lw, cfg: dict, precision: str = "fp32"):
    """The router at x (S, d): (the chosen experts' weights, their indices), (S, K) each."""
    K, G = cfg["num_experts_per_tok"], cfg["n_group"]
    s = torch.sigmoid(matmul(x, lw["router"], precision))
    choice = s + lw["router_bias"]
    S, E = choice.shape
    grouped = choice.view(S, G, E // G)
    best = grouped.topk(2, dim=-1)[0].sum(-1).topk(cfg["topk_group"], dim=-1)[1]
    keep = torch.zeros(S, G, dtype=torch.bool, device=x.device).scatter_(1, best, True)
    idx = grouped.masked_fill(~keep[..., None], float("-inf")).view(S, E).topk(K, dim=-1)[1]
    top = s.gather(1, idx)
    return top / (top.sum(-1, keepdim=True) + 1e-20) * cfg["routed_scaling_factor"], idx


def _experts(x, lw, cfg: dict, precision: str):
    """The expert layer's output at x (S, d): the held experts' weighted
    part, every pair computed, plus the shared expert."""
    w, idx = route(x, lw, cfg, precision)
    out = _swiglu(x, lw["ws_gate"], lw["ws_up"], lw["ws_down"], precision)
    for e in range(cfg["experts_held"]):
        pick = idx == e                 # (S, K): a token picks an expert once at most
        rows = pick.any(-1)
        if rows.any():
            y = _swiglu(x[rows], lw["we_gate"][e], lw["we_up"][e], lw["we_down"][e], precision)
            out[rows] += w[pick][:, None] * y
    return out


ATTN = ("ln1", "ln2", "wq_a", "q_a_norm", "wq_b", "wkv_a", "kv_a_norm", "wkv_b", "wo")
DENSE = ("w_gate", "w_up", "w_down")
MOE = ("router", "router_bias", "we_gate", "we_up", "we_down", "ws_gate", "ws_up", "ws_down")


def layer_weights(weights: dict, cfg: dict, i: int) -> dict:
    """Layer i's weights widened to fp32."""
    nd = cfg["first_k_dense_replace"]
    lw = {n: weights[n][i].float() for n in ATTN}
    if i < nd:
        lw.update({n: weights[n][i].float() for n in DENSE})
    else:
        lw.update({n: weights[n][i - nd].float() for n in MOE})
    return lw


def logits_at(weights: dict, cfg: dict, sequences: list, positions: list,
              precision: str = "fp32") -> list[torch.Tensor]:
    """fp32 logits (len(positions[i]), padded_vocab) of each token sequence
    (S,) int64 at the positions asked.  The sequences run together, a layer
    at a time."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    eps, nd = float(cfg["rms_norm_eps"]), cfg["first_k_dense_replace"]
    xs = [weights["embed"][tokens].float() for tokens in sequences]
    tables = [rope_tables(cfg, len(t), t.device) for t in sequences]
    for i in range(cfg["num_hidden_layers"]):
        lw = layer_weights(weights, cfg, i)
        for j, x in enumerate(xs):
            x = x + _mla(_rms(x, lw["ln1"], eps), lw, cfg, *tables[j], precision)
            h = _rms(x, lw["ln2"], eps)
            if i < nd:
                f = _swiglu(h, lw["w_gate"], lw["w_up"], lw["w_down"], precision)
            else:
                f = _experts(h, lw, cfg, precision)
            xs[j] = x + f
        del lw
    head, norm = weights["lm_head"].float(), weights["final_norm"].float()
    return [matmul(_rms(x[torch.as_tensor(p, device=x.device)], norm, eps), head, precision)
            for x, p in zip(xs, positions)]
