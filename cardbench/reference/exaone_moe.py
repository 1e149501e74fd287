"""Plain reference of K-EXAONE-236B-A23B's language model, one card's expert share.

The layer is EXAONE 4.0's (``transformers.models.exaone4``), the expert
layer DeepSeek-V3's router and MoE with ``n_group`` = ``topk_group`` = 1
(K-EXAONE's own ``exaone_moe`` code was not at hand; its config names these
pieces).  For a layer i of ``layer_types``:

    q, k, v = x Wq, x Wk, x Wv                      (no norm before)
    q, k = RMSNorm_hd(q), RMSNorm_hd(k)              per head
    q, k = RoPE(q), RoPE(k)                          sliding layers only (global: NoPE)
    o = softmax(q k^T / sqrt(hd), keys i - W < j <= i on sliding layers,
                j <= i on full ones) v
    x = x + RMSNorm(o Wo)
    x = x + RMSNorm(FFN(x))

with FFN a dense SwiGLU in the first ``first_k_dense_replace`` layers and
else the expert layer: s = sigmoid(x_fp32 W_router) over all
``num_experts``, the top ``num_experts_per_tok`` by s, their weights
s / (sum + 1e-20) * ``routed_scaling_factor``, FFN(x) = sum over the chosen
experts held here of w E(x), plus the shared expert.  This card holds
experts [0, ``experts_held``) of each layer (rank 0 of the pool); the absent
experts' part is left out, as in the program.
DeepSeek-V3's selection-only ``e_score_correction_bias`` is left out (its
initial value, zero, changes nothing).  The multi-token-prediction layer
is not run.

Everything is computed in fp32 from the bf16 weights it is handed, one
layer at a time (a layer's weights widened only while it runs), the
attention in blocks of queries with the window as an explicit mask, the
experts as a loop over the held ones with boolean selection.
``precision="fp8"`` computes every product from e4m3 inputs instead: the
control.  Weight layout (``weight_shapes``): layer weights stacked on a
leading axis (the dense MLP over the leading dense layers, the expert
layer's over the rest), ``x @ w`` with ``w`` (d_in, d_out).
"""

from __future__ import annotations

import torch

from cardbench.reference.precision import matmul

__all__ = ["weight_shapes", "sliding", "logits_at"]

Q_BLOCK = 256  # queries a block: 64 heads x 256 x 32768 fp32 scores are 2.1 GB


def weight_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Every weight's shape, from the configuration file's keys (the
    source's names) and ``padded_vocab``."""
    L, d, V = cfg["num_hidden_layers"], cfg["hidden_size"], cfg["padded_vocab"]
    hd, nd = cfg["head_dim"], cfg["first_k_dense_replace"]
    q, kv = cfg["num_attention_heads"] * hd, cfg["num_key_value_heads"] * hd
    f, fe = cfg["intermediate_size"], cfg["moe_intermediate_size"]
    fs, nm, H = cfg["num_shared_experts"] * fe, L - nd, cfg["experts_held"]
    return {
        "embed": (V, d), "lm_head": (d, V), "final_norm": (d,),
        "ln1": (L, d), "ln2": (L, d), "q_norm": (L, hd), "k_norm": (L, hd),
        "wq": (L, d, q), "wk": (L, d, kv), "wv": (L, d, kv), "wo": (L, q, d),
        "w_gate": (nd, d, f), "w_up": (nd, d, f), "w_down": (nd, f, d),
        "router": (nm, d, cfg["num_experts"]),
        "we_gate": (nm, H, d, fe), "we_up": (nm, H, d, fe), "we_down": (nm, H, fe, d),
        "ws_gate": (nm, d, fs), "ws_up": (nm, d, fs), "ws_down": (nm, fs, d),
    }


def sliding(cfg: dict) -> list[bool]:
    """Which layers attend through the sliding window."""
    return [t == "sliding_attention" for t in cfg["layer_types"][: cfg["num_hidden_layers"]]]


def _rms(x, scale, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def _rope(x, theta: float):
    """x (S, H, hd) rotated at positions 0..S-1: halves (x1, x2) ->
    (x1 cos - x2 sin, x1 sin + x2 cos)."""
    S, hd = x.shape[0], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(q, k, v, window: int | None, precision: str):
    """Causal GQA over one sequence, q (S, Hq, hd), k/v (S, Hkv, hd); with
    ``window``, query i keeps the keys i - window < j <= i."""
    S, Hq, hd = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    kk, vv = k.permute(1, 2, 0), v.transpose(0, 1)           # (Hkv, hd, S), (Hkv, S, hd)
    out = torch.empty_like(q)
    for s0 in range(0, S, Q_BLOCK):
        s1 = min(s0 + Q_BLOCK, S)
        k0 = max(0, s0 - window + 1) if window else 0
        qb = q[s0:s1].reshape(s1 - s0, Hkv, G, hd).permute(1, 2, 0, 3)  # (Hkv, G, b, hd)
        s = matmul(qb, kk[:, None, :, k0:s1], precision) / hd ** 0.5    # (Hkv, G, b, n)
        qpos = torch.arange(s0, s1, device=q.device)[:, None]
        kpos = torch.arange(k0, s1, device=q.device)[None]
        keep = kpos <= qpos
        if window:
            keep = keep & (kpos > qpos - window)
        p = torch.softmax(s.masked_fill_(~keep, float("-inf")), dim=-1)
        o = matmul(p, vv[:, None, k0:s1], precision)                   # (Hkv, G, b, hd)
        out[s0:s1] = o.permute(2, 0, 1, 3).reshape(s1 - s0, Hq, hd)
    return out


def _swiglu(x, g, u, dn, precision):
    return matmul(torch.nn.functional.silu(matmul(x, g, precision)) * matmul(x, u, precision),
                  dn, precision)


def _experts(x, lw, cfg: dict, precision: str):
    """The expert layer's output at x (S, d): the held experts' weighted
    part, every pair computed, plus the shared expert."""
    K, H = cfg["num_experts_per_tok"], cfg["experts_held"]
    s = torch.sigmoid(matmul(x, lw["router"], precision))
    top, idx = torch.topk(s, K, dim=-1)
    w = top / (top.sum(-1, keepdim=True) + 1e-20) * cfg["routed_scaling_factor"]
    out = _swiglu(x, lw["ws_gate"], lw["ws_up"], lw["ws_down"], precision)
    for e in range(H):
        pick = idx == e                 # (S, K): a token picks an expert once at most
        rows = pick.any(-1)
        if rows.any():
            y = _swiglu(x[rows], lw["we_gate"][e], lw["we_up"][e], lw["we_down"][e], precision)
            out[rows] += w[pick][:, None] * y
    return out


def logits_at(weights: dict, cfg: dict, sequences: list, positions: list,
              precision: str = "fp32") -> list[torch.Tensor]:
    """fp32 logits (len(positions[i]), padded_vocab) of each token sequence
    (S,) int64 at the positions asked.  The sequences run together, a layer
    at a time."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    L, nd = cfg["num_hidden_layers"], cfg["first_k_dense_replace"]
    Hq, Hkv, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    eps, theta = float(cfg["rms_norm_eps"]), float(cfg["rope_parameters"]["rope_theta"])
    W, kinds = int(cfg["sliding_window"]), sliding(cfg)
    f32 = lambda t: t.to(torch.float32)  # noqa: E731
    xs = [f32(weights["embed"][tokens]) for tokens in sequences]
    attn = ("ln1", "ln2", "q_norm", "k_norm", "wq", "wk", "wv", "wo")
    dense = ("w_gate", "w_up", "w_down")
    moe = ("router", "we_gate", "we_up", "we_down", "ws_gate", "ws_up", "ws_down")
    for i in range(L):
        lw = {n: f32(weights[n][i]) for n in attn}
        if i < nd:
            lw.update({n: f32(weights[n][i]) for n in dense})
        else:
            lw.update({n: f32(weights[n][i - nd]) for n in moe})
        for j, x in enumerate(xs):
            S = x.shape[0]
            q = _rms(matmul(x, lw["wq"], precision).view(S, Hq, hd), lw["q_norm"], eps)
            k = _rms(matmul(x, lw["wk"], precision).view(S, Hkv, hd), lw["k_norm"], eps)
            v = matmul(x, lw["wv"], precision).view(S, Hkv, hd)
            if kinds[i]:
                q, k = _rope(q, theta), _rope(k, theta)
            o = _attention(q, k, v, W if kinds[i] else None, precision).reshape(S, Hq * hd)
            x = x + _rms(matmul(o, lw["wo"], precision), lw["ln1"], eps)
            if i < nd:
                f = _swiglu(x, lw["w_gate"], lw["w_up"], lw["w_down"], precision)
            else:
                f = _experts(x, lw, cfg, precision)
            xs[j] = x + _rms(f, lw["ln2"], eps)
        del lw
    head, norm = f32(weights["lm_head"]), f32(weights["final_norm"])
    return [matmul(_rms(x[torch.as_tensor(p, device=x.device)], norm, eps), head, precision)
            for x, p in zip(xs, positions)]
