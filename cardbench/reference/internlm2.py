"""Plain reference of internvl2-26b's language model with its pruned-ADC frontend.

InternVL2-26B (arXiv:2404.16821) runs InternLM2-20B as its language model:
pre-norm decoder layers of grouped-query attention with rotary positions
and a SwiGLU MLP, RMS norms, untied embedding and lm head.  The image
enters as patch embeddings (the InternViT-6B encoder is stubbed: the
patch embeddings are inputs), digitised by per-channel 4-bit flash ADCs
(the paper's pruned frontend, every level kept), projected by
``patch_proj`` and put before the text tokens.

Everything is computed in fp32 from the bf16 weights it is handed, one
layer at a time (a layer's weights are widened to fp32 only while that
layer runs), with the attention in blocks of queries, so that it fits
beside the weights on one card.  ``precision="fp8"`` computes every
product from e4m3 inputs instead: the control.  The weight layout is the
one ``weight_shapes`` gives: layer weights stacked on a leading axis,
``x @ w`` with ``w`` (d_in, d_out).
"""

from __future__ import annotations

import torch

from cardbench.reference.precision import matmul

__all__ = ["weight_shapes", "frontend", "logits_at"]

Q_BLOCK = 1024


def weight_shapes(cfg: dict) -> dict[str, tuple[int, ...]]:
    """Every weight's shape: ``cfg`` holds n_layers, d_model, n_heads,
    n_kv_heads, d_ff and padded_vocab (the vocabulary rounded up to 256)."""
    L, d, V = cfg["n_layers"], cfg["d_model"], cfg["padded_vocab"]
    hd = d // cfg["n_heads"]
    q, kv, f = cfg["n_heads"] * hd, cfg["n_kv_heads"] * hd, cfg["d_ff"]
    return {
        "embed": (V, d), "lm_head": (d, V), "final_norm": (d,), "patch_proj": (d, d),
        "ln1": (L, d), "ln2": (L, d),
        "wq": (L, d, q), "wk": (L, d, kv), "wv": (L, d, kv), "wo": (L, q, d),
        "w_gate": (L, d, f), "w_up": (L, d, f), "w_down": (L, f, d),
    }


def frontend(patches: torch.Tensor, n_bits: int = 4) -> torch.Tensor:
    """(P, d) embeddings in [0, 1) -> the value of the level each channel's
    flash ADC reports: k / 2^N for the highest threshold k / 2^N <= x."""
    n = 1 << n_bits
    lvl = torch.arange(1, n, dtype=torch.float32, device=patches.device) / n
    return (patches[..., None] >= lvl).sum(-1).to(torch.float32) / n


def _rms(x, scale, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def _rope(x, pos, theta: float):
    """x (S, H, hd) rotated at positions ``pos`` (S,): halves (x1, x2) ->
    (x1 cos - x2 sin, x1 sin + x2 cos)."""
    hd = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = pos[:, None].to(torch.float32) * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(q, k, v, precision):
    """Causal GQA over one sequence: q (S, Hq, hd), k/v (S, Hkv, hd)."""
    S, Hq, hd = q.shape
    G = Hq // k.shape[1]
    kk = k.repeat_interleave(G, dim=1).transpose(0, 1)      # (Hq, S, hd)
    vv = v.repeat_interleave(G, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    for s0 in range(0, S, Q_BLOCK):
        s1 = min(s0 + Q_BLOCK, S)
        qb = q[s0:s1].transpose(0, 1)                       # (Hq, b, hd)
        s = matmul(qb, kk[:, :s1].transpose(1, 2), precision) / hd ** 0.5
        mask = torch.arange(s0, s1, device=q.device)[:, None] >= torch.arange(
            s1, device=q.device)[None]
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        out[s0:s1] = matmul(p, vv[:, :s1], precision).transpose(0, 1)
    return out


def logits_at(weights: dict, cfg: dict, sequences: list, positions: list,
              precision: str = "fp32") -> list[torch.Tensor]:
    """fp32 logits (len(positions[i]), padded_vocab) of each sequence at the
    positions asked.

    ``sequences[i]`` is ``(tokens (S,) int64, patches (P, d) fp32 or None)``;
    positions count the patches first.  The sequences run together, a layer
    at a time."""
    L, d = cfg["n_layers"], cfg["d_model"]
    Hq, Hkv = cfg["n_heads"], cfg["n_kv_heads"]
    hd, theta, eps = d // Hq, float(cfg["rope_theta"]), float(cfg["rms_norm_eps"])
    f32 = lambda t: t.to(torch.float32)  # noqa: E731
    xs = []
    for tokens, patches in sequences:
        x = f32(weights["embed"][tokens])
        if patches is not None:
            p = matmul(frontend(patches, cfg["adc_bits"]), f32(weights["patch_proj"]), precision)
            x = torch.cat([p, x])
        xs.append(x)
    for i in range(L):
        lw = {n: f32(weights[n][i]) for n in ("ln1", "ln2", "wq", "wk", "wv", "wo",
                                              "w_gate", "w_up", "w_down")}
        for j, x in enumerate(xs):
            S = x.shape[0]
            pos = torch.arange(S, device=x.device)
            h = _rms(x, lw["ln1"], eps)
            q = _rope(matmul(h, lw["wq"], precision).view(S, Hq, hd), pos, theta)
            k = _rope(matmul(h, lw["wk"], precision).view(S, Hkv, hd), pos, theta)
            v = matmul(h, lw["wv"], precision).view(S, Hkv, hd)
            o = _attention(q, k, v, precision).reshape(S, Hq * hd)
            x = x + matmul(o, lw["wo"], precision)
            h = _rms(x, lw["ln2"], eps)
            g = matmul(h, lw["w_gate"], precision)
            u = matmul(h, lw["w_up"], precision)
            xs[j] = x + matmul(torch.nn.functional.silu(g) * u, lw["w_down"], precision)
        del lw
    head, norm = f32(weights["lm_head"]), f32(weights["final_norm"])
    return [matmul(_rms(x[torch.as_tensor(p, device=x.device)], norm, eps), head, precision)
            for x, p in zip(xs, positions)]
