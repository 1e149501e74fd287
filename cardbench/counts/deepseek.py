"""Operation and byte counts of DeepSeek-V3's prefill (``dsv3-long-ttft``).

``config`` is the configuration file (the source's keys).  As in
``counts``: two FLOPs a multiply-add, the work the algorithm needs at the
call's shapes whatever kernel does it, norms, rotations and elementwise
passes left out, so a share of the peak is a lower bound.  Latent
attention counts its unabsorbed form, the one a prefill runs.
"""

from __future__ import annotations

from cardbench.counts import BF16_FLOPS, roofline

__all__ = ["causal_pairs", "mla_attn_bound", "prefill_flops"]


def causal_pairs(S: int) -> int:
    """Query-key pairs of causal self-attention over S positions."""
    return S * (S + 1) // 2


def mla_attn_bound(S: int, H: int, dqk: int, dv: int, itemsize: int = 2) -> tuple[float, str]:
    """Least time of one causal K4 call of latent attention's prefill (B = 1,
    H heads, q/k at ``dqk``, v and out at ``dv``): q, k, v read and out
    written once vs the causal pairs' FLOPs (S = q.k at dqk, P.V at dv) at
    the bf16 peak."""
    nbytes = S * H * (2 * dqk + 2 * dv) * itemsize
    return roofline(nbytes, 2 * H * (dqk + dv) * causal_pairs(S), BF16_FLOPS)


def prefill_flops(S: int, held_pairs: int, config: dict) -> int:
    """A B=1 prefill of S positions: latent attention's five projections in
    every layer, the dense layers' MLP and the shared experts at every
    position, the router (fp32) of every expert layer, the held experts at
    the ``held_pairs`` (token, expert) pairs the program routed to them
    (summed over the layers), the causal pairs of every layer at
    2 H (nope + rope + v), and the lm head at every position."""
    c = config
    L, d, H, nd = (c["num_hidden_layers"], c["hidden_size"], c["num_attention_heads"],
                   c["first_k_dense_replace"])
    r, qr, n, p, e = (c["kv_lora_rank"], c["q_lora_rank"], c["qk_nope_head_dim"],
                      c["qk_rope_head_dim"], c["v_head_dim"])
    fe = c["moe_intermediate_size"]
    mla = d * qr + qr * H * (n + p) + d * (r + p) + r * H * (n + e) + H * e * d
    per_token = (L * mla + nd * 3 * d * c["intermediate_size"]
                 + (L - nd) * (3 * d * c["n_shared_experts"] * fe + d * c["n_routed_experts"])
                 + d * c["vocab_size"])
    attn = L * 2 * H * (n + p + e) * causal_pairs(S)
    return 2 * S * per_token + 2 * held_pairs * 3 * d * fe + attn
