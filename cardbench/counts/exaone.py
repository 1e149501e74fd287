"""Operation and byte counts of K-EXAONE-236B-A23B's prefill (``kexaone-long-ttft``).

``config`` is the configuration file (the source's keys).  As in
``counts``: two FLOPs a multiply-add, the work the algorithm needs at the
call's shapes whatever kernel does it, norms and elementwise passes left
out, so a share of the peak is a lower bound.
"""

from __future__ import annotations

from cardbench.counts import BF16_FLOPS, roofline

__all__ = ["window_pairs", "window_bound", "n_sliding", "prefill_flops"]


def window_pairs(S: int, W: int) -> int:
    """Query-key pairs of a causal window of W keys over S positions:
    sum(min(i + 1, W) for i in range(S)), in closed form."""
    n = min(S, W)
    return n * (n + 1) // 2 + (S - n) * W


def window_bound(B: int, S: int, Hq: int, Hkv: int, d: int, W: int,
                 itemsize: int = 2) -> tuple[float, str]:
    """Least time of one windowed K4 call (self-attention, Sq = Sk = S): q,
    k, v read and out written once vs the window pairs' FLOPs at the bf16
    peak."""
    nbytes = (2 * B * S * Hq * d + 2 * B * S * Hkv * d) * itemsize
    return roofline(nbytes, 4 * B * Hq * d * window_pairs(S, W), BF16_FLOPS)


def n_sliding(config: dict) -> int:
    """The layers that attend through the window."""
    types = config["layer_types"][: config["num_hidden_layers"]]
    return sum(t == "sliding_attention" for t in types)


def prefill_flops(S: int, held_pairs: int, config: dict) -> int:
    """A B=1 prefill of S positions: the attention projections of every
    layer, the dense layers' MLP and the shared experts at every position,
    the router (fp32) of every expert layer, the held experts at the
    ``held_pairs`` (token, expert) pairs the program routed to them (summed
    over the layers), the window and causal attention pairs, and the lm
    head at every position."""
    c = config
    L, d, hd = c["num_hidden_layers"], c["hidden_size"], c["head_dim"]
    Hq, Hkv, nd = c["num_attention_heads"], c["num_key_value_heads"], c["first_k_dense_replace"]
    fe = c["moe_intermediate_size"]
    attn = 2 * d * Hq * hd + 2 * d * Hkv * hd
    per_token = (L * attn + nd * 3 * d * c["intermediate_size"]
                 + (L - nd) * (3 * d * c["num_shared_experts"] * fe + d * c["num_experts"])
                 + d * c["vocab_size"])
    n_win = n_sliding(c)
    pairs = n_win * window_pairs(S, c["sliding_window"]) + (L - n_win) * (S * (S + 1) // 2)
    return 2 * S * per_token + 2 * held_pairs * 3 * d * fe + 4 * Hq * hd * pairs
