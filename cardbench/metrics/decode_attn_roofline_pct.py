"""K5's share of its roofline over the traced part of the window.

``counts.decode_bound`` of every layer's decode attention in the traced
decode calls (each slot's rows up to its ``kv_len + 1``, bf16) over the
device time of the kernels named ``decode_attn_split`` in the trace.
"""

from cardbench import counts

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER, MOVES = "kernel K5", "tokens_per_s"


def read(run):
    c, B = run.config, run.traffic["max_batch"]
    S = run.traffic["prompt_len"] + run.traffic["gen_len"]
    traced = [kv for on, kv in run.records.get("decode", []) if on and kv is not None]
    n, device_s = run.trace.kernel_s("decode_attn_split")
    if not traced or not n:
        return None
    bound = sum(c["n_layers"] * counts.decode_bound(
        B, c["n_heads"], c["n_kv_heads"], S, c["head_dim"],
        int((kv + 1).clamp(max=S).sum()))[0] for kv in traced)
    return 100.0 * bound / (1e3 * device_s)
