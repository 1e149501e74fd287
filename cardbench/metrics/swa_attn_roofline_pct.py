"""K4's windowed instance as a share of its roofline over the traced part.

``counts.exaone.window_bound`` of each window layer of every traced request
(B = 1, bf16) over the device time of the kernels named
``flash_attn_tc_window`` in the trace.
"""

from cardbench.counts import exaone

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER, MOVES = "kernel K4", "ttft_p95_ms"


def read(run):
    c = run.config
    traced = [r for r in run.records.get("requests", []) if r["traced"]]
    n, device_s = run.trace.kernel_s("flash_attn_tc_window")
    if not traced or not n:
        return None
    bound = sum(exaone.n_sliding(c) * exaone.window_bound(
        1, r["n_text"], c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"],
        c["sliding_window"])[0] for r in traced)
    return 100.0 * bound / (1e3 * device_s)
