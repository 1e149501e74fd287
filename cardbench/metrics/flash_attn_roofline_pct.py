"""K4's share of its roofline over the traced part of the window.

``counts.flash_bound`` of each layer's causal attention of every traced
request (B = 1, patches and text, bf16) over the device time of the
kernels named ``flash_attn`` in the trace.
"""

from cardbench import counts

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER, MOVES = "kernel K4", "ttft_p95_ms"


def read(run):
    c, P = run.config, run.records.get("n_patches", 0)
    traced = [r for r in run.records.get("requests", []) if r["traced"]]
    n, device_s = run.trace.kernel_s("flash_attn")
    if not traced or not n:
        return None
    bound = sum(c["n_layers"] * counts.flash_bound(1, P + r["n_text"], P + r["n_text"],
                                                   c["n_heads"], c["n_kv_heads"],
                                                   c["head_dim"], True)[0] for r in traced)
    return 100.0 * bound / (1e3 * device_s)
