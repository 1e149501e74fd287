"""The prefill's share of the card's bf16 peak.

Every request's FLOPs counted from its shapes (``counts.prefill_flops``:
the linear layers and the lm head at every position, the patch projection,
the causal attention's own work) over the summed request times (send to
first token on the host) and 989 TFLOP/s.
"""

from cardbench import counts

UNIT, BETTER, SOURCE = "%", "higher", "host_clock"
LAYER, MOVES = "model prefill", "ttft_p95_ms"


def read(run):
    c, P = run.config, run.records.get("n_patches", 0)
    reqs = run.records.get("requests", [])
    if not reqs:
        return None
    flops = sum(counts.prefill_flops(P + r["n_text"], P, c["n_layers"], c["d_model"],
                                     c["n_heads"], c["n_kv_heads"], c["head_dim"], c["d_ff"],
                                     c["vocab_size"]) for r in reqs)
    return 100.0 * flops / sum(r["ttft"] for r in reqs) / counts.BF16_FLOPS
