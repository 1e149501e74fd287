"""DeepSeek-V3's prefill as a share of the card's bf16 peak.

Every request's FLOPs counted from its shapes and the expert pairs the
program routed to the held experts (``counts.deepseek.prefill_flops``) over
the summed request times (send to first token on the host) and 989
TFLOP/s.
"""

from cardbench import counts
from cardbench.counts import deepseek

UNIT, BETTER, SOURCE = "%", "higher", "host_clock"
LAYER, MOVES = "model prefill", "ttft_p95_ms"


def read(run):
    reqs = run.records.get("requests", [])
    if not reqs or any("held_pairs" not in r for r in reqs):
        return None
    flops = sum(deepseek.prefill_flops(r["n_text"], r["held_pairs"], run.config) for r in reqs)
    return 100.0 * flops / sum(r["ttft"] for r in reqs) / counts.BF16_FLOPS
