"""The serving loop's share of the card's bf16 peak.

Every decode call's FLOPs counted from its shapes (``counts.decode_flops``:
2 x the parameters a row multiplies, for every slot of the batch, plus the
attention over each slot's live cache) over the window's wall time (less
the time the harness spent reading the profiler) and 989 TFLOP/s.  The
cache lengths come from the calls' own ``kv_len``, which the harness keeps
in a traced run.
"""

from cardbench import counts

UNIT, BETTER, SOURCE = "%", "higher", "host_clock"
LAYER, MOVES = "serving loop", "tokens_per_s"


def read(run):
    c, B = run.config, run.traffic["max_batch"]
    calls = run.records.get("decode", [])
    if not calls or calls[0][1] is None:
        return None
    S = run.traffic["prompt_len"] + run.traffic["gen_len"]
    flops = sum(counts.decode_flops(B, int((kv + 1).clamp(max=S).sum()), c["n_layers"],
                                    c["d_model"], c["n_heads"], c["n_kv_heads"],
                                    c["head_dim"], c["d_ff"], c["vocab_size"])
                for _, kv in calls)
    t0, t1 = run.records["window"]
    seconds = (t1 - t0) - run.trace.paused_s(t0, t1)
    return 100.0 * flops / seconds / counts.BF16_FLOPS
