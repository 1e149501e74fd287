"""The whole search's share of the card's fp32 peak (TF32 is off).

The training work of every row the window trained, counted from shapes
(``counts.qat_row_flops``: the row's budget of steps at its batch size,
forward and backward of the MLP, then the test-set forward), over the
window's wall time (less the time the harness spent reading the profiler)
and 67 TFLOP/s.
"""

from cardbench import counts

UNIT, BETTER, SOURCE = "%", "higher", "host_clock"
LAYER, MOVES = "search, whole", "search_s"


def read(run):
    c = run.config
    budget = run.records["budget"]
    flops = 0
    for s in run.records.get("searches", []):
        for call in s["calls"]:
            bs, ep = call["rows"][3], call["rows"][4]
            flops += sum(counts.qat_row_flops(c["layer_sizes"], int(b), int(e),
                                              run.records["n_train"], run.records["n_test"],
                                              budget["step_scale"], budget["max_steps"])
                         for b, e in zip(bs, ep))
    t0, t1 = run.records["search_window"]
    if not flops:
        return None
    seconds = (t1 - t0) - run.trace.paused_s(t0, t1)
    return 100.0 * flops / seconds / counts.FP32_FLOPS
