"""K2/K3's share of their roofline over the traced part of the window.

The least time the calls need (``counts.bound_ms`` at each evaluator call's
rows: per step one K2 and one K3 at B = max_batch, K3 without dx, the
warm-up steps of a capture too, and one K2 over the test set) over the
kernels' device time from the trace (``fused_qat_fwd``/``fused_qat_bwd``,
their mean time a launch times the launches the traced calls made, so a
record the profiler lost or a launch from another path does not move it).
"""

from cardbench import counts

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER, MOVES = "kernels K2/K3", "search_s"


def read(run):
    c = run.config
    C, F = c["layer_sizes"][0], c["layer_sizes"][1]
    T = (1 << c["adc_bits"]) - 1
    B, steps = c["max_batch"], run.records["budget"]["max_steps"]
    n_fwd = n_bwd = 0
    bound = 0.0
    for s in run.records.get("searches", []):
        for call in s["calls"]:
            if not call["traced"]:
                continue
            P, n = call["P"], steps + call["warmup"]
            fwd = counts.bound_ms(B, False, P=P, C=C, F=F, T=T)[0]
            test = counts.bound_ms(run.records["n_test"], False, P=P, C=C, F=F, T=T)[0]
            bwd = counts.bound_ms(B, True, need_dx=False, P=P, C=C, F=F, T=T)[0]
            bound += n * (fwd + bwd) + test
            n_fwd += n + 1
            n_bwd += n
    k2, t2 = run.trace.kernel_s("fused_qat_fwd")
    k3, t3 = run.trace.kernel_s("fused_qat_bwd")
    if not (n_fwd and k2 and k3):
        return None
    device_ms = 1e3 * (t2 / k2 * n_fwd + t3 / k3 * n_bwd)
    return 100.0 * bound / device_ms
