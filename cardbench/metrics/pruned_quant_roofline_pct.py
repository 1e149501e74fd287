"""K1's share of its roofline over the traced part of the window.

``counts.k1_bound`` of each traced request's patches (B = patches, C =
d_model, every comparator of the 4-bit banks) over the device time of the
kernels named ``pruned_quant`` in the trace.
"""

from cardbench import counts

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER, MOVES = "ADC frontend K1", "ttft_p95_ms"


def read(run):
    c, P = run.config, run.records.get("n_patches", 0)
    traced = [r for r in run.records.get("requests", []) if r["traced"]]
    n, device_s = run.trace.kernel_s("pruned_quant")
    if not traced or not n:
        return None
    T = (1 << c["adc_bits"]) - 1
    bound = len(traced) * counts.k1_bound(P, c["d_model"], T)[0]
    return 100.0 * bound / (1e3 * device_s)
