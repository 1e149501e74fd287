"""K4's latent-attention instance (q/k 192, v 128) as a share of its roofline over the traced part.

``counts.deepseek.mla_attn_bound`` of each layer of every traced request
(B = 1, bf16) over the device time of the kernels named
``flash_attn_tc_dv`` in the trace, a name no other K4 instance has.
"""

from cardbench.counts import deepseek

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER, MOVES = "kernel K4", "ttft_p95_ms"


def read(run):
    c = run.config
    traced = [r for r in run.records.get("requests", []) if r["traced"]]
    n, device_s = run.trace.kernel_s("flash_attn_tc_dv")
    if not traced or not n:
        return None
    dqk = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    bound = sum(c["num_hidden_layers"] * deepseek.mla_attn_bound(
        r["n_text"], c["num_attention_heads"], dqk, c["v_head_dim"])[0] for r in traced)
    return 100.0 * bound / (1e3 * device_s)
