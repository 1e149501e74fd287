"""Frozen operation and byte counts of the benchmark: peaks, kernel bounds, FLOPs.

The kernel bounds are copied from the port's bring-up smoke run
(``chip_smoke.py``: ``roofline``, ``bound_ms``, ``flash_bound``,
``decode_bound``, ``k1_bound``) and kept here, where the program cannot
change them.  A bound is the least time the chip could take for a call:
the larger of the bytes it must move over the HBM rate and the operations
it must do over the peak.  Each input byte counts as read once and each
output byte as written once.  The bound of K2/K3 takes the population
size ``P`` as an argument, where the smoke run fixed it at 24.

The FLOP counts of whole steps (the QAT training of a row, a prefill, a
decode call) count the work the algorithm needs at the call's shapes,
whatever kernel does it: the products of every linear layer and of the
attention, two FLOPs a multiply-add.  Quantizers, norms and other
elementwise passes are left out, so a share of the peak is a lower bound.
"""

from __future__ import annotations

# H100 SXM (NVIDIA data sheet, dense, at the 700 W limit): HBM3 bytes/s,
# fp32 outside the tensor cores, bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12

# the printed MLP's first layer: comparators a channel of a 4-bit bank
QAT_T = 15

__all__ = [
    "HBM_BYTES_PER_S", "FP32_FLOPS", "BF16_FLOPS", "roofline", "bound_ms",
    "flash_bound", "decode_bound", "k1_bound", "mlp_sample_flops",
    "qat_row_flops", "step_budget", "prefill_flops", "decode_flops",
    "linear_params",
]


def roofline(nbytes: float, ops: float, peak: float) -> tuple[float, str]:
    """The larger of bytes over the HBM rate and ops over ``peak``, in ms, and which."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_ms(B: int, backward: bool, need_dx: bool = True, P: int = 24, C: int = 21,
             F: int = 5, T: int = QAT_T) -> tuple[float, str]:
    """Least time of one K2 (forward) or K3 (backward) call at (P, B).

    Without dx (training) the backward neither reads w nor writes dx nor
    forms dx's products."""
    reads = P * B * C * 4 + 2 * P * C * T * 4
    bank_ops = P * B * C * (2 * T + 3)  # compare + select per threshold, dequant
    if not backward or need_dx:
        reads += P * C * F * 4                       # w
    if backward:
        reads += P * B * F * 4                       # g
        n_products = 2 if need_dx else 1             # dx and dw, or dw alone
        writes = P * B * C * 4 * (n_products - 1) + P * C * F * 4
        ops = bank_ops + n_products * (2 * P * B * C * F)
    else:
        reads += P * F * 4                           # bias
        writes = P * B * F * 4
        ops = bank_ops + 2 * P * B * C * F
    return roofline(reads + writes, ops, FP32_FLOPS)


def flash_bound(B, Sq, Sk, Hq, Hkv, d, causal, itemsize: int = 2) -> tuple[float, str]:
    """Least time of one K4 call: q, k, v read and out written once vs the
    products' FLOPs (causal: only the pairs with k <= q) at the type's peak
    (bf16 for a 2-byte type, fp32 for a 4-byte one)."""
    nbytes = (2 * B * Sq * Hq * d + 2 * B * Sk * Hkv * d) * itemsize
    if causal:
        # sum(min(i + 1, Sk) for i in range(Sq)), in closed form
        n = min(Sq, Sk)
        pairs = n * (n + 1) // 2 + (Sq - n) * Sk
    else:
        pairs = Sq * Sk
    peak = BF16_FLOPS if itemsize == 2 else FP32_FLOPS
    return roofline(nbytes, 4 * B * Hq * d * pairs, peak)


def decode_bound(B, Hq, Hkv, S, d, kv_rows: int, itemsize: int = 2) -> tuple[float, str]:
    """Least time of one K5 call: the K/V rows up to each row's kv_len
    (``kv_rows``, their sum over the batch, each clamped to S), q, out and
    kv_len moved once vs the products' FLOPs over those rows."""
    nbytes = (2 * B * Hq * d + 2 * kv_rows * Hkv * d) * itemsize + 4 * B
    peak = BF16_FLOPS if itemsize == 2 else FP32_FLOPS
    return roofline(nbytes, 4 * Hq * d * kv_rows, peak)


def k1_bound(B: int, C: int, T: int = 15) -> tuple[float, str]:
    """Least time of one K1 call: x read and the int32 levels written once, the
    two (C, T) tables read once, vs a compare and a max per comparator at the
    fp32 peak."""
    return roofline(8 * B * C + 8 * C * T, 2 * B * C * T, FP32_FLOPS)


# ---------------------------------------------------------------------------
# whole steps
# ---------------------------------------------------------------------------

def mlp_sample_flops(layer_sizes, train: bool = True) -> int:
    """FLOPs of one sample through the MLP: the forward's products, and for
    training the weight gradients of every layer plus the input gradients of
    every layer but the first (the inputs need none)."""
    macs = [fi * fo for fi, fo in zip(layer_sizes[:-1], layer_sizes[1:])]
    fwd = 2 * sum(macs)
    if not train:
        return fwd
    return fwd + 2 * sum(macs) + 2 * sum(macs[1:])


def step_budget(batch_size: int, epochs: int, n_train: int, step_scale: float,
                max_steps: int) -> int:
    """Training steps a row's parameters move: ``min(max(ep * ceil(n / bs) *
    step_scale, 1), max_steps)``, the trainer's own budget rule."""
    per_epoch = -(-n_train // int(batch_size))
    return int(min(max(epochs * per_epoch * step_scale, 1.0), max_steps))


def qat_row_flops(layer_sizes, batch_size: int, epochs: int, n_train: int, n_test: int,
                  step_scale: float, max_steps: int) -> int:
    """The work one row's QAT needs: its budget of steps at its own batch
    size (padding samples and frozen steps are not needed), then one
    forward over the test set."""
    steps = step_budget(batch_size, epochs, n_train, step_scale, max_steps)
    return (steps * int(batch_size) * mlp_sample_flops(layer_sizes)
            + n_test * mlp_sample_flops(layer_sizes, train=False))


def linear_params(n_layers, d, n_heads, n_kv_heads, hd, d_ff) -> int:
    """Weights of the transformer layers' linear maps (q, k, v, o and SwiGLU)."""
    attn = d * n_heads * hd + 2 * d * n_kv_heads * hd + n_heads * hd * d
    return n_layers * (attn + 3 * d * d_ff)


def prefill_flops(n_positions: int, n_patches: int, n_layers, d, n_heads, n_kv_heads, hd,
                  d_ff, vocab) -> int:
    """A B=1 prefill over ``n_positions`` (patches included): every linear
    layer at every position, the lm head at every position, the patch
    projection at the patches, and the causal attention's own work
    (QK^T and PV over the pairs with k <= q)."""
    lin = 2 * n_positions * linear_params(n_layers, d, n_heads, n_kv_heads, hd, d_ff)
    head = 2 * n_positions * d * vocab
    patches = 2 * n_patches * d * d
    pairs = n_positions * (n_positions + 1) // 2
    attn = n_layers * 4 * n_heads * hd * pairs
    return lin + head + patches + attn


def decode_flops(batch: int, kv_rows: int, n_layers, d, n_heads, n_kv_heads, hd, d_ff,
                 vocab) -> int:
    """One decode call over ``batch`` rows: 2 x the parameters every row
    multiplies (the layers' linear maps and the lm head) per row, plus the
    attention over each row's live cache (``kv_rows``: the attended
    positions summed over the batch) in every layer."""
    per_row = linear_params(n_layers, d, n_heads, n_kv_heads, hd, d_ff) + d * vocab
    return 2 * batch * per_row + n_layers * 4 * n_heads * hd * kv_rows
