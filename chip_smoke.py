#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py             # build, check every kernel, run every slice
    python3 chip_smoke.py --profile   # also profile 20 training steps, and decode steps
                                      # and a prefill (or encode) of each served model
                                      # (gzipped traces to the OUT directory)
    python3 chip_smoke.py --step-ab   # build, phase 4, then the population step and a
                                      # co-design generation timed eager and from the
                                      # CUDA graph in turns (the graph at block lengths
                                      # S_CANDIDATES), profiles of both, and a capture
                                      # made to fail; no result lines
    python3 chip_smoke.py --attn      # build, then phases 7 and 10 only (K4/K5 checked
                                      # and timed), and stop: no result lines
    python3 chip_smoke.py --decode-ab DIR
                                      # only the decode-step wall time of the three
                                      # served models, K5 alternately this checkout's
                                      # and the one under DIR (another checkout's src,
                                      # e.g. the parent commit's); no result lines
    python3 chip_smoke.py --kernel-ab DIR
                                      # build, phases 3 and 9 (K2/K3 and K1 checked
                                      # and timed), then K1, K2 and K3 timed in turns
                                      # against DIR's (e.g. parent_tree/src), both
                                      # built in this process (K2's outputs must be
                                      # bit-equal), co-design training steps with
                                      # either K2/K3 and whisper-medium's encode with
                                      # either K1; no result lines

Phases, one JSON line each; any failure ends the run with a nonzero exit:

1. device       the card's name, count, power limit.
2. build        every kernel library, built with nvcc for sm_90a from the
                repository's sources, one nvcc per source, all at once; then
                one ``ptxas`` line a library: each kernel's registers, static
                shared memory and spills, from ``nvcc -Xptxas -v``; a spill in
                a kernel of K1's or K2's register path (N = 4) fails the run.
3. kernels      K2 (forward) and K3 (backward) of the fused pruned-ADC QAT layer
                against their plain PyTorch versions on the card, at the main
                path's shapes (P=24 rows, C=21 inputs, F=5 hidden, B=128 and
                the 638-sample test set) and at the comparator edge cases; K2's
                output the same bits twice, for a row alone and at every tile
                of K2_TILES, and within 1e-6 of plain at ragged tiles (B = 1,
                7, 129), at the other datasets' widths (C = 4, 5, 6, 7, 9)
                and on 3- and 5-bit banks (K2's generic comparator loop);
                K3's dw bit-equal to the emulation of its order of summation,
                the same bits twice and for a row alone, with and without dx;
                times by CUDA events, K2 at each tile, K3 with dx and without
                (as training calls it).  The profiler's count of device
                kernels a K2 and a K3 call (one each) and their kernel times
                come after phase 6 (``qat_profiler``): the profiler leaves
                kernel launches slower on the host, and phases 4-6 time a
                host-bound loop.
4. placement    the population step replayed from CUDA graphs (blocks of
                ``EvalConfig.block_steps`` steps) against the eager loop,
                parameters and accuracies ``torch.equal``, at P = 24 and at
                P = 5 (bucket 8); a row trained alone and inside a batch of
                24 gives the same bits; two runs of one batch give the same
                bits; the graphs captured.
5. parity       8 cardio genomes from one draw, on the card and through the
                port's CPU plain path, 600 steps: the per-row accuracy gap must
                stay within the bound measured on the CPU against the JAX package.
6. slice        ``run_codesign`` on cardio at full width (pop 24, 600 steps, 4-bit
                ADCs), 2 generations, through the graphs, with the kernels'
                launch counts read from that run alone: exact, replays
                counted (``EvaluatorTally``).
6b. campaign    ``run_campaign`` over the six datasets at ``CampaignConfig``'s
                defaults, then again over its memo_dir (zero rows trained);
                on seeds with 3 islands the sequential, stacked and async
                drivers give identical fronts, counters, migrations and
                memos, and a drilled host failure plus resume equals the
                uninterrupted run; exact K2/K3 launch counts.
7. attn_kernels K4 (flash attention) and K5 (flash-decode) against their plain
                versions in bf16 and fp32, at yi-9b's prefill and decode shapes
                and at the edge shapes of the CPU sweep; times by CUDA events
                (K5: by the profiler) beside the plain version, SDPA (the
                library yardstick) and the bound.
                Each K4 record names the variant that ran, checked from its
                counters (bf16: the tensor-core kernel, fp32: the CUDA-core
                one); each K5 record its split count, and K5 gives the same
                bits twice; K5 called with kv_len=None reads the full cache,
                and a row with kv_len 0 or -1 is NaN (n_split 1 and > 1) while
                the other rows match the plain version.
8. lm_parity    reduced yi-9b in fp32, one set of seed-drawn parameters on the
                card and on the port's CPU path: ``serve.run`` tokens equal,
                prefill and decode logits within the fp32 bound, and every K4
                launch on the fp32 CUDA-core variant (as in 11).
9. frontend_kernel
                K1 (the pruned flash-ADC comparator bank) against its plain
                version, tolerance 0, at internvl2-26b's patch shape (4 x 256 x
                6144) and whisper's frame shape (4 x 1500 x 1024) with all-ones,
                random and level-0-only masks, at ragged rows and channels, at
                every bank width N in K1_BITS on an odd and an even C (each
                template instance and the generic loop), on an x that is not
                8-byte aligned, with NaN, +-inf, negative, >= vref and
                on-threshold inputs; times by the profiler beside the plain
                version, ``torch.searchsorted`` (the library yardstick) and the
                bound.
10. mm_attn_kernels
                K4 and K5 against their plain versions in bf16 at the shapes
                internvl2-26b (48/8 heads, d 128) and whisper-medium (16/16
                heads, d 64, non-causal encoder and cross-attention) give them,
                with q drawn 4x wider than k and v so that the outputs are O(1)
                (each record gives the reference's RMS beside the error); times
                beside the plain version, SDPA and the bound; K4 on its
                tensor-core variant, K5 the same bits twice.
11. vlm_parity, audio_parity
                reduced internvl2-26b and whisper-medium in fp32, one set of
                seed-drawn parameters on the card and on the port's CPU path:
                prefill/forward with patches, encode, cross caches, decode and
                decode_train logits within 1e-4, equal frontend levels and equal
                greedy tokens.
12. lm_slice    yi-9b at full width and depth in bf16: prefill of 4096 tokens and
                ``serve.run`` of 8 staggered requests, with the K4 and K5 launch
                counts read from that run alone (48 a prefill, all on K4's
                tensor-core variant, as in 13 and 14; 48 a decode step);
                then decode-vs-prefill consistency on a 64-token prompt and
                scheduling independence (a second run without arrival steps).
13. vlm_slice   internvl2-26b at full width and depth in bf16, after yi-9b's
                weights are released: 4 requests of 256 patches + 64 tokens
                prefilled (twice), 32 greedy decode steps at B=4, and a 4096-position
                prefill (256 patches + 3840 tokens) twice, with K1 (1 a prefill
                with patches), K4 (48 a prefill) and K5 (48 a decode step) counted
                in that run alone; then the frontend's fixed point at full width
                (bit-equal logits) and decode-vs-prefill on an 8-layer cut of the
                same weights against its fp32 floor.
14. audio_slice whisper-medium at full width and depth in bf16: ``encode`` of 4 x
                1500 frames (K1 once, K4 24 times), the cross caches, 32 greedy
                decode steps (K5 48 a step: self and cross), counted in that run
                alone; then the steps against ``decode_train`` over the same
                tokens, within 3x its bf16-vs-fp32 floor.

Last, ``capture_fails``: a capture made to read a value back to the host
raises, caches no graph and falls back to nothing.  The last three lines
are the card's name and power limit, the kernels' summary, and
``{"ok": true, "device": {...}}``.  Without CUDA, or without
the repository beside it, the script fails and prints no result.
"""

from __future__ import annotations

import gzip
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 (non-tensor) and
# dense bf16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12

# Per-row |acc_card - acc_cpu| bound for the parity phase: the largest
# per-row gap between the port's CPU path and the JAX package measured at
# 600 steps from the same state, over 304 rows (8 seeds + 296 cardio;
# ``python tests/test_torch_trainer.py``, see PERF.md): 44 of 638 cardio
# test samples, one row whose training diverged chaotically; 86% of rows
# agree exactly.  Drift of the same kind separates the card from the CPU;
# a wrong kernel or path moves most rows by far more.
PARITY_BOUND = 44.0 / 638 + 1e-6

P, C, F, T, N_BITS = 24, 21, 5, 15, 4
SCALE = 1.0 / (1 << N_BITS)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_ms(torch, fn, n: int = 50, repeats: int = 7) -> float:
    """Median device time of one ``fn()`` call, in ms, by CUDA events.

    A sleep kernel keeps the stream busy while the host enqueues the n
    calls, so the events time the device's work, not the host's launches.
    """
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


PROFILER_LOST = 2  # kernel records a profiler session may lose (see _profiled_kernels)


def _profiled_kernels(torch, fn, n: int, match: str) -> list:
    """The device kernel events whose name holds ``match`` over n calls of
    ``fn`` under the profiler.

    Once a process has run a few profiler sessions, a session can lose the
    record of a kernel: on an NVIDIA H100 80GB HBM3 runs of this script saw
    19 of 20 calls' kernels, always one short, and 0 of 20 in a session of
    under a millisecond.  A session therefore starts with a throwaway kernel
    (a short ``torch.cuda._sleep``, its records left out) and a wait, which
    ended the empty sessions, and the callers accept up to PROFILER_LOST
    missing records."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(0.1)
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and match in e.name
            and "spin_kernel" not in e.name]


def kernel_ms(torch, fn, kernel: str, n: int = 20) -> float:
    """Median device time, in ms, of the kernel named ``kernel`` over n calls
    of ``fn``, from the profiler's device events: the kernel alone, without
    the wrapper's other device work (K1's table build) or the gaps between
    launches.  K1's and K5's rows of the kernels line are timed so.
    """
    ev = _profiled_kernels(torch, fn, n, kernel)
    if not n - PROFILER_LOST <= len(ev) <= n:
        raise SystemExit(f"the profiler saw {len(ev)} launches of {kernel}, not {n}")
    return statistics.median(e.time_range.elapsed_us() for e in ev) / 1e3


K5_KERNEL = "decode_attn_split"  # either K5 kernel, bf16 or fp32: one launch a call


def kernel_inputs(torch, B: int, seed: int, C: int = C, F: int = F, n_bits: int = N_BITS):
    """Random (P, B, C) inputs and per-row banks of 2^n_bits - 1 comparators
    with the comparator edge cases (those rows of them that B holds; C >= 4)."""
    import numpy as np

    from repro_torch.kernels.pruned_quant.ref import make_tables

    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.1, 1.1, (P, B, C)).astype(np.float32)
    x[:, :16, 0] = np.arange(16)[:B] / 16   # exact thresholds must fire
    x[:, 16:17, :] = -0.5                     # below the range
    x[:, 17:18, :] = 1.0                      # at vref
    x[:, 18:19, :] = 7.0                      # far above vref
    masks = rng.uniform(size=(P, C, 1 << n_bits)) < rng.uniform(0.1, 1.0, (P, 1, 1))
    masks[0] = True                           # full bank
    masks[1, :, 1:] = False                   # all pruned: level 0 only
    masks[2, 3, 1:] = False                   # one all-pruned channel
    w = rng.normal(0, 0.3, (P, C, F)).astype(np.float32)
    b = rng.normal(0, 0.1, (P, F)).astype(np.float32)
    g = rng.normal(size=(P, B, F)).astype(np.float32)
    dev = torch.device("cuda")
    thr, ids = make_tables(torch.from_numpy(masks).to(dev), n_bits)
    as_dev = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return as_dev(x), thr, ids, as_dev(w), as_dev(b), as_dev(g)


def bound_ms(B: int, backward: bool, need_dx: bool = True) -> tuple[float, str]:
    """Least time of one call at (P, B): bytes over HBM rate vs fp32 ops over peak.
    Without dx (training) the backward neither reads w nor writes dx nor forms
    dx's products."""
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


def roofline(nbytes: float, ops: float, peak: float) -> tuple[float, str]:
    """The larger of bytes over the HBM rate and ops over ``peak``, in ms, and which."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_kernels(torch, fn, n: int = 20, match: str = "") -> dict:
    """Device kernels of one ``fn()`` call, from the profiler over n calls: the
    records seen, their names, how many kernels a call (the records over n,
    rounded: a lost record cannot turn one into two), and their summed device
    time a call (the median time of each name, times its count a call, in
    us).  Only kernels whose name holds ``match`` count."""
    by_name: dict[str, list] = {}
    for e in _profiled_kernels(torch, fn, n, match):
        by_name.setdefault(e.name[:80], []).append(e.time_range.elapsed_us())
    seen = sum(len(v) for v in by_name.values())
    return {"records": seen, "calls": n, "names": sorted(by_name),
            "kernels_per_call": round(seen / n),
            "kernel_us_per_call": sum(round(len(v) / n) * statistics.median(v)
                                      for v in by_name.values())}


K2_TILES = (8, 16, 32)  # candidates of fused_qat.ops.TILE, timed against each other
# (B, C, F, N) of phase 3's further K2 cases: ragged tiles at the training
# width, the other five datasets' widths (data/uci_synth.py), and 3- and
# 5-bit banks (T = 7, 31: the generic SmemBank path; N = 4 is RegBank<15>)
K2_CASES = ((1, 21, 5, 4), (7, 21, 5, 4), (129, 21, 5, 4),
            (128, 4, 3, 4), (128, 5, 3, 4), (128, 6, 3, 4), (128, 7, 3, 4), (128, 9, 3, 4),
            (128, 21, 5, 3), (128, 21, 5, 5))
K2_TOL = 1e-6  # 21-term fp32 sums, the reference's fused-vs-unfused bound


def phase_kernels(torch):
    """K2 and K3 against their plain versions (and K3's dw against the emulation
    of its order of summation, bit for bit), K3 with and without dx; a row alone
    equals the same row in the batch, two runs give the same bits, K2 the same
    bits at every tile of K2_TILES; times (K2 at each tile).  Then K2 at the
    shapes and bank widths of K2_CASES."""
    import dataclasses

    from repro_torch.kernels.fused_qat import ops, ref

    out = {}
    for B in (128, 638):
        x, thr, ids, w, b, g = kernel_inputs(torch, B, seed=B)
        before = dict(ops.LAUNCHES)
        y = ops.fused_forward(x, thr, ids, w, b, SCALE)
        dx, dw = ops.fused_backward(x, thr, ids, w, g, SCALE)
        torch.cuda.synchronize()
        launches_counted = {k: ops.LAUNCHES[k] - before[k] for k in before} == {
            "fused_qat_forward": 1, "fused_qat_backward": 1}
        fwd = lambda: ops.fused_forward(x, thr, ids, w, b, SCALE)  # noqa: E731
        y2 = fwd()
        y_alone = [ops.fused_forward(x[p:p + 1], thr[p:p + 1], ids[p:p + 1], w[p:p + 1],
                                     b[p:p + 1], SCALE)[0] for p in (0, P // 2, P - 1)]
        no_dx, dw_train = ops.fused_backward(x, thr, ids, w, g, SCALE, need_dx=False)
        dx2, dw2 = ops.fused_backward(x, thr, ids, w, g, SCALE)
        alone = [ops.fused_backward(x[p:p + 1], thr[p:p + 1], ids[p:p + 1], w[p:p + 1],
                                    g[p:p + 1], SCALE)[1][0] for p in (0, P // 2, P - 1)]
        y_ref = ref.fused_forward_tables(x, thr, ids, w, b, SCALE)
        dx_ref, dw_ref = ref.fused_backward_tables(x, thr, ids, w, g, SCALE)
        dw_emul = ref.fused_backward_emulation(x, thr, ids, w, g, SCALE)[1]
        tile_ms, tile_same = {}, True
        default_tile = ops.TILE
        try:
            for tile in K2_TILES:  # the same function at every tile, then its time
                ops.TILE = tile
                tile_same &= bool(torch.equal(fwd(), y))
                tile_ms[tile] = device_ms(torch, fwd)
        finally:
            ops.TILE = default_tile
        # forward and dx: 21- and 5-term fp32 sums, the reference's 1-ulp bound
        fwd_ok = torch.allclose(y, y_ref, rtol=K2_TOL, atol=K2_TOL)
        dx_ok = torch.allclose(dx, dx_ref, rtol=1e-6, atol=1e-6)
        # dw: B-term fp32 sums in two orders; bound each by the classic
        # recursive-summation error B * eps * sum|h g|, eps = 2^-23
        h = ref.dequant_ste_tables(x, thr, ids, SCALE)
        dw_tol = B * 2.0 ** -23 * torch.matmul(h.abs().transpose(1, 2), g.abs())
        dw_err = (dw - dw_ref).abs()
        checks = {
            "launches_counted": launches_counted,
            "forward": bool(fwd_ok), "dx": bool(dx_ok), "dw": bool((dw_err <= dw_tol).all()),
            "forward_same_bits_twice": bool(torch.equal(y2, y)),
            "forward_row_alone_equals_batch": all(
                bool(torch.equal(a, y[p])) for a, p in zip(y_alone, (0, P // 2, P - 1))),
            "forward_same_bits_every_tile": tile_same,
            "dw_equals_emulated_order": bool(torch.equal(dw, dw_emul)),
            "no_dx_when_not_asked": no_dx is None and bool(torch.equal(dw_train, dw)),
            "same_bits_twice": bool(torch.equal(dx2, dx)) and bool(torch.equal(dw2, dw)),
            "row_alone_equals_batch": all(
                bool(torch.equal(a, dw[p])) for a, p in zip(alone, (0, P // 2, P - 1))),
        }
        bwd = lambda need_dx: (  # noqa: E731
            lambda: ops.fused_backward(x, thr, ids, w, g, SCALE, need_dx=need_dx))
        rec = {
            "B": B,
            "forward_plan": dataclasses.asdict(ops.forward_plan(P, B, C, F, T)),
            "forward_max_abs_err": float((y - y_ref).abs().max()),
            "dx_max_abs_err": float((dx - dx_ref).abs().max()),
            "dw_max_abs_err": float(dw_err.max()),
            "dw_max_err_over_bound": float((dw_err / dw_tol.clamp(min=1e-30)).max()),
            "forward_ms": device_ms(torch, fwd),
            "forward_ms_by_tile": tile_ms,
            "forward_plain_ms": device_ms(
                torch, lambda: ref.fused_forward_tables(x, thr, ids, w, b, SCALE)),
            "backward_ms": device_ms(torch, bwd(True)),
            "backward_no_dx_ms": device_ms(torch, bwd(False)),
            "backward_plain_ms": device_ms(
                torch, lambda: ref.fused_backward_tables(x, thr, ids, w, g, SCALE)),
            "backward_no_dx_plain_ms": device_ms(
                torch, lambda: ref.fused_backward_tables(x, thr, ids, w, g, SCALE, False)),
            "forward_bound_ms": bound_ms(B, False)[0],
            "backward_bound_ms": bound_ms(B, True)[0],
            "backward_no_dx_bound_ms": bound_ms(B, True, need_dx=False)[0],
        }
        emit("kernels", **rec, checks=checks, ok=all(checks.values()))
        if not all(checks.values()):
            raise SystemExit(f"K2/K3 checks failed at B={B}: {checks}")
        out[B] = rec

    errs = []
    for Bc, Cc, Fc, n in K2_CASES:
        x, thr, ids, w, b, _ = kernel_inputs(torch, Bc, seed=1000 * Cc + Bc + n, C=Cc, F=Fc,
                                             n_bits=n)
        scale = 1.0 / (1 << n)
        n0 = ops.LAUNCHES["fused_qat_forward"]
        y = ops.fused_forward(x, thr, ids, w, b, scale)
        torch.cuda.synchronize()
        counted = ops.LAUNCHES["fused_qat_forward"] - n0 == 1
        y_ref = ref.fused_forward_tables(x, thr, ids, w, b, scale)
        errs.append(float((y - y_ref).abs().max()))
        checks = {"launch_counted": counted,
                  "forward": bool(torch.allclose(y, y_ref, rtol=K2_TOL, atol=K2_TOL)),
                  "same_bits_twice": bool(torch.equal(
                      y, ops.fused_forward(x, thr, ids, w, b, scale)))}
        emit("k2_shapes", B=Bc, C=Cc, F=Fc, n_bits=n,
             forward_plan=dataclasses.asdict(ops.forward_plan(P, Bc, Cc, Fc, thr.shape[-1])),
             max_abs_err=errs[-1], tol=K2_TOL, checks=checks, ok=all(checks.values()))
        if not all(checks.values()):
            raise SystemExit(f"K2 checks failed at B={Bc}, C={Cc}, F={Fc}, N={n}: {checks}")
    out["k2_shapes_max_abs_err"] = max(errs)
    return out


def phase_qat_profiler(torch) -> dict:
    """The profiler's count of device kernels a K2 call and a K3 call (K3 with
    and without dx), at B = 128 and 638: one each, and their kernel time.  Run
    after the co-design slice: once the profiler has run, kernel launches in
    the process cost the host more, and the slice's step times would carry
    that."""
    from repro_torch.kernels.fused_qat import ops

    out = {}
    for B in (128, 638):
        x, thr, ids, w, b, g = kernel_inputs(torch, B, seed=B)
        calls = {"forward": (lambda: ops.fused_forward(x, thr, ids, w, b, SCALE),
                             "fused_qat_fwd_kernel")}
        for name, need_dx in (("dx", True), ("no_dx", False)):
            calls[name] = (lambda nd=need_dx: ops.fused_backward(
                x, thr, ids, w, g, SCALE, need_dx=nd), "fused_qat_bwd_kernel")
        prof = {name: device_kernels(torch, fn) for name, (fn, _) in calls.items()}
        ok = all(v["kernels_per_call"] == 1 and v["records"] >= v["calls"] - PROFILER_LOST
                 and all(calls[name][1] in nm for nm in v["names"])
                 for name, v in prof.items())
        emit("qat_profiler", B=B, **prof, one_device_kernel_a_call=ok, ok=ok)
        if not ok:
            raise SystemExit(f"K2 or K3 is not one device kernel a call at B={B}: {prof}")
        out[B] = prof
    return out


def _cardio():
    from repro_torch.data import uci_synth

    X, y, spec = uci_synth.load("cardio")
    return uci_synth.stratified_split(X, y, 0.7, 0), (spec.n_features, spec.hidden,
                                                      spec.n_classes)


def _cardio_rows(n: int, seed: int):
    import numpy as np

    from repro_torch.core import chromosome

    rng = np.random.default_rng(seed)
    masks = rng.uniform(size=(n, C * 16)) < rng.uniform(0.1, 1.0, (n, 1))
    cats = np.stack([rng.integers(0, c, n) for c in chromosome.CAT_CARDINALITIES], 1)
    dec = chromosome.decode_batch(masks, cats, C, N_BITS)
    return (dec["masks"], dec["weight_bits"], dec["act_bits"], dec["batch_size"],
            dec["epochs"], dec["lr"]), rng.integers(0, 2**31 - 1, n).astype(np.int32)


def _same(torch, a, b) -> bool:
    """Two (acc, params) results of a row program, the same bits."""
    return bool(torch.equal(a[0], b[0])) and all(torch.equal(a[1][k], b[1][k]) for k in a[1])


def phase_placement(torch):
    """The captured graph against the eager loop, bit for bit, at P = 24 and
    at P = 5 (bucket 8); a row alone equals the same row in the batch; two
    runs of one batch give the same bits.  600 steps, blocks of S steps."""
    from repro_torch.core import qat, trainer

    (X_tr, y_tr, X_te, y_te), sizes = _cardio()
    mcfg, ecfg = qat.MLPConfig(sizes), trainer.EvalConfig(max_steps=600)
    run = trainer.make_row_program(X_tr, y_tr, X_te, y_te, mcfg, ecfg, device="cuda")
    eager = trainer.make_row_program(X_tr, y_tr, X_te, y_te, mcfg, ecfg, device="cuda",
                                     graph=False)
    rows, seeds = _cardio_rows(P, seed=7)
    params0, idx = trainer.draw_rows(seeds, ecfg, mcfg, X_tr.shape[0])
    t0 = time.perf_counter()
    out = run(*rows, params0, idx)  # captures bucket 24's graph, then replays it
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out2 = run(*rows, params0, idx)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = eager(*rows, params0, idx)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    alone_ok = True
    for p in (0, P // 2, P - 1):
        sl = slice(p, p + 1)
        a1, p1 = run(*(r[sl] for r in rows), {k: v[sl] for k, v in params0.items()}, idx[sl])
        alone_ok &= bool(torch.equal(a1[0], out[0][p])) and all(
            torch.equal(p1[k][0], out[1][k][p]) for k in p1)
    five = slice(3, 8)  # P = 5: padded to bucket 8 by repeating its last row
    rows5 = [r[five] for r in rows]
    p5 = {k: v[five] for k, v in params0.items()}
    g5, e5 = run(*rows5, p5, idx[five]), eager(*rows5, p5, idx[five])
    checks = {
        "graph_equals_eager_p24": _same(torch, out, ref),
        "graph_equals_eager_p5": _same(torch, g5, e5),
        "p5_equals_its_rows_in_p24": _same(torch, g5, (out[0][five], {
            k: v[five] for k, v in out[1].items()})),
        "alone_equals_batch": alone_ok,
        "run_to_run_equal": _same(torch, out, out2),
        "acc_finite": bool(torch.isfinite(out[0]).all()),
    }
    emit("placement", rows=P, steps=600, block_steps=ecfg.block_steps,
         first_call_s=first_s, batch_of_24_s=batch_s, eager_batch_of_24_s=eager_s,
         graph_stats=dict(run.stats), checks=checks, ok=all(checks.values()))
    if not all(checks.values()):
        raise SystemExit(f"placement checks failed: {checks}")


def phase_parity(torch):
    from repro_torch.core import qat, trainer

    (X_tr, y_tr, X_te, y_te), sizes = _cardio()
    mcfg, ecfg = qat.MLPConfig(sizes), trainer.EvalConfig(max_steps=600)
    rows, seeds = _cardio_rows(8, seed=11)
    params0, idx = trainer.draw_rows(seeds, ecfg, mcfg, X_tr.shape[0])
    accs = {}
    for dev in ("cuda", "cpu"):
        run = trainer.make_row_program(X_tr, y_tr, X_te, y_te, mcfg, ecfg, device=dev)
        accs[dev] = run(*rows, params0, idx)[0].cpu()
    gap = (accs["cuda"] - accs["cpu"]).abs()
    ok = bool((gap <= PARITY_BOUND).all()) and bool(torch.isfinite(accs["cuda"]).all())
    emit("parity", rows=8, steps=600, acc_card=accs["cuda"].tolist(),
         acc_cpu=accs["cpu"].tolist(), gap=gap.tolist(), bound=PARITY_BOUND, ok=ok)
    if not ok:
        raise SystemExit("the card's accuracies leave the bound measured on the CPU")


class EvaluatorTally:
    """The co-design evaluators made while installed, and their stats.

    Wraps ``trainer.make_population_evaluator`` (which the island evaluator
    and ``rebuild`` also go through) to keep each evaluator's ``stats``:
    calls, graphs captured, warm-up steps, replays.  From them the K2 and
    K3 launches of a run are exact: a call launches K2 once a step and once
    for its evaluation and K3 once a step, and each capture's warm-up steps
    launch both once."""

    def __init__(self):
        from repro_torch.core import trainer

        self.trainer, self.stats = trainer, []

    def __enter__(self):
        self.orig = make = self.trainer.make_population_evaluator

        def tallied(*a, **kw):
            ev = make(*a, **kw)
            self.stats.append(ev.stats)
            return ev

        self.trainer.make_population_evaluator = tallied
        return self

    def __exit__(self, *exc):
        self.trainer.make_population_evaluator = self.orig

    def total(self, key: str) -> int:
        return sum(st[key] for st in self.stats)

    def expected_launches(self, max_steps: int) -> dict:
        calls, warm = self.total("calls"), self.total("warmup_steps")
        return {"fused_qat_forward": calls * (max_steps + 1) + warm,
                "fused_qat_backward": calls * max_steps + warm}


def phase_slice(torch):
    import dataclasses

    import numpy as np

    from repro_torch.configs.printed_mlp import codesign_config
    from repro_torch.core import codesign
    from repro_torch.kernels.fused_qat import ops

    cfg = dataclasses.replace(codesign_config("cardio", full=True), n_generations=2,
                              device="cuda")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with EvaluatorTally() as tally:
        res = codesign.run_codesign(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    # evaluator calls: the seed population, each generation that trained
    # rows, and the 4-seed conventional baseline
    calls = 1 + sum(1 for r in res.history if r["n_evals"] > 0) + 1
    want = tally.expected_launches(cfg.max_steps)
    gen_s = [r["gen_s"] for r in res.history]
    step_s = [r["eval_s"] / cfg.max_steps for r in res.history if r["n_evals"] > 0]
    checks = {
        "front_nonempty": res.front_acc.size >= 1,
        "acc_finite_in_range": bool(np.isfinite(res.front_acc).all()
                                    and ((res.front_acc >= 0) & (res.front_acc <= 1)).all()),
        "level0_kept": bool(res.front_masks[:, :, 0].all()),
        "pruned_on_front": bool(res.front_area.min() < res.conv_area),
        "baseline_learns": res.conv_acc > 0.70,
        "evaluator_calls": tally.total("calls") == calls,
        "every_call_replayed": tally.total("replays") == calls * -(
            -cfg.max_steps // tally.trainer.EvalConfig().block_steps),
        "launch_counts": launches == want,
    }
    emit("slice", dataset="cardio", pop_size=cfg.pop_size, max_steps=cfg.max_steps,
         n_generations=cfg.n_generations, front_size=int(res.front_acc.size),
         front_acc=res.front_acc.tolist(), conv_acc=res.conv_acc,
         area_gain_at_5pct=codesign.gains_at_budget(res, 0.05)["area_gain"],
         n_evaluations=res.n_evaluations, n_memo_hits=res.n_memo_hits,
         evaluator_calls=calls, graph_stats={k: tally.total(k) for k in tally.stats[0]},
         launches=launches, expected_launches=want,
         seconds_per_generation=gen_s, seconds_per_step=step_s, wall_s=wall,
         checks=checks, ok=all(checks.values()))
    if not all(checks.values()):
        raise SystemExit(f"slice checks failed: {checks}")
    return launches


# the island runs of the campaign phase (seeds, CampaignConfig's defaults otherwise)
CAMPAIGN_ISLANDS = dict(num_islands=3, migration_interval=2, migration_size=1)
CAMPAIGN_CRASH_AT = 7  # the batch ordinal a drilled host failure interrupts


def _campaign_result(res, memo_path) -> dict:
    """What two runs of one search must agree on: front, counters, migrations, memo."""
    from repro_torch.core import memo_store

    memo = memo_store.load_memo(str(memo_path))
    return {"front_masks": res.front_masks, "front_cats": res.front_cats,
            "front_acc": res.front_acc, "n_evaluations": res.n_evaluations,
            "n_memo_hits": res.n_memo_hits, "migrations": res.migrations,
            "memo_keys": list(memo), "memo_objs": list(memo.values())}


def _same_result(a: dict, b: dict) -> bool:
    import numpy as np

    return all(np.array_equal(np.asarray(a[k]), np.asarray(b[k])) if k != "memo_keys"
               else a[k] == b[k] for k in a)


def phase_campaign(torch):
    """``run_campaign`` over the six datasets at ``CampaignConfig``'s defaults on the
    card, each dataset's memo kept under a memo_dir; the same campaign again with
    that memo_dir trains zero rows and finds the same fronts.  Then on seeds, with
    3 islands: the sequential, stacked and async drivers give identical fronts,
    counters, migrations and memos, and a run interrupted by a host failure at
    batch CAMPAIGN_CRASH_AT and resumed from its checkpoint equals the
    uninterrupted one.  K2/K3 launches are counted over the whole phase."""
    import dataclasses

    import numpy as np

    from repro_torch.core import campaign, codesign
    from repro_torch.kernels.fused_qat import ops
    from repro_torch.runtime import elastic, failure

    tmp = OUT / "campaign_tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    cfg = campaign.CampaignConfig(device="cuda", memo_dir=str(tmp / "memo"))
    ops.reset_launch_counts()
    with EvaluatorTally() as tally:
        t0 = time.perf_counter()
        res = campaign.run_campaign(cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rerun = campaign.run_campaign(cfg)
        base = dataclasses.replace(cfg.codesign_config("seeds"), memo_path=None,
                                   **CAMPAIGN_ISLANDS)
        drivers, island_s = {}, {}
        for name, kw in (("sequential", {}), ("stacked", {"stacked_islands": True}),
                         ("async", {"async_pipeline": True})):
            memo = tmp / f"islands_{name}"
            t0 = time.perf_counter()
            r = codesign.run_codesign(dataclasses.replace(base, memo_path=str(memo), **kw))
            island_s[name] = time.perf_counter() - t0
            drivers[name] = _campaign_result(r, memo)
        crash = elastic.DrillConfig(injector=failure.FailureInjector(
            crash_at_step=CAMPAIGN_CRASH_AT, crash_mode="host"))
        ck = str(tmp / "ck")
        try:
            codesign.run_codesign(dataclasses.replace(base, checkpoint_dir=ck, drill=crash))
            crashed = False
        except failure.HostFailure:
            crashed = True
        resumed_drill = elastic.DrillConfig()
        resumed = codesign.run_codesign(dataclasses.replace(
            base, checkpoint_dir=ck, resume=True, drill=resumed_drill,
            memo_path=str(tmp / "islands_resumed")))
        resumed = _campaign_result(resumed, tmp / "islands_resumed")
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    want = tally.expected_launches(cfg.max_steps)
    checks = {
        "six_datasets": sorted(res.results) == sorted(cfg.datasets),
        "fronts_nonempty_finite": all(
            r.front_acc.size >= 1 and bool(np.isfinite(r.front_acc).all())
            for r in res.results.values()),
        "trained_rows": all(r.n_evaluations > 0 for r in res.results.values()),
        "memo_rerun_trains_zero_rows": rerun.n_evaluations == 0,
        "memo_rerun_same_fronts": all(
            np.array_equal(rerun.results[d].front_acc, r.front_acc)
            and np.array_equal(rerun.results[d].front_masks, r.front_masks)
            for d, r in res.results.items()),
        "stacked_equals_sequential": _same_result(drivers["stacked"], drivers["sequential"]),
        "async_equals_sequential": _same_result(drivers["async"], drivers["sequential"]),
        "drill_interrupted": crashed,
        "resume_equals_uninterrupted": _same_result(resumed, drivers["sequential"]),
        "launch_counts": launches == want,
    }
    emit("campaign", datasets=list(cfg.datasets), pop_size=cfg.pop_size,
         n_generations=cfg.n_generations, max_steps=cfg.max_steps,
         step_scale=cfg.step_scale, wall_s=wall, wall_s_by_dataset=res.wall_s,
         rerun_wall_s_by_dataset=rerun.wall_s, n_evaluations=res.n_evaluations,
         n_memo_hits=res.n_memo_hits, rerun_n_memo_hits=rerun.n_memo_hits,
         mean_area_gain=res.mean_area_gain, mean_power_gain=res.mean_power_gain,
         gains={d: {k: g[k] for k in ("conv_acc", "acc", "area_gain", "power_gain")}
                for d, g in res.gains.items()},
         seconds_per_generation={d: [h["gen_s"] for h in r.history]
                                 for d, r in res.results.items()},
         islands=CAMPAIGN_ISLANDS, island_wall_s=island_s,
         island_n_evaluations=drivers["sequential"]["n_evaluations"],
         resumed_rows_dispatched=resumed_drill.rows_dispatched,
         graph_stats={k: tally.total(k) for k in tally.stats[0]},
         launches=launches, expected_launches=want, checks=checks,
         ok=all(checks.values()))
    print(res.table, flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    if not all(checks.values()):
        raise SystemExit(f"campaign checks failed: {checks}")
    return launches


def _kernel_table(torch, prof) -> dict[str, list]:
    """[launches, device us] by kernel name (its first 80 characters) of a profile."""
    kernels: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(e.name[:80], [0, 0.0])
            k[0] += 1
            k[1] += e.time_range.elapsed_us()
    return kernels


def _profiled(torch, fn, trace: str) -> dict:
    """Run ``fn`` once under the profiler: wall time, device busy time, the
    device's idle share of the window and the kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    OUT.mkdir(exist_ok=True)
    # gzipped: uncompressed, the traces of all the slices come to over 60 MB
    raw = OUT / trace
    prof.export_chrome_trace(str(raw))
    with open(raw, "rb") as src, gzip.open(f"{raw}.gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    raw.unlink()
    kernels = _kernel_table(torch, prof)
    device_us = sum(v[1] for v in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:15]
    # from the first device kernel's start to the last one's end: the idle
    # share of the device's own run, without the host work before it
    spans = [e.time_range for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    span_us = max(t.end for t in spans) - min(t.start for t in spans)
    return dict(wall_s=wall, device_busy_us=device_us,
                device_idle_share=1.0 - device_us / (wall * 1e6),
                device_span_us=span_us, span_idle_share=1.0 - device_us / span_us,
                kernel_launches=sum(v[0] for v in kernels.values()),
                top=[{"name": n, "launches": c, "device_us": us} for n, (c, us) in top])


PROFILE_GRAPH_STEPS = 200  # steps of the profiled call replayed from graphs


def phase_profile(torch):
    """Device time by kernel over a call of 24 cardio rows (its steps and their
    evaluation): 20 steps eager, and PROFILE_GRAPH_STEPS replayed from graphs
    (after a first, capturing call)."""
    from repro_torch.core import qat, trainer

    (X_tr, y_tr, X_te, y_te), sizes = _cardio()
    mcfg, ecfg = qat.MLPConfig(sizes), trainer.EvalConfig(max_steps=20)
    rows, seeds = _cardio_rows(P, seed=5)
    params0, idx = trainer.draw_rows(seeds, ecfg, mcfg, X_tr.shape[0])
    for version, graph in (("eager", False), ("graph", None)):
        if graph is None:  # long enough that a call's fixed host work is a small share
            ecfg = trainer.EvalConfig(max_steps=PROFILE_GRAPH_STEPS)
            params0, idx = trainer.draw_rows(seeds, ecfg, mcfg, X_tr.shape[0])
        run = trainer.make_row_program(X_tr, y_tr, X_te, y_te, mcfg, ecfg, device="cuda",
                                       graph=graph)
        run(*rows, params0, idx)
        torch.cuda.synchronize()
        trace = f"profile_{version}_{ecfg.max_steps}_steps.json"
        emit("profile", version=version, steps=ecfg.max_steps, rows=P,
             **_profiled(torch, lambda: run(*rows, params0, idx), trace))


# ---------------------------------------------------------------------------
# the LM serving slice: K4, K5 and yi-9b
# ---------------------------------------------------------------------------

# Kernel-vs-plain bounds on the card: the reference's own kernel-vs-oracle
# tolerances (tests/test_kernels_{flash,decode}_attn.py).  fp32: sums in
# another order; bf16: both round the fp32 result to bf16 (2^-8 relative).
ATTN_TOL = {"float32": 3e-5, "bfloat16": 3e-2}

# Card vs the port's CPU path on reduced yi-9b in fp32 (TF32 off): the bound
# of tests/test_torch_serving.py for the port against the JAX package, whose
# measured gap there was 3.6e-6.
LM_PARITY_TOL = 1e-4

# Decode vs prefill at full width in bf16: the decode logits must lie within
# DECODE_FLOOR_FACTOR times the bf16 prefill's own distance from an fp32
# evaluation of the same weights, measured in the same run.  Both bf16 paths
# round the same fp32 function at other places (another GEMM shape); a
# decode that attends to a wrong position or a stale cache lands O(1) away.
DECODE_FLOOR_FACTOR = 3.0

YI_PREFILL = (1, 4096, 4096, 32, 4, 128, True)    # B, Sq, Sk, Hq, Hkv, d, causal
FLASH_EDGES = [
    (1, 128, 128, 4, 4, 64, True),    # MHA causal
    (2, 96, 96, 8, 2, 32, True),      # GQA, ragged q/k tile edge
    (1, 64, 192, 4, 4, 64, False),    # cross-attention shape
    (2, 256, 256, 6, 2, 128, True),   # internvl2-like head ratio
    (1, 80, 80, 4, 4, 80, True),      # odd head_dim
    (1, 200, 200, 8, 1, 256, True),   # widest head dim, one KV head
]
YI_DECODE = (4, 32, 4, 4096, 128)                  # B, Hq, Hkv, S, d
DECODE_EDGES = [
    (1, 8, 8, 128, 64),      # MHA
    (2, 8, 2, 513, 64),      # GQA, ragged tile edge
    (2, 64, 8, 1024, 128),   # command-r-like heads
    (1, 32, 8, 777, 160),    # mistral-nemo-like head dim
    (3, 16, 16, 96, 80),     # zamba2-like
]


def flash_bound(torch, B, Sq, Sk, Hq, Hkv, d, causal, dtype) -> tuple[float, str]:
    """Least time of one K4 call: q, k, v read and out written once vs the
    products' FLOPs (causal: only the pairs with k <= q) at the type's peak."""
    nbytes = (2 * B * Sq * Hq * d + 2 * B * Sk * Hkv * d) * dtype.itemsize
    pairs = sum(min(i + 1, Sk) for i in range(Sq)) if causal else Sq * Sk
    peak = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
    return roofline(nbytes, 4 * B * Hq * d * pairs, peak)


def decode_bound(torch, B, Hq, Hkv, S, d, kv_len, dtype) -> tuple[float, str]:
    """Least time of one K5 call: the K/V rows up to kv_len, q, out and kv_len
    moved once vs the products' FLOPs over those rows at the type's peak."""
    rows = int(kv_len.clamp(max=S).sum())
    nbytes = (2 * B * Hq * d + 2 * rows * Hkv * d) * dtype.itemsize + 4 * B
    peak = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
    return roofline(nbytes, 4 * Hq * d * rows, peak)


def _close(torch, out, ref, dtype_name: str) -> tuple[float, bool]:
    tol = ATTN_TOL[dtype_name]
    err = float((out.float() - ref.float()).abs().max())
    return err, bool(torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol))


def phase_attn_kernels(torch):
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attn import ops as dops
    from repro_torch.kernels.decode_attn import ref as dref
    from repro_torch.kernels.flash_attn import ops as fops
    from repro_torch.kernels.flash_attn import ref as fref

    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {"flash_attention": {}, "decode_attention": {}}
    errs = {"flash_attention": [], "decode_attention": []}

    def rn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        for shape in (YI_PREFILL, *FLASH_EDGES):
            B, Sq, Sk, Hq, Hkv, d, causal = shape
            q, k, v = rn(B, Sq, Hq, d, dtype=dtype), rn(B, Sk, Hkv, d, dtype=dtype), rn(
                B, Sk, Hkv, d, dtype=dtype)
            variant = fops.variant(dtype, d)
            n0 = dict(fops.LAUNCHES)
            out = fops.flash_attention(q, k, v, causal)
            torch.cuda.synchronize()
            counted = {n: fops.LAUNCHES[n] - n0[n] for n in n0} == {
                "flash_attention": 1, "flash_attention_tc": int(variant == "tc"),
                "flash_attention_fp32": int(variant == "fp32")}
            err, ok = _close(torch, out, fref.flash_attention_ref(q, k, v, causal), dname)
            rec = {"kernel": "flash_attention", "variant": variant, "dtype": dname,
                   "shape": list(shape), "max_abs_err": err, "tol": ATTN_TOL[dname]}
            if shape == YI_PREFILL:
                qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
                bms, by = flash_bound(torch, *shape, dtype)
                rec.update(
                    ms=device_ms(torch, lambda: fops.flash_attention(q, k, v, causal), 3, 3),
                    plain_ms=device_ms(
                        torch, lambda: fref.flash_attention_ref(q, k, v, causal), 3, 3),
                    library_ms=device_ms(torch, lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal, enable_gqa=True), 10, 3),
                    bound_ms=bms, bound_by=by,
                    bound_ms_fp32_cuda_cores=flash_bound(torch, *shape, torch.float32)[0]
                    if dtype == torch.bfloat16 else None)
                res["flash_attention"][dname] = rec
            errs["flash_attention"].append(err)
            emit("attn_kernels", **rec, launch_counted=counted, ok=ok and counted)
            if not (ok and counted):
                raise SystemExit(f"K4 disagrees with its plain version: {rec}")

        cases = [(YI_DECODE, "ragged")] + [(s, "ragged") for s in DECODE_EDGES] + [
            ((2, 8, 4, 512, 64), "full"), ((2, 4, 2, 300, 64), "one"),
            ((2, 16, 4, 700, 128), "strided"), ((2, 8, 4, 512, 64), "none"),
            ((4, 8, 2, 513, 64), "empty"), ((3, 8, 4, 64, 64), "empty")]
        for shape, kind in cases:
            B, Hq, Hkv, S, d = shape
            q = rn(B, Hq, d, dtype=dtype)
            if kind == "strided":  # caches as views of a (B, Hkv, S, d) buffer
                k = rn(B, Hkv, S, d, dtype=dtype).transpose(1, 2)
                v = rn(B, Hkv, S, d, dtype=dtype).transpose(1, 2)
            else:
                k, v = rn(B, S, Hkv, d, dtype=dtype), rn(B, S, Hkv, d, dtype=dtype)
            if kind in ("full", "none"):  # "none": called with kv_len=None, the full cache
                kv_len = torch.full((B,), S, dtype=torch.int32, device="cuda")
            elif kind == "empty":  # rows with no position (NaN) beside others
                kv_len = torch.tensor([0, S // 2, -1, S][:B], dtype=torch.int32, device="cuda")
            elif kind == "one":
                kv_len = torch.ones(B, dtype=torch.int32, device="cuda")
            else:
                kv_len = torch.randint(1, S + 1, (B,), generator=gen, device="cuda",
                                       dtype=torch.int32)
                if shape == YI_DECODE:
                    kv_len[0], kv_len[1] = S, 1  # both ends of [1, S]
            call_len = None if kind == "none" else kv_len
            n0 = dops.LAUNCHES["decode_attention"]
            out = dops.decode_attention(q, k, v, call_len)
            torch.cuda.synchronize()
            counted = dops.LAUNCHES["decode_attention"] - n0 == 1
            want = dref.decode_attention_ref(q, k, v, kv_len)
            keep = kv_len > 0  # an empty row is NaN, in the plain version too
            err, ok = _close(torch, out[keep], want[keep], dname)
            empty_nan = bool(out[~keep].isnan().all()) and bool(want[~keep].isnan().all())
            # the merge runs in split order, whichever block is last: the same bits every run
            out2 = dops.decode_attention(q, k, v, call_len)
            same_bits = bool(torch.equal(out[keep], out2[keep])) and bool(
                out2[~keep].isnan().all())
            ok = ok and same_bits and empty_nan
            rec = {"kernel": "decode_attention", "dtype": dname, "shape": list(shape),
                   "cache": kind, "kv_len": kv_len.tolist(),
                   "n_split": dops.split_plan(B, Hkv, S)[0], "max_abs_err": err,
                   "tol": ATTN_TOL[dname], "same_bits_twice": same_bits,
                   "empty_rows_nan": empty_nan}
            if shape == YI_DECODE:
                mask = (torch.arange(S, device="cuda")[None, :] < kv_len[:, None])[:, None, None]
                q4, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
                bms, by = decode_bound(torch, *shape, kv_len, dtype)
                rec.update(
                    ms=kernel_ms(torch, lambda: dops.decode_attention(q, k, v, kv_len),
                                 K5_KERNEL),
                    wrapper_ms=device_ms(torch, lambda: dops.decode_attention(q, k, v, kv_len)),
                    plain_ms=device_ms(
                        torch, lambda: dref.decode_attention_ref(q, k, v, kv_len)),
                    library_ms=device_ms(torch, lambda: F.scaled_dot_product_attention(
                        q4, kt, vt, attn_mask=mask, enable_gqa=True)),
                    bound_ms=bms, bound_by=by)
                res["decode_attention"][dname] = rec
            errs["decode_attention"].append(err)
            emit("attn_kernels", **rec, launch_counted=counted, ok=ok and counted)
            if not (ok and counted):
                raise SystemExit(f"K5 disagrees with its plain version: {rec}")
    for kname, e in errs.items():
        res[kname]["max_abs_err"] = max(e)
    return res


SERVE_PARITY = dict(arch="yi-9b", reduced=True, max_batch=2, max_len=32, n_requests=4,
                    prompt_len=4, gen_len=6, seed=0, arrival_steps=(0, 0, 2, 24))


def phase_lm_parity(torch):
    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.kernels.flash_attn import ops as fops
    from repro_torch.launch import serve
    from repro_torch.models import build_model, init_cache

    k4_before = dict(fops.LAUNCHES)
    model = build_model(registry.reduced(registry.get("yi-9b")))
    params = {"cpu": model.init_params(torch.Generator().manual_seed(0))}
    params["cuda"] = {k: v.to("cuda") for k, v in params["cpu"].items()}
    served = {dev: serve.run(serve.ServeConfig(**SERVE_PARITY, device=dev), params=params[dev])
              for dev in ("cuda", "cpu")}
    fields = ("requests", "decode_steps", "peak_active", "first_token_step", "finish_step")
    served_equal = all(served["cuda"][f] == served["cpu"][f] for f in fields)

    B, S = 2, 12
    tokens = np.random.default_rng(0).integers(0, model.cfg.vocab_size, (B, S)).astype(np.int32)
    logits = {}
    for dev in ("cuda", "cpu"):
        tok = torch.from_numpy(tokens).to(dev)
        with torch.inference_mode():
            full, cache = model.prefill(params[dev], tok)
            c = init_cache(model, B, S, dev)
            kv_len = torch.zeros(B, dtype=torch.int32, device=dev)
            steps = []
            for t in range(S):
                lg, c = model.decode_step(params[dev], tok[:, t], c, kv_len)
                kv_len = kv_len + 1
                steps.append(lg)
        logits[dev] = (full.cpu(), torch.stack(steps, 1).cpu(), cache["k"].cpu(), c["k"].cpu())
    gaps = [float((a - b).abs().max()) for a, b in zip(logits["cuda"], logits["cpu"])]
    close = all(torch.allclose(a, b, rtol=LM_PARITY_TOL, atol=LM_PARITY_TOL)
                for a, b in zip(logits["cuda"], logits["cpu"]))
    top2 = logits["cpu"][1][..., : model.cfg.vocab_size].topk(2, dim=-1).values
    margin = float((top2[..., 0] - top2[..., 1]).min())
    k4_fp32 = fp32_variant_only(fops, k4_before)
    ok = served_equal and close and k4_fp32
    emit("lm_parity", arch="yi-9b (reduced, fp32)", served_equal=served_equal,
         k4_fp32_variant_only=k4_fp32,
         tokens_card=served["cuda"]["requests"], tokens_cpu=served["cpu"]["requests"],
         max_abs_gap={"prefill_logits": gaps[0], "decode_logits": gaps[1],
                      "prefill_cache_k": gaps[2], "decode_cache_k": gaps[3]},
         tol=LM_PARITY_TOL, min_top2_margin_decode=margin,
         near_tie=margin <= 2 * max(gaps), ok=ok)
    if not ok:
        raise SystemExit("the card's reduced yi-9b leaves the port's CPU path")


def _count_calls(module, name: str, counts: dict):
    """Wrap ``module.name`` so each call adds one to ``counts[name]``; returns the original."""
    orig = getattr(module, name)

    def counted(*a, **kw):
        counts[name] += 1
        return orig(*a, **kw)

    setattr(module, name, counted)
    return orig


def k4_variants(n: int, dtype: str = "bfloat16") -> dict:
    """K4's per-variant launch counts for n calls in one dtype: bf16 runs on
    the tensor-core kernel, fp32 on the CUDA-core one."""
    tc = n if dtype == "bfloat16" else 0
    return {"flash_attention_tc": tc, "flash_attention_fp32": n - tc}


def fp32_variant_only(fops, before: dict) -> bool:
    """True if K4 ran since ``before`` and every launch took the fp32 kernel."""
    d = {k: fops.LAUNCHES[k] - before[k] for k in before}
    return d["flash_attention"] > 0 and d == {"flash_attention": d["flash_attention"],
                                              **k4_variants(d["flash_attention"], "float32")}


def phase_lm_slice(torch, profile: bool = False):
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.kernels.decode_attn import ops as dops
    from repro_torch.kernels.flash_attn import ops as fops
    from repro_torch.launch import serve
    from repro_torch.models import build_model, exact_n_params, init_cache, transformer

    cfg = registry.get("yi-9b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_bytes = sum(p.numel() * p.element_size() for p in params.values())
    torch.cuda.reset_peak_memory_stats()
    serve_cfg = serve.ServeConfig(
        arch="yi-9b", reduced=False, max_batch=4, max_len=4096, n_requests=8, prompt_len=64,
        gen_len=32, arrival_steps=(0, 0, 0, 0, 8, 16, 24, 32), device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (1, 4096), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(1))
    calls = {"prefill": 0, "decode_step": 0}
    originals = {n: _count_calls(transformer, n, calls) for n in calls}
    try:
        # -- the main path: counts set to 0 just before, read just after
        fops.reset_launch_counts()
        dops.reset_launch_counts()
        prefill_ms = []
        with torch.inference_mode():
            for _ in range(2):  # the first call includes cuBLAS's set-up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, _ = model.prefill(params, tokens)
                torch.cuda.synchronize()
                prefill_ms.append((time.perf_counter() - t0) * 1e3)
            prefill_finite = bool(torch.isfinite(logits).all())
            del logits
        t0 = time.perf_counter()
        out = serve.run(serve_cfg, params=params)
        serve_s = time.perf_counter() - t0
        launches = {**fops.LAUNCHES, **dops.LAUNCHES}
        main_calls = dict(calls)
    finally:
        for n, f in originals.items():
            setattr(transformer, n, f)
    peak = torch.cuda.max_memory_allocated()

    with torch.inference_mode():
        # -- decode-step time at the serving batch, 64 positions in
        c = init_cache(model, 4, 4096, "cuda")
        kv_len = torch.full((4,), 64, dtype=torch.int32, device="cuda")
        tok = tokens[0, :4].contiguous()
        model.decode_step(params, tok, c, kv_len)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(16):
            model.decode_step(params, tok, c, kv_len + i)
        torch.cuda.synchronize()
        decode_step_ms = (time.perf_counter() - t0) / 16 * 1e3
        if profile:
            def four_steps():
                for i in range(4):
                    model.decode_step(params, tok, c, kv_len + 16 + i)

            emit("lm_profile", what="4 decode steps, B=4, 80 positions in",
                 **_profiled(torch, four_steps, "profile_yi9b_decode.json"))
            emit("lm_profile", what="prefill of 4096 tokens, B=1",
                 **_profiled(torch, lambda: model.prefill(params, tokens),
                             "profile_yi9b_prefill.json"))
        del c

        # -- decode vs prefill on a 64-token prompt, against an fp32 floor
        prompt = tokens[:, :64]
        pre, _ = model.prefill(params, prompt)
        c = init_cache(model, 1, 64, "cuda")
        kv_len = torch.zeros(1, dtype=torch.int32, device="cuda")
        dec = []
        for t in range(64):
            lg, c = model.decode_step(params, prompt[:, t], c, kv_len)
            kv_len = kv_len + 1
            dec.append(lg)
        dec = torch.stack(dec, 1).float()
        del c
        params32 = {k: v.float() for k, v in params.items()}
        f32, _ = transformer.prefill(params32, prompt, cfg)
        del params32
        pre = pre.float()
    gap = float((dec - pre).abs().max())
    floor = float((pre - f32).abs().max())
    dec_vs_f32 = float((dec - f32).abs().max())
    V = cfg.vocab_size
    argmax_agree = float((dec[..., :V].argmax(-1) == pre[..., :V].argmax(-1)).float().mean())
    consistent = gap <= DECODE_FLOOR_FACTOR * floor

    # -- scheduling independence: the same requests all at once
    again = serve.run(dataclasses.replace(serve_cfg, arrival_steps=()), params=params)
    same_tokens = again["requests"] == out["requests"]

    want = {"flash_attention": cfg.n_layers * main_calls["prefill"],
            "decode_attention": cfg.n_layers * main_calls["decode_step"]}
    want.update(k4_variants(want["flash_attention"]))
    n_dec = main_calls["decode_step"]
    checks = {
        "prefill_logits_finite": prefill_finite,
        "every_request_done": all(len(t) == serve_cfg.gen_len for t in out["requests"].values()),
        "tokens_in_vocab": all(0 <= x < V for t in out["requests"].values() for x in t),
        "launch_counts": launches == want and n_dec > 0 and main_calls["prefill"] > 0,
        "decode_matches_prefill": consistent,
        "scheduling_independent": same_tokens,
    }
    emit("lm_slice", arch="yi-9b", dtype=cfg.dtype, n_layers=cfg.n_layers,
         d_model=cfg.d_model, n_params=exact_n_params(cfg), param_bytes=n_bytes,
         init_s=init_s, peak_memory_bytes=peak, prefill_tokens=tokens.shape[1],
         prefill_ms=prefill_ms, serve=dataclasses.asdict(serve_cfg), serve_s=serve_s,
         decode_calls=n_dec, serve_ms_per_decode_call=serve_s / n_dec * 1e3,
         decode_step_ms_b4=decode_step_ms, tokens_generated=out["tokens_generated"],
         tokens_per_s=out["tokens_per_s"], decode_steps=out["decode_steps"],
         peak_active=out["peak_active"], first_token_step=out["first_token_step"],
         finish_step=out["finish_step"], calls=main_calls, launches=launches,
         expected_launches=want, decode_vs_prefill_max_abs=gap,
         prefill_bf16_vs_fp32_max_abs=floor, decode_bf16_vs_fp32_max_abs=dec_vs_f32,
         decode_tol=DECODE_FLOOR_FACTOR * floor, argmax_agreement=argmax_agree,
         checks=checks, ok=all(checks.values()))
    if not all(checks.values()):
        raise SystemExit(f"lm_slice checks failed: {checks}")
    return launches


# ---------------------------------------------------------------------------
# the pruned-ADC frontend slice: K1, internvl2-26b (VLM) and whisper-medium
# ---------------------------------------------------------------------------

# K1 against its plain version: integer levels, so tolerance 0.
VLM_PATCHES = (4, 256, 6144)     # 4 images x 256 patch tokens, internvl2-26b's d_model
AUDIO_FRAMES = (4, 1500, 1024)   # 4 x whisper's 30 s window after its conv stride
K1_RAGGED = [(1, 6144), (7, 6144), (1025, 6144), (1024, 21), (1024, 6143)]
# NaN, +-inf, below 0, -0.0, at and above vref
K1_EDGES = [math.nan, math.inf, -math.inf, -0.5, -0.0, 1.0, 1.5, 7.0]


# K1's bank widths (N bits, 2^N - 1 comparators): N <= 4 on its register path
# (one template instance a width), N = 5 and 8 on its generic loop; at ragged
# rows with an odd C (one channel a thread) and an even C (two)
K1_BITS = (1, 2, 3, 4, 5, 8)
K1_BITS_SHAPES = [(1025, 6143), (1025, 6142)]


def k1_inputs(torch, shape, mask_kind: str, seed: int, n_bits: int = 4, offset: int = 0):
    """fp32 x of ``shape`` with every threshold and the edge inputs planted, and a
    mask.  ``offset`` > 0 puts x that many floats into its buffer (a view whose
    data is not 8-byte aligned)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    C = shape[-1]
    n = 1 << n_bits
    x = rng.uniform(-0.1, 1.1, shape).astype(np.float32)
    flat = x.reshape(-1, C)
    k = min(flat.shape[0], n)
    flat[:k, 0] = np.arange(n, dtype=np.float32)[:k] / n  # exactly on each comparator
    for i, e in enumerate(K1_EDGES):
        flat[-1 - (i % flat.shape[0]), (C // 2 + i) % C] = e
    if mask_kind == "full":
        mask = np.ones((C, n), bool)
    elif mask_kind == "level0":
        mask = np.zeros((C, n), bool)
    else:
        mask = rng.uniform(size=(C, n)) < rng.uniform(0.1, 1.0, (C, 1))
    xt = torch.from_numpy(x).to("cuda")
    if offset:
        buf = torch.empty(x.size + offset, dtype=torch.float32, device="cuda")
        xt = buf[offset:].view(shape).copy_(xt)
    return xt, torch.from_numpy(mask).to("cuda")


def k1_bound(B: int, C: int, T: int = 15) -> tuple[float, str]:
    """Least time of one K1 call: x read and the int32 levels written once, the
    two (C, T) tables read once, vs a compare and a max per comparator at the
    fp32 peak."""
    return roofline(8 * B * C + 8 * C * T, 2 * B * C * T, FP32_FLOPS)


def phase_frontend_kernel(torch):
    """K1 against its plain version, tolerance 0: the served shapes with three
    masks, ragged shapes, every bank width (N in K1_BITS), an unaligned x; one
    launch a call; times at the served shapes beside plain, searchsorted and
    the bound."""
    from repro_torch.kernels.pruned_quant import ops as pq
    from repro_torch.kernels.pruned_quant import ref as pq_ref

    res = {}
    cases = [(s, m, 4, 0) for s in (VLM_PATCHES, AUDIO_FRAMES) for m in ("full", "random", "level0")]
    cases += [(s, "random", 4, 0) for s in K1_RAGGED]
    cases += [(s, "random", n, 0) for s in K1_BITS_SHAPES for n in K1_BITS]
    cases += [((1025, 6144), "random", 4, 1)]  # even C, x not 8-byte aligned: one channel a thread
    max_err = 0
    for i, (shape, mask_kind, n_bits, offset) in enumerate(cases):
        x, mask = k1_inputs(torch, shape, mask_kind, seed=100 + i, n_bits=n_bits, offset=offset)
        n0 = pq.LAUNCHES["pruned_quantize"]
        out = pq.pruned_quantize(x, mask, n_bits)
        torch.cuda.synchronize()
        counted = pq.LAUNCHES["pruned_quantize"] - n0 == 1
        thr, ids = pq_ref.make_tables(mask, n_bits)
        C = shape[-1]
        xf = x.reshape(-1, C)
        want = pq_ref.pruned_quantize_ref(xf, thr, ids).reshape(shape)
        equal = bool(torch.equal(out, want)) and out.dtype == torch.int32
        plan = pq.launch_plan(xf.shape[0], C, aligned=xf.data_ptr() % 8 == 0)
        rec = {"kernel": "pruned_quantize", "shape": list(shape), "mask": mask_kind,
               "n_bits": n_bits, "x_offset_floats": offset, "channels_a_thread": plan.width,
               "grid": [plan.grid_x, plan.grid_y], "rows_per_block": plan.rows_per_block,
               "max_abs_err": int((out - want).abs().max()), "tol": 0,
               "levels_seen": int(torch.unique(out).numel())}
        if mask_kind == "full" and shape in (VLM_PATCHES, AUDIO_FRAMES):
            B = xf.shape[0]
            xt = xf.T.contiguous()
            lib = lambda: torch.searchsorted(thr, xt, right=True, out_int32=True)  # noqa: E731
            seen = ~torch.isnan(xf)  # searchsorted orders NaN above every threshold
            sorted_ok = torch.equal(lib().T[seen], want.reshape(-1, C)[seen])
            bms, by = k1_bound(B, C)
            rec.update(
                ms=kernel_ms(torch, lambda: pq.pruned_quantize(x, mask), "pruned_quant_kernel"),
                wrapper_ms=device_ms(torch, lambda: pq.pruned_quantize(x, mask)),
                plain_ms=device_ms(torch, lambda: pq_ref.pruned_quantize_ref(xf, thr, ids)),
                library_ms=device_ms(torch, lib), library_equal_on_finite_inputs=sorted_ok,
                bound_ms=bms, bound_by=by)
            rec["share_of_bound"] = bms / rec["ms"]
            res["vlm" if shape == VLM_PATCHES else "audio"] = rec
        max_err = max(max_err, rec["max_abs_err"])
        emit("frontend_kernel", **rec, launch_counted=counted, ok=equal and counted)
        if not (equal and counted):
            raise SystemExit(f"K1 disagrees with its plain version: {rec}")
    res["max_abs_err"] = max_err
    return res


# K4 and K5 at the shapes the two new models give them (bf16): (B, Sq, Sk, Hq,
# Hkv, d, causal) and (B, Hq, Hkv, S, d, kv_len)
MM_FLASH = {
    "internvl2 prefill, 256 patches + 3840 tokens": (1, 4096, 4096, 48, 8, 128, True),
    "internvl2 requests, 4 x (256 + 64)": (4, 320, 320, 48, 8, 128, True),
    "whisper encode, 4 x 1500 frames": (4, 1500, 1500, 16, 16, 64, False),
    "whisper decode_train cross, 32 tokens": (4, 32, 1500, 16, 16, 64, False),
}
MM_DECODE = {
    "internvl2 decode, 320-351 positions": (4, 48, 8, 512, 128, (320, 331, 342, 351)),
    "whisper decode self, 1-32 positions": (4, 16, 16, 448, 64, (1, 11, 22, 32)),
    "whisper decode cross, 1500 positions": (4, 16, 16, 1500, 64, (1500,) * 4),
}
# q is drawn 4x wider than k and v, so the scores have std 4: each row's
# softmax is led by a few keys and the outputs are O(1) (RMS about 0.5).
# With unit q the outputs over 1500-4096 keys are softmax averages of RMS
# 0.03-0.04, as small as ATTN_TOL itself.  On the CPU, the plain version
# with one key or the last 28-key tile left out lies 0.15-4.5 from the
# full one at these shapes with this q, against 0.04-0.2 with unit q.
MM_Q_SCALE = 4.0


def phase_mm_attn_kernels(torch):
    """K4 and K5 against their plain versions at internvl2's and whisper's
    shapes (head dim 64, one query head a KV head, non-causal), with times."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attn import ops as dops
    from repro_torch.kernels.decode_attn import ref as dref
    from repro_torch.kernels.flash_attn import ops as fops
    from repro_torch.kernels.flash_attn import ref as fref

    gen = torch.Generator(device="cuda").manual_seed(3)
    dtype = torch.bfloat16

    def rn(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=gen, device="cuda")).to(dtype)

    def rms(t):
        return float(t.float().pow(2).mean().sqrt())

    res = {}
    for what, shape in MM_FLASH.items():
        B, Sq, Sk, Hq, Hkv, d, causal = shape
        q = rn(B, Sq, Hq, d, scale=MM_Q_SCALE)
        k, v = rn(B, Sk, Hkv, d), rn(B, Sk, Hkv, d)
        n0 = fops.LAUNCHES["flash_attention_tc"]
        out = fops.flash_attention(q, k, v, causal)
        torch.cuda.synchronize()
        tc = fops.LAUNCHES["flash_attention_tc"] - n0 == 1  # bf16 runs on the tensor cores
        want = fref.flash_attention_ref(q, k, v, causal)
        err, ok = _close(torch, out, want, "bfloat16")
        ok = ok and tc
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        bms, by = flash_bound(torch, *shape, dtype)
        n = 3 if Sq * Sk > 10**6 else 20
        rec = {"kernel": "flash_attention", "variant": "tc" if tc else "not tc",
               "what": what, "shape": list(shape),
               "q_scale": MM_Q_SCALE, "ref_rms": rms(want),
               "max_abs_err": err, "tol": ATTN_TOL["bfloat16"],
               "ms": device_ms(torch, lambda: fops.flash_attention(q, k, v, causal), n, 3),
               "plain_ms": device_ms(
                   torch, lambda: fref.flash_attention_ref(q, k, v, causal), n, 3),
               "library_ms": device_ms(torch, lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=causal, enable_gqa=True), n, 3),
               "bound_ms": bms, "bound_by": by}
        res[what] = rec
        emit("mm_attn_kernels", **rec, ok=ok)
        if not ok:
            raise SystemExit(f"K4 disagrees with its plain version: {rec}")
    for what, (B, Hq, Hkv, S, d, lens) in MM_DECODE.items():
        q = rn(B, Hq, d, scale=MM_Q_SCALE)
        k, v = rn(B, S, Hkv, d), rn(B, S, Hkv, d)
        kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
        out = dops.decode_attention(q, k, v, kv_len)
        torch.cuda.synchronize()
        want = dref.decode_attention_ref(q, k, v, kv_len)
        err, ok = _close(torch, out, want, "bfloat16")
        same_bits = bool(torch.equal(out, dops.decode_attention(q, k, v, kv_len)))
        ok = ok and same_bits
        mask = (torch.arange(S, device="cuda")[None, :] < kv_len[:, None])[:, None, None]
        q4, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
        bms, by = decode_bound(torch, B, Hq, Hkv, S, d, kv_len, dtype)
        rec = {"kernel": "decode_attention", "what": what, "shape": [B, Hq, Hkv, S, d],
               "kv_len": list(lens), "n_split": dops.split_plan(B, Hkv, S)[0],
               "q_scale": MM_Q_SCALE, "ref_rms": rms(want),
               "max_abs_err": err, "tol": ATTN_TOL["bfloat16"], "same_bits_twice": same_bits,
               "ms": kernel_ms(torch, lambda: dops.decode_attention(q, k, v, kv_len),
                               K5_KERNEL),
               "plain_ms": device_ms(torch, lambda: dref.decode_attention_ref(q, k, v, kv_len)),
               "library_ms": device_ms(torch, lambda: F.scaled_dot_product_attention(
                   q4, kt, vt, attn_mask=mask, enable_gqa=True)),
               "bound_ms": bms, "bound_by": by}
        res[what] = rec
        emit("mm_attn_kernels", **rec, ok=ok)
        if not ok:
            raise SystemExit(f"K5 disagrees with its plain version: {rec}")
    return res


def _greedy(torch, model, params, cache, tok, kv_len, n: int, V: int):
    """n greedy decode steps from ``tok`` at ``kv_len``: the tokens (B, n) and
    each step's logits (B, n, padded vocab)."""
    toks, logits = [], []
    for _ in range(n):
        lg, cache = model.decode_step(params, tok, cache, kv_len)
        kv_len = kv_len + 1
        tok = lg[:, :V].argmax(-1).to(torch.int32)
        toks.append(tok)
        logits.append(lg)
    return torch.stack(toks, 1), torch.stack(logits, 1)


def phase_vlm_parity(torch):
    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.core.frontend import FrontendConfig, PrunedQuantFrontend
    from repro_torch.kernels.flash_attn import ops as fops
    from repro_torch.models import build_model, init_cache, transformer

    k4_before = dict(fops.LAUNCHES)
    model = build_model(registry.reduced(registry.get("internvl2-26b")))
    cfg = model.cfg
    params = {"cpu": model.init_params(torch.Generator().manual_seed(0))}
    params["cuda"] = {k: v.to("cuda") for k, v in params["cpu"].items()}
    rng = np.random.default_rng(0)
    B, S, n_new = 2, 6, 8
    P = cfg.frontend_len
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    pe = rng.uniform(0, 1, (B, P, cfg.d_model)).astype(np.float32)
    pe[0, 0, :16] = np.arange(16) / 16
    out = {}
    for dev in ("cuda", "cpu"):
        tok, emb = torch.from_numpy(tokens).to(dev), torch.from_numpy(pe).to(dev)
        with torch.inference_mode():
            pre, cache = model.prefill(params[dev], tok, emb)
            fwd = transformer.forward(params[dev], tok, cfg, emb)
            levels = PrunedQuantFrontend(FrontendConfig(cfg.d_model)).to(dev).levels(emb)
            c = init_cache(model, B, P + S + n_new, dev)
            for n in ("k", "v"):
                c[n][:, :, : P + S] = cache[n]
            first = pre[:, -1, : cfg.vocab_size].argmax(-1).to(torch.int32)
            kv_len = torch.full((B,), P + S, dtype=torch.int32, device=dev)
            toks, dec = _greedy(torch, model, params[dev], c, first, kv_len, n_new,
                                cfg.vocab_size)
        out[dev] = [t.cpu() for t in (pre, fwd, cache["k"], dec, levels, toks)]
    gaps = [float((a.float() - b.float()).abs().max()) for a, b in zip(out["cuda"], out["cpu"])]
    close = all(torch.allclose(a, b, rtol=LM_PARITY_TOL, atol=LM_PARITY_TOL)
                for a, b in zip(out["cuda"][:4], out["cpu"][:4]))
    levels_equal = bool(torch.equal(out["cuda"][4], out["cpu"][4]))
    tokens_equal = bool(torch.equal(out["cuda"][5], out["cpu"][5]))
    k4_fp32 = fp32_variant_only(fops, k4_before)
    ok = close and levels_equal and tokens_equal and k4_fp32
    emit("vlm_parity", arch="internvl2-26b (reduced, fp32)", patches=P, tokens=S,
         max_abs_gap={"prefill_logits": gaps[0], "forward_logits": gaps[1],
                      "prefill_cache_k": gaps[2], "decode_logits": gaps[3]},
         tol=LM_PARITY_TOL, frontend_levels_equal=levels_equal,
         greedy_tokens_card=out["cuda"][5].tolist(), greedy_tokens_equal=tokens_equal,
         k4_fp32_variant_only=k4_fp32, ok=ok)
    if not ok:
        raise SystemExit("the card's reduced internvl2 leaves the port's CPU path")


WHISPER_SOT = 50258  # whisper's <|startoftranscript|>


def phase_audio_parity(torch):
    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.core.frontend import FrontendConfig, PrunedQuantFrontend
    from repro_torch.kernels.flash_attn import ops as fops
    from repro_torch.models import build_model, init_cache, whisper

    k4_before = dict(fops.LAUNCHES)
    model = build_model(registry.reduced(registry.get("whisper-medium")))
    cfg = model.cfg
    params = {"cpu": model.init_params(torch.Generator().manual_seed(0))}
    params["cuda"] = {k: v.to("cuda") for k, v in params["cpu"].items()}
    rng = np.random.default_rng(1)
    B, T, n_new = 2, 12, 8
    frames = rng.uniform(0, 1, (B, T, cfg.d_model)).astype(np.float32)
    frames[0, 0, :16] = np.arange(16) / 16
    out = {}
    for dev in ("cuda", "cpu"):
        fr = torch.from_numpy(frames).to(dev)
        with torch.inference_mode():
            enc = whisper.encode(params[dev], fr, cfg)
            levels = PrunedQuantFrontend(FrontendConfig(cfg.d_model)).to(dev).levels(fr)
            c = init_cache(model, B, T, dev)
            c["cross_k"], c["cross_v"] = whisper.build_cross_cache(params[dev], enc, cfg)
            start = torch.full((B,), 1, dtype=torch.int32, device=dev)
            kv_len = torch.zeros(B, dtype=torch.int32, device=dev)
            toks, dec = _greedy(torch, model, params[dev], c, start, kv_len, n_new,
                                cfg.vocab_size)
            teacher = torch.cat([start[:, None], toks[:, :-1]], 1)
            train = whisper.decode_train(params[dev], teacher, enc, cfg)
        out[dev] = [t.cpu() for t in (enc, c["cross_k"], dec, train, levels, toks)]
    gaps = [float((a.float() - b.float()).abs().max()) for a, b in zip(out["cuda"], out["cpu"])]
    close = all(torch.allclose(a, b, rtol=LM_PARITY_TOL, atol=LM_PARITY_TOL)
                for a, b in zip(out["cuda"][:4], out["cpu"][:4]))
    levels_equal = bool(torch.equal(out["cuda"][4], out["cpu"][4]))
    tokens_equal = bool(torch.equal(out["cuda"][5], out["cpu"][5]))
    k4_fp32 = fp32_variant_only(fops, k4_before)
    ok = close and levels_equal and tokens_equal and k4_fp32
    emit("audio_parity", arch="whisper-medium (reduced, fp32)", frames=T,
         max_abs_gap={"encode": gaps[0], "cross_cache_k": gaps[1], "decode_logits": gaps[2],
                      "decode_train_logits": gaps[3]},
         tol=LM_PARITY_TOL, frontend_levels_equal=levels_equal,
         greedy_tokens_card=out["cuda"][5].tolist(), greedy_tokens_equal=tokens_equal,
         k4_fp32_variant_only=k4_fp32, ok=ok)
    if not ok:
        raise SystemExit("the card's reduced whisper leaves the port's CPU path")


def _free_device(torch) -> int:
    """Release what the previous phase left in PyTorch's cache; bytes still allocated."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def _reset_all_counts():
    from repro_torch.kernels.decode_attn import ops as dops
    from repro_torch.kernels.flash_attn import ops as fops
    from repro_torch.kernels.pruned_quant import ops as pq

    for m in (pq, fops, dops):
        m.reset_launch_counts()
    return lambda: {**pq.LAUNCHES, **fops.LAUNCHES, **dops.LAUNCHES}


VLM_CUT_LAYERS = 8  # the fp32 floor of decode vs prefill is taken on this cut
VLM_LONG = 4096     # positions of the long prefill: 256 patches + 3840 tokens


def phase_vlm_slice(torch, profile: bool = False):
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.core import adc
    from repro_torch.kernels.pruned_quant import ref as pq_ref
    from repro_torch.models import build_model, exact_n_params, init_cache, transformer

    allocated_before = _free_device(torch)
    cfg = registry.get("internvl2-26b")
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_bytes = sum(p.numel() * p.element_size() for p in params.values())
    V, P = cfg.vocab_size, cfg.frontend_len
    gen = torch.Generator(device="cuda").manual_seed(1)
    B, S_text, n_new, S_cache = 4, 64, 32, 512
    pe = torch.rand((B, P, cfg.d_model), generator=gen, device="cuda")
    text = torch.randint(0, V, (B, S_text), generator=gen, device="cuda")
    long_pe = torch.rand((1, P, cfg.d_model), generator=gen, device="cuda")
    long_text = torch.randint(0, V, (1, VLM_LONG - P), generator=gen, device="cuda")
    calls = {"prefill": 0, "decode_step": 0}
    originals = {n: _count_calls(transformer, n, calls) for n in calls}
    try:
        # -- the main path: counts set to 0 just before, read just after
        read_counts = _reset_all_counts()
        with torch.inference_mode():
            request_prefill_ms = []
            for _ in range(2):  # the first call includes cuBLAS's set-up for these shapes
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, pre_cache = model.prefill(params, text, pe)
                torch.cuda.synchronize()
                request_prefill_ms.append((time.perf_counter() - t0) * 1e3)
            prefill_finite = bool(torch.isfinite(logits).all())
            cache = init_cache(model, B, S_cache, "cuda")
            for n in ("k", "v"):
                cache[n][:, :, : P + S_text] = pre_cache[n]
            del pre_cache
            first = logits[:, -1, :V].argmax(-1).to(torch.int32)
            del logits
            kv_len = torch.full((B,), P + S_text, dtype=torch.int32, device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks, dec_logits = _greedy(torch, model, params, cache, first, kv_len, n_new, V)
            torch.cuda.synchronize()
            decode_step_ms = (time.perf_counter() - t0) / n_new * 1e3
            decode_finite = bool(torch.isfinite(dec_logits).all())
            del dec_logits
            long_ms = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lg, _ = model.prefill(params, long_text, long_pe)
                torch.cuda.synchronize()
                long_ms.append((time.perf_counter() - t0) * 1e3)
            long_finite = bool(torch.isfinite(lg).all())
            del lg
        launches = read_counts()
        main_calls = dict(calls)
    finally:
        for n, f in originals.items():
            setattr(transformer, n, f)
    peak = torch.cuda.max_memory_allocated()

    with torch.inference_mode():
        if profile:
            def four_steps():
                _greedy(torch, model, params, cache, first, kv_len + n_new, 4, V)

            emit("vlm_profile", what="4 decode steps, B=4, 352 positions in",
                 **_profiled(torch, four_steps, "profile_internvl2_decode.json"))
            emit("vlm_profile", what="prefill of 256 patches + 3840 tokens, B=1",
                 **_profiled(torch, lambda: model.prefill(params, long_text, long_pe),
                             "profile_internvl2_prefill.json"))
        del cache
        # -- the frontend at full width: grid values are its fixed points, so
        # the plain version's quantized patches give the kernel's bits
        thr, ids = pq_ref.make_tables(torch.ones(cfg.d_model, 16, dtype=torch.bool,
                                                 device="cuda"), cfg.frontend_adc_bits)
        on_grid = adc.levels_to_values(pq_ref.pruned_quantize_ref(pe, thr, ids),
                                       cfg.frontend_adc_bits)
        a, _ = model.prefill(params, text, pe)
        b, _ = model.prefill(params, text, on_grid)
        frontend_bits_equal = bool(torch.equal(a, b))
        del a, b

        # -- decode vs prefill on an 8-layer cut of the same full-width weights
        cut = dataclasses.replace(cfg, n_layers=VLM_CUT_LAYERS)
        params8 = {k: v[:VLM_CUT_LAYERS] if k in transformer._LAYER_KEYS else v
                   for k, v in params.items()}
        prompt, pe1 = text[:1], pe[:1]
        pre, c1 = transformer.prefill(params8, prompt[:, :1], cut, pe1)
        c = init_cache(build_model(cut), 1, P + S_text, "cuda")
        for n in ("k", "v"):
            c[n][:, :, : P + 1] = c1[n]
        kv = torch.full((1,), P + 1, dtype=torch.int32, device="cuda")
        dec = []
        for t in range(1, S_text):
            lg, c = transformer.decode_step(params8, prompt[:, t], c, kv, cut)
            kv = kv + 1
            dec.append(lg)
        dec = torch.stack(dec, 1).float()
        full, _ = transformer.prefill(params8, prompt, cut, pe1)
        full = full[:, P + 1:].float()
        del c, c1, pre
        params32 = {k: v.float() for k, v in params8.items()}
        f32, _ = transformer.prefill(params32, prompt, cut, pe1)
        f32 = f32[:, P + 1:]
        del params32, params8
    gap = float((dec - full).abs().max())
    floor = float((full - f32).abs().max())
    argmax_agree = float((dec[..., :V].argmax(-1) == full[..., :V].argmax(-1)).float().mean())
    del params
    want = {"pruned_quantize": main_calls["prefill"],
            "flash_attention": cfg.n_layers * main_calls["prefill"],
            "decode_attention": cfg.n_layers * main_calls["decode_step"]}
    want.update(k4_variants(want["flash_attention"]))
    checks = {
        "prefill_logits_finite": prefill_finite and long_finite,
        "decode_logits_finite": decode_finite,
        "tokens_in_vocab": bool(((toks >= 0) & (toks < V)).all()),
        "launch_counts": launches == want and main_calls == {"prefill": 4, "decode_step": n_new},
        "frontend_fixed_point_bits_equal": frontend_bits_equal,
        "decode_matches_prefill_on_cut": gap <= DECODE_FLOOR_FACTOR * floor,
    }
    emit("vlm_slice", arch="internvl2-26b", dtype=cfg.dtype, n_layers=cfg.n_layers,
         d_model=cfg.d_model, n_params=exact_n_params(cfg), param_bytes=n_bytes,
         allocated_before_bytes=allocated_before, init_s=init_s, peak_memory_bytes=peak,
         requests=B, patches=P, text_tokens=S_text, request_prefill_ms=request_prefill_ms,
         decode_steps=n_new, decode_step_ms_b4=decode_step_ms,
         tokens=toks.tolist(), long_prefill_positions=VLM_LONG, long_prefill_ms=long_ms,
         calls=main_calls, launches=launches, expected_launches=want,
         decode_check_cut_layers=VLM_CUT_LAYERS, decode_vs_prefill_max_abs=gap,
         prefill_bf16_vs_fp32_max_abs=floor, decode_tol=DECODE_FLOOR_FACTOR * floor,
         argmax_agreement=argmax_agree, checks=checks, ok=all(checks.values()))
    if not all(checks.values()):
        raise SystemExit(f"vlm_slice checks failed: {checks}")
    return launches


def phase_audio_slice(torch, profile: bool = False):
    from repro_torch.configs import registry
    from repro_torch.models import build_model, exact_n_params, init_cache, whisper

    allocated_before = _free_device(torch)
    cfg = registry.get("whisper-medium")
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    n_bytes = sum(p.numel() * p.element_size() for p in params.values())
    V = cfg.vocab_size
    B, T, n_new = AUDIO_FRAMES[0], AUDIO_FRAMES[1], 32
    frames = torch.rand(AUDIO_FRAMES, generator=torch.Generator(device="cuda").manual_seed(1),
                        device="cuda")
    start = torch.full((B,), WHISPER_SOT, dtype=torch.int32, device="cuda")
    calls = {"encode": 0, "decode_step": 0}
    originals = {n: _count_calls(whisper, n, calls) for n in calls}
    try:
        # -- the main path: counts set to 0 just before, read just after
        read_counts = _reset_all_counts()
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            enc = whisper.encode(params, frames, cfg)
            torch.cuda.synchronize()
            encode_ms = (time.perf_counter() - t0) * 1e3
            cache = init_cache(model, B, T, "cuda")
            cache["cross_k"], cache["cross_v"] = whisper.build_cross_cache(params, enc, cfg)
            kv_len = torch.zeros(B, dtype=torch.int32, device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks, dec = _greedy(torch, model, params, cache, start, kv_len, n_new, V)
            torch.cuda.synchronize()
            decode_step_ms = (time.perf_counter() - t0) / n_new * 1e3
        launches = read_counts()
        main_calls = dict(calls)
    finally:
        for n, f in originals.items():
            setattr(whisper, n, f)
    peak = torch.cuda.max_memory_allocated()

    with torch.inference_mode():
        if profile:
            emit("audio_profile", what="encode, B=4 x 1500 frames",
                 **_profiled(torch, lambda: whisper.encode(params, frames, cfg),
                             "profile_whisper_encode.json"))
            emit("audio_profile", what="4 decode steps, B=4, 32 positions in",
                 **_profiled(torch, lambda: _greedy(torch, model, params, cache, start,
                                                    kv_len + n_new, 4, V),
                             "profile_whisper_decode.json"))
        # -- the steps against the teacher-forced decoder, and its fp32 floor
        teacher = torch.cat([start[:, None], toks[:, :-1]], 1)
        train = whisper.decode_train(params, teacher, enc, cfg).float()
        params32 = {k: v.float() for k, v in params.items()}
        f32 = whisper.decode_train(params32, teacher, whisper.encode(params32, frames, cfg), cfg)
        del params32
    dec = dec.float()
    gap = float((dec - train).abs().max())
    floor = float((train - f32).abs().max())
    argmax_agree = float((dec[..., :V].argmax(-1) == train[..., :V].argmax(-1)).float().mean())
    want = {"pruned_quantize": main_calls["encode"],
            "flash_attention": cfg.encoder_layers * main_calls["encode"],
            "decode_attention": 2 * cfg.n_layers * main_calls["decode_step"]}
    want.update(k4_variants(want["flash_attention"]))
    checks = {
        "encode_finite": bool(torch.isfinite(enc).all()),
        "decode_logits_finite": bool(torch.isfinite(dec).all()),
        "tokens_in_vocab": bool(((toks >= 0) & (toks < V)).all()),
        "launch_counts": launches == want and main_calls == {"encode": 1, "decode_step": n_new},
        "decode_matches_decode_train": gap <= DECODE_FLOOR_FACTOR * floor,
    }
    emit("audio_slice", arch="whisper-medium", dtype=cfg.dtype,
         encoder_layers=cfg.encoder_layers, decoder_layers=cfg.n_layers, d_model=cfg.d_model,
         n_params=exact_n_params(cfg), param_bytes=n_bytes,
         allocated_before_bytes=allocated_before, peak_memory_bytes=peak, batch=B, frames=T,
         encode_ms=encode_ms, decode_steps=n_new, decode_step_ms_b4=decode_step_ms,
         tokens=toks.tolist(), calls=main_calls, launches=launches, expected_launches=want,
         decode_vs_decode_train_max_abs=gap, decode_train_bf16_vs_fp32_max_abs=floor,
         decode_tol=DECODE_FLOOR_FACTOR * floor, argmax_agreement=argmax_agree,
         checks=checks, ok=all(checks.values()))
    if not all(checks.values()):
        raise SystemExit(f"audio_slice checks failed: {checks}")
    return launches


def build_all(torch) -> None:
    """Build every kernel library at once: one nvcc per source, in parallel;
    then print what ptxas reported for each kernel (registers, static shared
    memory, spills)."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attn import ops as dops
    from repro_torch.kernels.flash_attn import ops as fops
    from repro_torch.kernels.fused_qat import ops as qops
    from repro_torch.kernels.pruned_quant import ops as pq

    def timed(build):
        t0 = time.perf_counter()
        so = build()
        return so, time.perf_counter() - t0

    t0 = time.perf_counter()
    builds = {"fused_qat": qops.build, "decode_attn": dops.build, "flash_attn": fops.build,
              "flash_attn_tc": fops.build_tc, "pruned_quant": pq.build}
    with ThreadPoolExecutor(len(builds)) as pool:
        futures = {name: pool.submit(timed, b) for name, b in builds.items()}
        built = {name: f.result() for name, f in futures.items()}
    emit("build", seconds=time.perf_counter() - t0,
         libraries={n: str(so.relative_to(ROOT)) for n, (so, _) in built.items()},
         seconds_each={n: s for n, (_, s) in built.items()})
    for n, (so, _) in built.items():
        report = _build.ptxas_report(so)
        emit("ptxas", library=n, kernels=report)
        # the register paths keep their comparator tables in registers (N = 4):
        # K1's RegBank<15, W>, one kernel for each W, and K2's RegBank<15>; a
        # spill would put the tables back in memory
        want = {"pruned_quant": 2, "fused_qat": 1}.get(n)
        if want:
            spills = {k["kernel"]: k["spill_stores"] + k["spill_loads"] for k in report
                      if "RegBank" in k["kernel"]}
            if len(spills) != want or any(spills.values()):
                raise SystemExit(f"{n}'s register-path kernels spill or are missing: {spills}")


def _load_ops(path: Path, name: str):
    """Import the ops module of another checkout's kernel beside this one's
    (once: a second call returns the module the first made)."""
    import importlib.util

    if name in sys.modules:
        return sys.modules[name]

    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # dataclasses look their module up while they are made
    spec.loader.exec_module(mod)
    return mod


DECODE_AB_ROUNDS, DECODE_BLOCK_STEPS = 4, 16  # rounds of 4 blocks (A B B A) of 16 steps
# (arch, cache length, positions in at the first step): the serving slices' decode
DECODE_STEP_CASES = (("yi-9b", 4096, 64), ("internvl2-26b", 512, 320),
                     ("whisper-medium", 1500, 1))


def phase_decode_ab(torch, other_src: Path):
    """Wall time of a decode step at B=4 of each served model at full width
    and depth, with K5 alternately this checkout's and the one under
    ``other_src`` (its ``repro_torch/kernels/decode_attn``, loaded beside
    this one; everything else of the step is this checkout's).  Blocks of
    DECODE_BLOCK_STEPS steps run in the order other, this, this, other, each
    timed on the host clock between two synchronisations, in one process on
    one card: the steps are host-bound, so separate processes (or machines)
    differ by more than the kernels do.  Weights, caches and tokens are
    drawn from seeds.  Then 4 steps of each version under the profiler give
    the device busy time a step and K5's device time a call."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import registry
    from repro_torch.kernels.decode_attn import ops as dops
    from repro_torch.models import build_model, init_cache, transformer

    other = _load_ops(other_src / "repro_torch" / "kernels" / "decode_attn" / "ops.py",
                      "other_decode_attn_ops")
    versions = {"this": dops, "other": other}
    order = ["other", "this", "this", "other"] * DECODE_AB_ROUNDS
    try:
        for arch, S, kv0 in DECODE_STEP_CASES:
            _free_device(torch)
            cfg = registry.get(arch)
            model = build_model(cfg)
            params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
            gen = torch.Generator(device="cuda").manual_seed(1)
            with torch.inference_mode():
                cache = init_cache(model, 4, S, "cuda")
                for n in ("cross_k", "cross_v"):  # whisper's encoder states, drawn
                    if n in cache:
                        cache[n].normal_(generator=gen)
                tok = torch.randint(0, cfg.vocab_size, (4,), generator=gen, device="cuda",
                                    dtype=torch.int32)
                kv_len = torch.full((4,), kv0, dtype=torch.int32, device="cuda")
                logits = {}
                for name, ops in versions.items():  # each K5 builds at its first call
                    transformer.decode_ops = ops
                    for i in range(4):
                        logits[name], _ = model.decode_step(params, tok, cache, kv_len + i)
                    ops.reset_launch_counts()
                block_ms = {name: [] for name in versions}
                for name in order:
                    transformer.decode_ops = versions[name]
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for i in range(DECODE_BLOCK_STEPS):
                        model.decode_step(params, tok, cache, kv_len + i)
                    torch.cuda.synchronize()
                    block_ms[name].append((time.perf_counter() - t0) / DECODE_BLOCK_STEPS * 1e3)
            n_steps = 2 * DECODE_AB_ROUNDS * DECODE_BLOCK_STEPS
            calls = {n: ops.LAUNCHES["decode_attention"] / n_steps for n, ops in versions.items()}
            device = {}
            for name, ops in versions.items():
                transformer.decode_ops = ops
                with torch.inference_mode(), profile(
                        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    for i in range(4):
                        model.decode_step(params, tok, cache, kv_len + i)
                    torch.cuda.synchronize()
                kt = _kernel_table(torch, prof)
                k5 = [v for n, v in kt.items() if "decode_attn" in n]
                device[name] = {
                    "busy_ms_per_step": sum(v[1] for v in kt.values()) / 4e3,
                    "k5_us_per_call": sum(v[1] for v in k5) / (4 * calls[name]),
                    "k5_kernels_per_call": sum(v[0] for v in k5) / (4 * calls[name])}
            gap = float((logits["this"].float() - logits["other"].float()).abs().max())
            checks = {"logits_finite": all(bool(torch.isfinite(x).all()) for x in logits.values()),
                      "k5_on_every_layer": set(calls.values()) == {
                          float(cfg.n_layers * (2 if arch == "whisper-medium" else 1))}}
            emit("decode_ab", arch=arch, other_src=str(other_src), batch=4, cache_len=S,
                 kv_len_first=kv0, steps_per_block=DECODE_BLOCK_STEPS, order=order,
                 block_ms=block_ms,
                 median_ms={n: statistics.median(b) for n, b in block_ms.items()},
                 k5_calls_per_step=calls, device=device,
                 logits_this_vs_other_max_abs=gap, checks=checks,
                 ok=all(checks.values()))
            del params, cache, logits
            if not all(checks.values()):
                raise SystemExit(f"decode_ab {arch}: {checks}")
    finally:
        transformer.decode_ops = dops


AB_ROUNDS = 4  # rounds of 4 blocks (other, this, this, other) in --kernel-ab


def phase_kernel_ab(torch, other_src: Path):
    """K1, K2 and K3 of this checkout against those of ``other_src`` (another
    checkout's src, e.g. the parent commit's), both built from their own
    sources and loaded in one process on one card.  Each case runs in blocks,
    other, this, this, other, AB_ROUNDS times: a block is the CUDA-event time
    of a call (device_ms, the stream kept busy) and, from the profiler, the
    device kernels a call and their summed time.  Cases: K1 at internvl2-26b's
    patch and whisper-medium's frame shapes (full banks; the event time holds
    the wrapper's table build, the profiler's the kernel alone), K3 at the
    training shape with dx (what earlier PRs timed) and without (what training
    calls), K2 at the training (B = 128) and evaluation (B = 638) shapes.
    Both versions are first held against the plain versions; K2's two
    versions must also give the same bits."""
    from repro_torch.kernels.fused_qat import ops as qops
    from repro_torch.kernels.fused_qat import ref as qref
    from repro_torch.kernels.pruned_quant import ops as pq
    from repro_torch.kernels.pruned_quant import ref as pq_ref

    kdir = other_src / "repro_torch" / "kernels"
    versions = {
        "this": (pq, qops),
        "other": (_load_ops(kdir / "pruned_quant" / "ops.py", "other_pruned_quant_ops"),
                  _load_ops(kdir / "fused_qat" / "ops.py", "other_fused_qat_ops")),
    }
    cases = {}
    for label, shape in (("k1_internvl2", VLM_PATCHES), ("k1_whisper", AUDIO_FRAMES)):
        x, mask = k1_inputs(torch, shape, "full", seed=7)
        thr, ids = pq_ref.make_tables(mask, N_BITS)
        want = pq_ref.pruned_quantize_ref(x.reshape(-1, shape[-1]), thr, ids).reshape(shape)
        cases[label] = ({n: (lambda m=m[0], x=x, mask=mask: m.pruned_quantize(x, mask))
                         for n, m in versions.items()}, "pruned_quant", want, None)
    x, thr, ids, w, _, g = kernel_inputs(torch, 128, seed=128)
    _, dw_ref = qref.fused_backward_tables(x, thr, ids, w, g, SCALE)
    h = qref.dequant_ste_tables(x, thr, ids, SCALE)
    dw_tol = 128 * 2.0 ** -23 * torch.matmul(h.abs().transpose(1, 2), g.abs())
    for label, need_dx in (("k3_training_no_dx", False), ("k3_with_dx", True)):
        cases[label] = ({n: (lambda m=m[1], nd=need_dx: m.fused_backward(
            x, thr, ids, w, g, SCALE, need_dx=nd)) for n, m in versions.items()},
            "", dw_ref, dw_tol)
    for B in (128, 638):
        x2, thr2, ids2, w2, b2, _ = kernel_inputs(torch, B, seed=B)
        cases[f"k2_B{B}"] = ({n: (lambda m=m[1], a=(x2, thr2, ids2, w2, b2): m.fused_forward(
            *a, SCALE)) for n, m in versions.items()}, "",
            qref.fused_forward_tables(x2, thr2, ids2, w2, b2, SCALE), K2_TOL)
    order = ["other", "this", "this", "other"] * AB_ROUNDS
    for label, (fns, match, want, tol) in cases.items():
        checks, got = {}, {}
        for n, fn in fns.items():  # builds each version's library at its first call
            got[n] = fn()
            torch.cuda.synchronize()
            if tol is None:
                checks[f"{n}_equals_plain"] = bool(torch.equal(got[n], want))
            elif isinstance(tol, float):
                checks[f"{n}_within_tol_of_plain"] = bool(
                    torch.allclose(got[n], want, rtol=tol, atol=tol))
            else:
                checks[f"{n}_within_bound"] = bool(((got[n][1] - want).abs() <= tol).all())
        if isinstance(tol, float):  # K2's redesign keeps the first design's bits
            checks["this_equals_other"] = bool(torch.equal(got["this"], got["other"]))
        blocks = {n: {"event_ms": [], "kernel_us": [], "kernels_per_call": []} for n in fns}
        for n in order:
            blocks[n]["event_ms"].append(device_ms(torch, fns[n], n=50, repeats=3))
            prof = device_kernels(torch, fns[n], n=20, match=match)
            blocks[n]["kernel_us"].append(prof["kernel_us_per_call"])
            blocks[n]["kernels_per_call"].append(prof["kernels_per_call"])
        med = {n: {k: statistics.median(v) for k, v in b.items()} for n, b in blocks.items()}
        emit("kernel_ab", case=label, other_src=str(other_src), order=order, blocks=blocks,
             median=med,
             other_over_this_kernel=med["other"]["kernel_us"] / med["this"]["kernel_us"],
             other_over_this_event=med["other"]["event_ms"] / med["this"]["event_ms"],
             checks=checks, ok=all(checks.values()))
        if not all(checks.values()):
            raise SystemExit(f"kernel_ab {label}: {checks}")


STEP_AB_STEPS = 200  # training steps a block in --kernel-ab's co-design case


def phase_step_ab(torch, other_src: Path):
    """Wall time of a co-design training step (24 cardio rows, the slice's
    shapes: B = 128, C = 21, F = 5), with the fused QAT layer (K2 forward,
    K3 backward) alternately this checkout's and the one under
    ``other_src``; everything else of the step is this checkout's.  A block
    is one row program of STEP_AB_STEPS steps and its 638-sample evaluation,
    timed on the host clock between two synchronisations and divided by the
    steps; blocks run other, this, this, other, AB_ROUNDS times, in one
    process on one card (the step is host-bound: two processes differ by
    more than the kernels do).  Both versions train to the same parameters
    and accuracies, bit for bit, where their K2 and K3 give the same bits.
    The row program is the eager loop (``graph=False``), as before the
    population step had its CUDA graph, so its step times stay comparable
    with the earlier measurements of this case."""
    from repro_torch.core import qat, trainer
    from repro_torch.kernels.fused_qat import ops as qops

    other = _load_ops(other_src / "repro_torch" / "kernels" / "fused_qat" / "ops.py",
                      "other_fused_qat_ops")
    versions = {"this": qops, "other": other}
    (X_tr, y_tr, X_te, y_te), sizes = _cardio()
    mcfg, ecfg = qat.MLPConfig(sizes), trainer.EvalConfig(max_steps=STEP_AB_STEPS)
    run = trainer.make_row_program(X_tr, y_tr, X_te, y_te, mcfg, ecfg, device="cuda",
                                   graph=False)
    rows, seeds = _cardio_rows(P, seed=5)
    params0, idx = trainer.draw_rows(seeds, ecfg, mcfg, X_tr.shape[0])
    order = ["other", "this", "this", "other"] * AB_ROUNDS
    try:
        trained = {}
        for name, ops in versions.items():  # a first run of each, then the counts
            qat.fused_qat_first_layer = ops.fused_qat_first_layer
            trained[name] = run(*rows, params0, idx)
            ops.reset_launch_counts()
        step_ms = {name: [] for name in versions}
        for name in order:
            qat.fused_qat_first_layer = versions[name].fused_qat_first_layer
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(*rows, params0, idx)
            torch.cuda.synchronize()
            step_ms[name].append((time.perf_counter() - t0) / STEP_AB_STEPS * 1e3)
    finally:
        qat.fused_qat_first_layer = qops.fused_qat_first_layer
    blocks = 2 * AB_ROUNDS
    launches = {n: {k: v / blocks for k, v in ops.LAUNCHES.items()} for n, ops in versions.items()}
    (acc, params), (acc_o, params_o) = trained["this"], trained["other"]
    med = {n: statistics.median(b) for n, b in step_ms.items()}
    checks = {"same_accuracies": bool(torch.equal(acc, acc_o)),
              "same_parameters": all(torch.equal(params[k], params_o[k]) for k in params),
              "kernels_every_step": all(
                  v == {"fused_qat_forward": STEP_AB_STEPS + 1,
                        "fused_qat_backward": STEP_AB_STEPS} for v in launches.values())}
    emit("kernel_ab", case="codesign_step", other_src=str(other_src), rows=P,
         steps_per_block=STEP_AB_STEPS, order=order, step_ms=step_ms, median_step_ms=med,
         other_minus_this_ms=med["other"] - med["this"], launches_per_block=launches,
         checks=checks, ok=all(checks.values()))
    if not all(checks.values()):
        raise SystemExit(f"kernel_ab codesign_step: {checks}")


S_CANDIDATES = (10, 25, 50, 100, 200)  # block lengths --step-ab times against each other
GRAPH_AB_ROUNDS = 3  # rounds of (eager, graph at each S, ..., eager) in --step-ab
GEN_AB_ROUNDS = 2  # rounds of (eager, graph, graph, eager) co-design runs in --step-ab


def phase_graph_ab(torch):
    """The captured graph against the eager loop, in turns, in one process.

    Steps: 24 cardio rows (the slice's shapes), one 600-step call a block,
    eager and the graph at each block length of S_CANDIDATES in the order
    eager, S..., S reversed, eager, GRAPH_AB_ROUNDS times; a block's wall
    time (host clock between two synchronisations) over its steps.  Every
    version trains to the same parameters and accuracies, bit for bit.  The
    first call of each S captures its graphs: that time is kept apart.
    Generations: ``run_codesign`` on cardio (pop 24, 600 steps, 2
    generations), the evaluators alternately eager and graphed (eager,
    graph, graph, eager, GEN_AB_ROUNDS times), seconds a generation from
    its history; the two searches give the same fronts.  Then each under the
    profiler (``phase_profile``): device busy time and idle share."""
    import dataclasses
    import functools

    import numpy as np

    from repro_torch.configs.printed_mlp import codesign_config
    from repro_torch.core import codesign, qat, trainer

    (X_tr, y_tr, X_te, y_te), sizes = _cardio()
    mcfg = qat.MLPConfig(sizes)
    rows, seeds = _cardio_rows(P, seed=5)
    programs, first_call_s = {}, {}
    for name in ["eager"] + [f"S{S}" for S in S_CANDIDATES]:
        ecfg = trainer.EvalConfig(max_steps=600, block_steps=int(name[1:]) if name[0] == "S"
                                  else trainer.EvalConfig().block_steps)
        programs[name] = trainer.make_row_program(
            X_tr, y_tr, X_te, y_te, mcfg, ecfg, device="cuda",
            graph=None if name[0] == "S" else False)
    params0, idx = trainer.draw_rows(seeds, trainer.EvalConfig(max_steps=600), mcfg,
                                     X_tr.shape[0])
    trained = {}
    for name, run in programs.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trained[name] = run(*rows, params0, idx)
        torch.cuda.synchronize()
        first_call_s[name] = time.perf_counter() - t0
    graphs = [n for n in programs if n != "eager"]
    order = (["eager"] + graphs + graphs[::-1] + ["eager"]) * GRAPH_AB_ROUNDS
    step_ms = {n: [] for n in programs}
    for name in order:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        programs[name](*rows, params0, idx)
        torch.cuda.synchronize()
        step_ms[name].append((time.perf_counter() - t0) / 600 * 1e3)
    med = {n: statistics.median(v) for n, v in step_ms.items()}
    checks = {f"{n}_equals_eager": _same(torch, trained[n], trained["eager"]) for n in graphs}
    emit("graph_ab", case="steps", rows=P, steps_per_block=600, order=order,
         step_ms=step_ms, median_step_ms=med,
         eager_over_graph={n: med["eager"] / med[n] for n in graphs},
         first_call_s=first_call_s, stats={n: dict(r.stats) for n, r in programs.items()},
         checks=checks, ok=all(checks.values()))
    if not all(checks.values()):
        raise SystemExit(f"graph_ab steps: {checks}")

    make = trainer.make_population_evaluator
    cfg = dataclasses.replace(codesign_config("cardio", full=True), n_generations=2,
                              device="cuda")
    gen_s, fronts = {"eager": [], "graph": []}, {}
    try:
        for name in ["eager", "graph", "graph", "eager"] * GEN_AB_ROUNDS:
            trainer.make_population_evaluator = (
                functools.partial(make, graph=False) if name == "eager" else make)
            res = codesign.run_codesign(cfg)
            gen_s[name].append([h["gen_s"] for h in res.history])
            fronts[name] = (res.front_acc, res.front_masks, res.n_evaluations)
    finally:
        trainer.make_population_evaluator = make
    same = all(np.array_equal(a, b) for a, b in zip(fronts["eager"], fronts["graph"]))
    emit("graph_ab", case="generations", dataset="cardio", pop_size=cfg.pop_size,
         max_steps=cfg.max_steps, n_generations=cfg.n_generations, gen_s=gen_s,
         median_gen_s={n: statistics.median(x for g in v for x in g) for n, v in gen_s.items()},
         checks={"same_fronts": same}, ok=same)
    if not same:
        raise SystemExit("graph_ab generations: eager and graphed searches differ")

    phase_profile(torch)


def phase_capture_fails(torch):
    """A capture that fails raises, and the trainer does not fall back to the
    eager loop: a step that reads a value back to the host while it is being
    captured (here an injected ``float(logits.sum())``) ends the call with an
    error, no graph is cached, and only the warm-up's K2/K3 launches ran.
    Run last: the failed capture leaves the CUDA stream state to the driver."""
    from repro_torch.core import qat, trainer
    from repro_torch.kernels.fused_qat import ops

    (X_tr, y_tr, X_te, y_te), sizes = _cardio()
    mcfg, ecfg = qat.MLPConfig(sizes), trainer.EvalConfig(max_steps=20)
    run = trainer.make_row_program(X_tr, y_tr, X_te, y_te, mcfg, ecfg, device="cuda")
    rows, seeds = _cardio_rows(4, seed=3)
    params0, idx = trainer.draw_rows(seeds, ecfg, mcfg, X_tr.shape[0])
    cross_entropy = qat.cross_entropy

    def reads_host(logits, labels):
        if torch.cuda.is_current_stream_capturing():
            float(logits.sum())  # a host read: not capturable
        return cross_entropy(logits, labels)

    before = dict(ops.LAUNCHES)
    qat.cross_entropy = reads_host
    try:
        run(*rows, params0, idx)
        error = None
    except RuntimeError as e:
        error = f"{type(e).__name__}: {e}"[:300]
    finally:
        qat.cross_entropy = cross_entropy
    launched = {k: ops.LAUNCHES[k] - before[k] for k in before}
    checks = {"capture_raised": error is not None,
              "no_graph_cached": run.stats["captures"] == 0 and run.stats["replays"] == 0,
              "only_warmup_launched": launched == {
                  "fused_qat_forward": trainer.WARMUP_STEPS,
                  "fused_qat_backward": trainer.WARMUP_STEPS}}
    emit("capture_fails", error=error, launches=launched, stats=dict(run.stats),
         checks=checks, ok=all(checks.values()))
    if not all(checks.values()):
        raise SystemExit(f"capture_fails: {checks}")


ENCODE_AB_CALLS = 4  # encodes a block in --kernel-ab's whisper case


def phase_encode_ab(torch, other_src: Path):
    """Wall time of whisper-medium's ``encode`` (B=4 x 1500 frames, full width
    and depth, bf16), with K1 alternately this checkout's and the one under
    ``other_src``; everything else of the call is this checkout's.  Blocks of
    ENCODE_AB_CALLS calls run other, this, this, other, AB_ROUNDS times, each
    timed on the host clock between two synchronisations, in one process on
    one card.  K1 is bit-equal to its plain version in both, so both give the
    same encoder states, bit for bit."""
    from repro_torch.configs import registry
    from repro_torch.core import frontend
    from repro_torch.kernels.pruned_quant import ops as pq
    from repro_torch.models import build_model, whisper

    _free_device(torch)
    versions = {"this": pq, "other": _load_ops(
        other_src / "repro_torch" / "kernels" / "pruned_quant" / "ops.py",
        "other_pruned_quant_ops")}
    cfg = registry.get("whisper-medium")
    params = build_model(cfg).init_params(torch.Generator(device="cuda").manual_seed(0))
    frames = torch.rand(AUDIO_FRAMES, generator=torch.Generator(device="cuda").manual_seed(1),
                        device="cuda")
    order = ["other", "this", "this", "other"] * AB_ROUNDS
    try:
        with torch.inference_mode():
            enc = {}
            for name, ops in versions.items():  # each K1 builds at its first call
                frontend.pq_ops = ops
                enc[name] = whisper.encode(params, frames, cfg)
                ops.reset_launch_counts()
            block_ms = {name: [] for name in versions}
            for name in order:
                frontend.pq_ops = versions[name]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(ENCODE_AB_CALLS):
                    whisper.encode(params, frames, cfg)
                torch.cuda.synchronize()
                block_ms[name].append((time.perf_counter() - t0) / ENCODE_AB_CALLS * 1e3)
    finally:
        frontend.pq_ops = pq
    calls = {n: ops.LAUNCHES["pruned_quantize"] / (2 * AB_ROUNDS * ENCODE_AB_CALLS)
             for n, ops in versions.items()}
    med = {n: statistics.median(b) for n, b in block_ms.items()}
    checks = {"same_encoder_states": bool(torch.equal(enc["this"], enc["other"])),
              "encoder_states_finite": bool(torch.isfinite(enc["this"]).all()),
              "k1_once_a_call": calls == {"this": 1.0, "other": 1.0}}
    emit("kernel_ab", case="whisper_encode", other_src=str(other_src), batch=AUDIO_FRAMES[0],
         frames=AUDIO_FRAMES[1], calls_per_block=ENCODE_AB_CALLS, order=order,
         block_ms=block_ms, median_ms=med, k1_calls_per_encode=calls,
         other_minus_this_ms=med["other"] - med["this"], checks=checks,
         ok=all(checks.values()))
    del params, enc
    if not all(checks.values()):
        raise SystemExit(f"kernel_ab whisper_encode: {checks}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import resolve_device

    resolve_device("cuda")  # fp32 matmuls: TF32 off
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    emit("device", kind=name, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    if "--decode-ab" in args:
        phase_decode_ab(torch, Path(args[args.index("--decode-ab") + 1]).resolve())
        return 0
    profile = "--profile" in args
    build_all(torch)
    if "--attn" in args:  # a kernel change's first call: build, check, time, stop
        phase_attn_kernels(torch)
        phase_mm_attn_kernels(torch)
        return 0
    if "--step-ab" in args:  # the graph checked against the eager loop, then timed
        phase_placement(torch)
        phase_graph_ab(torch)
        phase_capture_fails(torch)
        return 0
    if "--kernel-ab" in args:  # K1/K3 checked, then timed against another checkout's
        phase_kernels(torch)
        phase_qat_profiler(torch)
        phase_frontend_kernel(torch)
        other_src = Path(args[args.index("--kernel-ab") + 1]).resolve()
        phase_kernel_ab(torch, other_src)
        phase_step_ab(torch, other_src)
        phase_encode_ab(torch, other_src)
        return 0
    kern = phase_kernels(torch)
    phase_placement(torch)
    phase_parity(torch)
    launches = phase_slice(torch)
    for kname, n in phase_campaign(torch).items():
        launches[kname] += n
    phase_qat_profiler(torch)
    if profile:
        phase_profile(torch)
    attn = phase_attn_kernels(torch)
    phase_lm_parity(torch)
    k1 = phase_frontend_kernel(torch)
    phase_mm_attn_kernels(torch)
    phase_vlm_parity(torch)
    phase_audio_parity(torch)
    # each serving path's launches, read from its own run, summed over the paths
    for path in (phase_lm_slice, phase_vlm_slice, phase_audio_slice):
        for kname, n in path(torch, profile=profile).items():
            launches[kname] = launches.get(kname, 0) + n

    train = kern[128]
    rows = []
    # K3 as training calls it: without dx (x needs no gradient)
    for key, kname, line in (("forward", "fused_qat_forward", 76),
                             ("backward_no_dx", "fused_qat_backward", 84)):
        bms, by = bound_ms(128, key != "forward", need_dx=False)
        rows.append({
            "name": kname,
            "route": "cuda",
            "source": "src/repro_torch/kernels/fused_qat/csrc/fused_qat.cu",
            "replaces": f"src/repro/kernels/fused_qat/fused_qat.py:{line}",
            "launches": launches[kname],
            "max_abs_err": max(
                [kern[B][e] for B in (128, 638)
                 for e in (("forward_max_abs_err",) if key == "forward"
                           else ("dx_max_abs_err", "dw_max_abs_err"))]
                + ([kern["k2_shapes_max_abs_err"]] if key == "forward" else [])),
            "ms": train[f"{key}_ms"],
            "plain_ms": train[f"{key}_plain_ms"],
            "bound_ms": bms,
            "bound_by": by,
            "library_ms": None,
        })
    # bf16 serving runs K4's tensor-core variant; its launches are that variant's
    for kname, counter, src, line in (
            ("flash_attention", "flash_attention_tc", "flash_attn/csrc/flash_attn_tc.cu",
             "src/repro/kernels/flash_attn/flash_attn.py:29"),
            ("decode_attention", "decode_attention", "decode_attn/csrc/decode_attn.cu",
             "src/repro/kernels/decode_attn/decode_attn.py:36")):
        main_path = attn[kname]["bfloat16"]  # yi-9b's shapes in its dtype
        rows.append({
            "name": kname,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/{src}",
            "replaces": line,
            "launches": launches[counter],
            "max_abs_err": attn[kname]["max_abs_err"],
            "ms": main_path["ms"],
            "plain_ms": main_path["plain_ms"],
            "bound_ms": main_path["bound_ms"],
            "bound_by": main_path["bound_by"],
            "library_ms": main_path["library_ms"],
        })
    rows.append({
        "name": "pruned_quantize",
        "route": "cuda",
        "source": "src/repro_torch/kernels/pruned_quant/csrc/pruned_quant.cu",
        "replaces": "src/repro/kernels/pruned_quant/pruned_quant.py:30",
        "launches": launches["pruned_quantize"],
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["vlm"]["ms"],  # internvl2-26b's patch shape, 1024 x 6144
        "plain_ms": k1["vlm"]["plain_ms"],
        "bound_ms": k1["vlm"]["bound_ms"],
        "bound_by": k1["vlm"]["bound_by"],
        "library_ms": k1["vlm"]["library_ms"],
    })
    if not all(math.isfinite(r["ms"]) and r["launches"] > 0 for r in rows):
        raise SystemExit(f"a kernel has no time or was not launched on its path: {rows}")
    phase_capture_fails(torch)
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
