#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py             # build, check every kernel, run every slice
    python3 chip_smoke.py --profile   # also profile 20 training steps, a graphed call
                                      # ADC-only and with the genome axes, a refine call,
                                      # a wave of the evaluation service,
                                      # and decode steps and a prefill (or encode) of
                                      # each served model (gzipped traces to OUT)
    python3 chip_smoke.py --service   # build, then phase 6d only (the evaluation
                                      # service; with --profile, its wave profiled),
                                      # and stop: no result lines
    python3 chip_smoke.py --attn      # build, then phases 7 and 10 only (K4/K5 checked
                                      # and timed), and one kernels line: the row of
                                      # K4's narrower-v instance
    python3 chip_smoke.py --kexaone   # build, then phases 7, 17c and 17b only (K4's
                                      # window and the norm kernel checked and timed,
                                      # K-EXAONE's served path), and one kernels line:
                                      # the window's and the norm's rows
    python3 chip_smoke.py --train     # build, then phases 18-22 only (LM training; with
                                      # --profile, a full-width step profiled), and
                                      # stop: no result lines
    python3 chip_smoke.py --mesh      # build, then phases 23-28 only (the multi-device
                                      # layer on the card's 1-rank mesh, the dry run),
                                      # and stop: no result lines
    python3 chip_smoke.py --examples  # build, then phases 29-31 only (the twins of the
                                      # reference's adc_codesign, quickstart and
                                      # serve_lm examples), and stop: no result lines
    python3 chip_smoke.py --families  # build, then phases 11b and 15-17 only (the MoE,
                                      # RWKV-6 and Zamba2 families; with --profile,
                                      # profiled), and stop: no result lines

A change is timed against its parent by the benchmark (``python3
cardbench/run.py --workload <cell> ...``, parent and change on one card),
not here: this script checks, counts and times each kernel alone, with
its bound from ``cardbench/counts``.

Phases, one JSON line each; any failure ends the run with a nonzero exit:

1. device       the card's name, count, power limit.
2. build        every kernel library, built with nvcc for sm_90a from the
                repository's sources, one nvcc per source, all at once; then
                one ``ptxas`` line a library: each kernel's registers, static
                shared memory and spills, from ``nvcc -Xptxas -v``; a spill in
                a kernel of K1's or K2's register path (N = 4) or in a head
                instance of the training step with fixed widths fails the run.
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
3b. qat_step   (after phase 6d: it opens profiler sessions)
                the training step's kernels (``ops.qat_step``: qat_step_prep,
                K2, qat_step_head, K3, qat_step_update) against the plain chain
                they replace (``trainer._chain_step``) and its written-out
                backward (``ref.qat_step``),
                bit for bit over 10 steps, at P = 24 and 5 on cardio and at
                the other datasets' topologies; a row alone equals it in the
                batch; five device kernels a step; a graphed block of 10 steps
                fused and plain timed by CUDA events; each new kernel's time,
                bound and plain ops.
4. placement    the population step replayed from CUDA graphs (blocks of
                ``EvalConfig.block_steps`` steps) against the eager loop and
                against the graphed plain chain (``trainer._chain_step``),
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
6c. genome_slice
                the three-axis genome (ADC masks, an activation approximation
                a hidden layer, a weight precision a layer, ternary included),
                the surrogate screen and the gradient/GA hybrid on cardio at
                full width (3 generations): the graph's bits equal the eager
                loop's for axes rows at P = 24 and P = 5, a row alone equals
                it in the batch, 8 genomes on the card within the measured
                bounds of the CPU path, a screened and warm-started search
                with refinement every generation whose front is exact memo
                rows, a deterministic refiner, exact K2/K3 launch counts; a
                generation and a graphed step against ADC-only in the same
                process, the surrogate's refits, the warm start and refines.
6d. service     the co-design evaluation service on cardio at full width (pop 24,
                600 steps, 4-slot waves on the graphed island evaluator, 3
                generations a request): 4 requests at once (every second one a
                duplicate), each equal to its solo run on a fresh backend; the
                duplicates train no row; the largest wave alone gives the same
                objectives (timed against the wave in service; profiled with
                ``--profile``); the memo reloaded from disk trains 0 rows; the
                first capture of a fresh backend held open while two surrogate
                requests start and fit their screens on the card (no capture
                error, screen forwards during the capture, each equal to its
                solo run); a lost wave fails its request only; exact K2/K3
                launches with replays, each bucket captured once.
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
                K4's windowed instance (bf16) against the plain version in
                blocks of queries at K-EXAONE-236B's window layers (64/8 heads,
                d 128, window 128, S 4096 and 32768) and at edges (S below the
                window, ragged tiles, a window of 100 and of 1), one window
                launch a call; a window past every distance gives the causal
                kernel's bits; the fp32 kernel refuses a window; the 32768
                call timed beside the plain version, the causal kernel and
                the bound.
                K4's narrower-v instance (bf16) at DeepSeek-V3's latent
                attention (128 heads, q/k 192, v 128, MLA's softmax scale,
                causal, S 4096 and 32768) against the plain version in blocks
                of queries, the gap within ATTN_TOL and its RMS within
                MLA_REL_TOL of the plain output's RMS, one
                narrower-v launch a call, the same bits twice; each timed
                beside the plain version, SDPA and the bound
                (``cardbench/counts/deepseek.mla_attn_bound``).
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
9b. repeat_bits K4 (bf16, yi-9b's prefill), K5 (bf16, yi-9b's decode) and K1
                (internvl2's patches) called REPEAT_CALLS times each on the
                same inputs: the same bits every call.
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
11b. moe_parity, ssm_parity, hybrid_parity
                reduced phi3.5-moe and arctic (its dense residual MLP), rwkv6 and
                zamba2 in fp32, one set of seed-drawn parameters on the card and on
                the port's CPU path: forward (rwkv6: the recursive chunked form),
                prefill logits and caches (rwkv6: the explicit form), decode logits
                and caches within 1e-4; ``serve.run`` tokens and scheduling fields
                equal on both devices, all at once and staggered (rwkv6's and
                zamba2's tokens depend on the schedule in both packages, so only
                card = CPU is held); K4/K5 on their fp32 variants (none for rwkv6).
                Run after phase 11.
15. moe_slice   phi3.5-moe at full width in bf16, depth cut from 32 to 24 layers
                (62.9 GB of weights; 32 would not fit): weights drawn on the card,
                a 4096-token prefill twice, ``serve.run`` of 4 requests of 32 + 16
                tokens in 4 slots of 4096 (staggered) and again all at once (the
                same tokens), K4 24 a prefill and K5 24 a decode step, the share
                of (token, k) pairs the prefill's capacity dropped, the decode
                step at B=4, peak memory; then, the 24 layers freed, decode vs
                prefill on a full-width 2-layer draw with capacity_factor 8
                (nothing dropped) within 3x its bf16-vs-fp32 floor.
16. ssm_slice   rwkv6-1.6b at full width and depth: a 4096-token prefill (the
                explicit chunked form) twice, then ``forward`` (the recursive
                form) within 3x the prefill's bf16-vs-fp32 floor; ``serve.run``
                of 4 requests of 64 + 32 tokens; the decode step at B=4; decode vs
                prefill within 3x its floor; K4 and K5 launched 0 times.
17. hybrid_slice
                zamba2-2.7b at full width and depth (54 Mamba2 layers, 6 shared-
                attention calls): a 4096-token prefill twice, ``serve.run`` as in
                16, the decode step at B=4, decode vs prefill within 3x its floor,
                K4 6 a prefill and K5 6 a decode step; K4 and K5 at zamba2's
                full-length bf16 shapes (d = 80, G = 1) against their plain
                versions (3e-2), timed.
17b. kexaone_slice
                K-EXAONE-236B at full width in bf16, depth cut from 48 to 8
                layers (two periods of LLLG; 8 of 128 experts held), weights
                drawn by its benchmark cell's driver: a 4096-token prefill
                twice and ``serve.run`` of 4 requests of 32 + 160 tokens (every
                ring wraps), K4 8 a prefill (6 of them windowed) and K5 8 a
                decode step, counted in that run alone; the prefill's last
                positions and 8 decode steps after a 200-token prefill against
                the plain fp32 reference (``cardbench/reference/exaone_moe``),
                the median gap a position within the cell's ``logit_err`` limit;
                the norm kernel 33 launches a prefill and a decode step (16
                of them with the residual).
17c. norm_kernel
                the RMS norm kernel (``kernels/rms_norm``) against
                ``layers.rms_norm`` on the card at K-EXAONE's prefill shapes
                (S 4096 and 32768: d 6144, q's 64 and k's 8 heads of 128) and
                a decode step's, bf16 and fp32, with and without the residual:
                99.9% of rows bit-equal in bf16, any other one ulp of inv off
                (each element within 3 ulps: ``tests/_torch_rms_norm.py``), fp32
                within 2e-6; one launch a call, the same bits twice; 32768 x
                6144 and 32768 x 64 x 128 in bf16 timed beside the plain chain
                and the byte bound.
Phases 15-17b run after phase 14, 17c after phase 7.  Slices 13, 15-17b
count the norm kernel's launches too: (2 + 2 with q/k norms) x layers + 1 a
prefill or decode step of the transformer family, none of rwkv6's or
zamba2's (they keep ``layers.rms_norm``).
18. train_guard K4 and K5 on the card raise when autograd would record the
                call (q, k or v requiring grad, gradients on) and launch
                nothing; under ``no_grad`` each launches once.
19. optim       AdamW, Adafactor and SGD (three updates, fp32 and bf16
                parameters), clip, and int8 compress -> decompress (three
                steps) on one fixed tree, card against CPU: the int8 codes
                equal, the rest within 1e-5 of each leaf's scale (bf16: one
                ulp).
20. train_parity
                the six reduced families in fp32 (dense, MoE, VLM with patches,
                rwkv6, zamba2, whisper with frames), one set of seed-drawn
                parameters on the card and on the port's CPU path: the loss,
                every gradient and one ``train_step`` (clip, AdamW) within the
                fp32 bound (rwkv6's and zamba2's gradients: 5e-4 of each
                leaf's scale); K4
                and K5 launch 0 times in a step (training takes the plain
                attention), K1 once for internvl2 and whisper.
21. train_slice yi-9b at full width in bf16, depth cut from 48 to 8 layers (48
                layers and their AdamW state are 106 GB), B = 2 x 4096 tokens,
                AdamW, remat: 6 steps of ``train.build_train_state``'s step
                (CUDA events; the first step apart), tokens/s, peak memory, the
                model-FLOP share of the bf16 peak, every loss and gradient
                norm finite; the parameters checkpointed and restored bit for
                bit; int8_ef for 2 steps at full width where the peak leaves
                room (else at 100M in 22).
22. train_lm    the twin of ``examples/train_lm.py``: yi-100m in fp32, B 4, S
                128, 60 steps with a crash at 30, a resume from the newest
                checkpoint and a second from the same one: the same losses
                bit for bit.
Phases 18-22 run after phase 17.
23. mesh_codesign
                the population and island evaluators on the card's device grid
                (``population_mesh()``: (1,); ``island_mesh(3)``: (1, 1)) against
                ``mesh=None`` (the one-card grid ``device`` gives): cardio at
                full width, 24 rows (islands of 8, 5 and 11), 600 steps; the
                accuracies bit-equal and the K2/K3 launches equal (each call
                counted alone).
24. plan_serve  yi-9b at full width and depth in bf16: the plan's
                ``prefill_step`` (B = 1, 4096 tokens) and ``serve_step`` (B = 4
                against a 4096-long cache) of ``launch.steps.build_plan`` on a
                1-rank ``make_mesh((1, 1))`` inside ``activation_mesh``: logits
                and caches bit-equal to the model's ``prefill`` and
                ``decode_step``, K4 48 (tensor-core variant) and K5 48 launched;
                then both steps on DTensor parameters, inputs and caches (the
                prefill at B = 2): K4 48 and K5 48 again, the bits of the
                model's calls with plain norms (a DTensor keeps
                ``layers.rms_norm``);
                each step's card time (CUDA events) beside its ``op_cost``
                count at the same shapes (a host count of the plain versions'
                work) with each layer's plain attention replaced by the
                kernel's own work (K4: the causal pairs), the achieved FLOP/s
                against the bf16 peak and bytes/s against HBM3.
25. plan_train  the ``op_cost`` count of train_slice's step (yi-9b, 8 layers, B =
                2 x 4096, remat) beside 6·N·D, and the bf16-peak share this run's
                train_slice time and PR 21's give under each count.
26. elastic_drill
                ``ElasticRunner.drill`` on yi-100m: save, recover onto (1, 1),
                step on; the losses equal an uninterrupted run's bit for bit.
27. pipeline    ``pipeline_apply`` on a 1-rank ``stage`` group at the reference
                test's shapes, bit-equal to the sequential composition.
28. dryrun      ``python -m repro_torch.launch.dryrun --arch yi-9b --mesh single``
                in a subprocess (host only, started with phase 23, 180 s limit):
                its four cells (three run, long_500k skipped) with per-device
                counts; a failure fails the run.
Phases 23-28 run after phase 22.
29. adc_codesign
                the twin of ``examples/adc_codesign.py`` without ``--quick``
                (``launch.adc_codesign``): the six datasets at the paper's search
                budget (pop 24, 16 generations, 600 steps), the gains at 5% and
                1% (each recomputed on the host from the chosen mask through
                ``core.area``, exactly; each chosen point within its budget),
                level 0 kept in every front mask, exact K2/K3 launches
                (``EvaluatorTally``); K1 once on the searched Seeds bank, its
                levels equal to the plain version's on the CPU; the KV codebook's
                codes and values equal to the CPU's.  The mean gains beside the
                paper's and the CI budget's (printed, not gated).
30. quickstart  the twin of ``examples/quickstart.py``: seeds, pop 16, 8
                generations, 400 steps; front non-empty, level 0 kept, the
                baseline above chance, exact K2/K3 launches; its wall seconds.
31. serve_lm    the twin of ``examples/serve_lm.py`` (reduced, fp32, 10 requests in
                4 slots) for yi-9b, then every other arch of ``configs/``: one set
                of parameters drawn on the CPU serves on the card and on the
                port's CPU path with equal requests, decode steps, first-token
                and finish steps; K5 (fp32 variant) launched once an attention
                call of each ``decode_step`` (whisper: self and cross; zamba2: a
                shared-attention invocation; rwkv6: none), K4 and K1 never.
Phases 29-31 run after phase 28.

Last, ``capture_fails``: a capture made to read a value back to the host
raises, caches no graph and falls back to nothing.  The last three lines
are the card's name and power limit, the kernels' summary, and
``{"ok": true, "device": {...}}``.  Without CUDA, or without
the repository beside it, the script fails and prints no result.
"""

from __future__ import annotations

import contextlib
import gzip
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

# the H100's peaks and the kernels' bounds: the benchmark's own, which its
# roofline metrics read too
from cardbench.counts import (BF16_FLOPS, FP32_FLOPS, HBM_BYTES_PER_S, bound_ms, decode_bound,
                              flash_bound, k1_bound, roofline)

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"


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
            **dict.fromkeys(before, 0), "fused_qat_forward": 1, "fused_qat_backward": 1}
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


def _step_buckets():
    """The fused step's test inputs (``tests/_torch_qat_step.py``): a bucket's
    buffers drawn from a seed, copies, rows, the comparison."""
    sys.path.insert(0, str(ROOT / "tests"))
    import _torch_qat_step

    return _torch_qat_step


STEP_KERNELS = ("qat_step_prep", "qat_step_head", "qat_step_update")
STEP_CASES = (("cardio", 24), ("cardio", 5), ("balance", 24), ("breast_cancer", 8),
              ("mammographic", 8), ("seeds", 8), ("vertebral3", 8))
STEP_GRAPH_STEPS = 10  # steps of the graphed block the step is timed in (block_steps)
STEP_GRAPH_REPLAYS = 50


def step_bounds(P: int, B: int, sizes) -> dict[str, tuple[float, str]]:
    """Least time of each of the step's kernels at P rows of an MLP of
    ``sizes``: each input byte read once and each output byte written once,
    against fp32 operations at peak (the head's dense layers forward, dw, dh
    and its cross-entropy; prep's quantizer, ~12 ops a weight; update's 5 a
    parameter)."""
    C, H = sizes[0], sizes[1]
    n_w = sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))
    n_p = n_w + sum(sizes[1:])
    rest = [(a, b) for a, b in zip(sizes[1:-1], sizes[2:])]
    n_rest = sum(a * b + b for a, b in rest)
    K = sizes[-1]
    # prep: indices (int64), the gathered inputs read and written, labels
    # read (int64) and written (int32), weights read and written, the width
    prep = roofline(P * (B * 8 + 2 * B * C * 4 + B * (8 + 4) + 2 * n_w * 4 + 4),
                    12.0 * P * n_w, FP32_FLOPS)
    # head: z1 read and g0 written, the later layers' weights read and
    # gradients written, a label (int32) and a loss weight a sample, denom
    # and the width, db0
    head = roofline(P * (B * H * 4 * 2 + n_rest * 4 * 2 + B * (4 + 4) + 2 * 4 + H * 4),
                    P * B * (6.0 * sum(a * b for a, b in rest) + 8 * sum(sizes[1:-1]) + 8 * K),
                    FP32_FLOPS)
    update = roofline(P * (5 * n_p * 4 + 8), 5.0 * P * n_p, FP32_FLOPS)
    return {"qat_step_prep": prep, "qat_step_head": head, "qat_step_update": update}


def phase_qat_step(torch) -> dict:
    """The training step's kernels (``ops.qat_step``: qat_step_prep, K2,
    qat_step_head, K3, qat_step_update) against the plain chain they replace
    (``trainer._chain_step``) and the backward written out
    (``ref.qat_step`` with K2/K3), bit for bit over a block of steps, at the
    cases of STEP_CASES; a row alone equals it in the batch; five device
    kernels a step (the profiler); then at P = 24 cardio rows, a graphed
    block of STEP_GRAPH_STEPS steps fused and plain timed by CUDA events, and
    each new kernel's time (the profiler) beside its bound and the plain ops
    it replaces.  Returns each kernel's row of the ``kernels`` line, with the
    largest gap the cases read between fused and chain (parameters and
    velocities) as its ``max_abs_err``."""
    import dataclasses

    from repro_torch.core import qat, trainer
    from repro_torch.core.sums import fixed_sum
    from repro_torch.kernels.fused_qat import ops, ref

    h = _step_buckets()
    mom, dev = 0.9, torch.device("cuda")
    k2_k3 = (ops.fused_forward, ops.fused_backward)
    checks, cases = {}, []
    for name, n in STEP_CASES:
        X_tr, y_tr, sizes = h.dataset(name, dev)
        mcfg, s = h.bucket(sizes, n, X_tr.shape[0], seed=n, device=dev)
        fused, plain, emul = h.clone(s), h.clone(s), h.clone(s)
        for j in range(h.STEPS):
            ops.qat_step(X_tr, y_tr, fused, j, mom)
            trainer._chain_step(X_tr, y_tr, mcfg, mom, plain, j)
            ref.qat_step(X_tr, y_tr, emul, j, mom, first_layer=k2_k3)
        torch.cuda.synchronize()
        gap = max((a[k] - b[k]).abs().max().item() for a, b in
                  ((fused.params, plain.params), (fused.vel, plain.vel)) for k in s.params)
        cases.append({"dataset": name, "P": n, "sizes": sizes, "max_abs_gap": gap,
                      "plans": {"prep": dataclasses.asdict(ops.prep_plan(n, 128, sizes)),
                                "head": dataclasses.asdict(ops.head_plan(n, 128, sizes)),
                                "update": dataclasses.asdict(ops.update_plan(n, sizes))}})
        checks[f"{name}_p{n}_fused_equals_plain"] = h.same(fused, plain)
        checks[f"{name}_p{n}_emulation_equals_plain"] = h.same(emul, plain)
    X_tr, y_tr, sizes = h.dataset("cardio", dev)
    mcfg, s = h.bucket(sizes, P, X_tr.shape[0], seed=3, device=dev)
    batch = h.clone(s)
    for j in range(h.STEPS):
        ops.qat_step(X_tr, y_tr, batch, j, mom)
    alone_ok = True
    for p in (0, P // 2, P - 1):
        one = h.rows(s, slice(p, p + 1))
        for j in range(h.STEPS):
            ops.qat_step(X_tr, y_tr, one, j, mom)
        alone_ok &= h.same(one, h.rows(batch, slice(p, p + 1)))
    checks["alone_equals_batch"] = alone_ok

    # steps under the profiler, one session each: the fused step's device
    # kernels (their count a step, rounded: a lost record does not turn five
    # into four; each new kernel's median time) and the plain chain's
    work = h.clone(s)
    n_prof = 20
    events = _profiled_kernels(torch, lambda: ops.qat_step(X_tr, y_tr, work, 0, mom),
                               n_prof, "")
    names = sorted({e.name[:80] for e in events})
    fused_k = {"records": len(events), "calls": n_prof, "names": names,
               "kernels_per_call": round(len(events) / n_prof)}
    chain = lambda X, y, b, j, m: trainer._chain_step(X, y, mcfg, m, b, j)  # noqa: E731
    plain_k = device_kernels(torch, lambda: chain(X_tr, y_tr, work, 0, mom), n=5)
    want_names = ("fused_qat_fwd_kernel", "fused_qat_bwd_kernel", *(f"{k}_kernel"
                                                                    for k in STEP_KERNELS))
    checks["five_kernels_a_step"] = (fused_k["kernels_per_call"] == 5 and len(names) == 5
                                     and all(any(w in nm for nm in names) for w in want_names))

    # a graphed block of steps, fused and plain, timed by CUDA events
    def graphed(step):
        bucket = h.clone(s)
        run = lambda: [step(X_tr, y_tr, bucket, j, mom)  # noqa: E731
                       for j in range(STEP_GRAPH_STEPS)]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            run()
        return graph

    graphs = {"fused": graphed(ops.qat_step), "plain": graphed(chain)}
    step_ms = {k: [] for k in graphs}
    for name in ["plain", "fused", "fused", "plain"] * 3:
        g = graphs[name]
        g.replay()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(STEP_GRAPH_REPLAYS):
            g.replay()
        end.record()
        torch.cuda.synchronize()
        step_ms[name].append(start.elapsed_time(end) / (STEP_GRAPH_REPLAYS * STEP_GRAPH_STEPS))
    med = {k: statistics.median(v) for k, v in step_ms.items()}

    # each new kernel's time, bound, and the plain ops it replaces
    bounds = step_bounds(P, 128, sizes)
    kernel_ms_ = {k: statistics.median(e.time_range.elapsed_us() for e in events
                                       if f"{k}_kernel" in e.name) / 1e3 for k in bounds}
    it = s.idx[:, 0]
    wb = s.wb.view(P, 1, 1)
    ab = s.ab.view(P, 1, 1)
    scale = 1.0 / (1 << mcfg.adc_bits)

    def plain_prep():
        with torch.no_grad():
            X_tr[it]
            for i in range(len(sizes) - 1):
                qat.quantize_pow2(s.params[f"w{i}"], wb)

    with torch.no_grad():
        wq = [qat.quantize_pow2(s.params[f"w{i}"], wb) for i in range(len(sizes) - 1)]
        z1 = ops.fused_forward(X_tr[it], s.thr, s.ids, wq[0], s.params["b0"], scale)

    def plain_head():  # the chain from K2's output to K3's input, autograd's backward
        z = z1.detach().requires_grad_(True)
        w1 = wq[1].detach().requires_grad_(True)
        b1 = s.params["b1"].detach().requires_grad_(True)
        logits = qat.dense(qat.quantize_uniform(qat.clip01(torch.relu(z)), ab), w1, b1)
        loss = ((s.w * qat.cross_entropy(logits, y_tr[it])) / s.denom[:, None]).sum()
        g0, _, _ = torch.autograd.grad(loss, [z, w1, b1])
        fixed_sum(g0, 1)

    grads = {k: torch.zeros_like(v) for k, v in s.params.items()}
    upd = h.clone(s)

    def plain_update():
        ref._momentum_update(upd, grads, mom, 0)

    plain = {"qat_step_prep": plain_prep, "qat_step_head": plain_head,
             "qat_step_update": plain_update}
    table = {}
    for k, fn in plain.items():
        prof = device_kernels(torch, fn, n=10)
        table[k] = {"ms": kernel_ms_[k], "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
                    "plain_ms": prof["kernel_us_per_call"] / 1e3,
                    "plain_kernels": prof["kernels_per_call"],
                    "max_abs_err": max(c["max_abs_gap"] for c in cases)}
    emit("qat_step", cases=cases, rows=P, graph_steps=STEP_GRAPH_STEPS, step_ms=step_ms,
         median_step_ms=med, plain_over_fused=med["plain"] / med["fused"],
         kernels_a_step={"fused": fused_k, "plain": plain_k}, step_kernels=table,
         checks=checks, ok=all(checks.values()))
    if not all(checks.values()):
        raise SystemExit(f"qat_step checks failed: {checks}")
    return table


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


def _plain_chain(mcfg):
    """While entered, the trainer's ADC-only step of an MLP of ``mcfg`` is
    the plain chain (``trainer._chain_step``) in place of the fused kernels:
    for the graphs a program captures, and for every step of an eager one."""
    import contextlib

    from repro_torch.core import trainer
    from repro_torch.kernels.fused_qat import ops

    def chain(X_tr, y_tr, s, j, momentum):
        trainer._chain_step(X_tr, y_tr, mcfg, momentum, s, j)

    @contextlib.contextmanager
    def swapped():
        fused = ops.qat_step
        ops.qat_step = chain
        try:
            yield
        finally:
            ops.qat_step = fused

    return swapped()


def phase_placement(torch):
    """The captured graph against the eager loop, bit for bit, at P = 24 and
    at P = 5 (bucket 8), and the graphed fused step against the graphed plain
    chain it replaces (``trainer._chain_step``); a row alone equals the same row in
    the batch; two runs of one batch give the same bits.  600 steps, blocks of
    S steps."""
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
    chain = trainer.make_row_program(X_tr, y_tr, X_te, y_te, mcfg, ecfg, device="cuda")
    with _plain_chain(mcfg):  # its graphs hold the plain chain's launches
        c24, c5 = chain(*rows, params0, idx), chain(*rows5, p5, idx[five])
    checks = {
        "graph_equals_eager_p24": _same(torch, out, ref),
        "graph_equals_eager_p5": _same(torch, g5, e5),
        "fused_equals_plain_chain_p24": _same(torch, out, c24),
        "fused_equals_plain_chain_p5": _same(torch, g5, c5),
        "p5_equals_its_rows_in_p24": _same(torch, g5, (out[0][five], {
            k: v[five] for k, v in out[1].items()})),
        "alone_equals_batch": alone_ok,
        "run_to_run_equal": _same(torch, out, out2),
        "acc_finite": bool(torch.isfinite(out[0]).all()),
    }
    emit("placement", rows=P, steps=600, block_steps=ecfg.block_steps,
         first_call_s=first_s, batch_of_24_s=batch_s, eager_batch_of_24_s=eager_s,
         graph_stats=dict(run.stats), chain_stats=dict(chain.stats), checks=checks,
         ok=all(checks.values()))
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
    calls, graphs captured, warm-up steps, replays, fused calls.  From them
    the K2 and K3 launches of a run are exact: a call launches K2 once a step
    and once for its evaluation and K3 once a step, and each capture's
    warm-up steps launch both once; an ADC-only evaluator's calls
    (``fused_calls``) and warm-up steps launch each of the fused step's three
    kernels once a step."""

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
        fused = self.total("fused_calls") * max_steps + sum(
            st["warmup_steps"] for st in self.stats if st["fused_calls"])
        return {"fused_qat_forward": calls * (max_steps + 1) + warm,
                "fused_qat_backward": calls * max_steps + warm,
                **dict.fromkeys(STEP_KERNELS, fused)}


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


# the genome slice: ROADMAP Queue 1 items 6-7 on cardio at full width
GENOME_AXES = ("adc", "act", "wprec")
GENOME_SLICE = dict(genome_axes=GENOME_AXES, surrogate=True, surrogate_min_rows=16,
                    hybrid_warm_frac=0.25, hybrid_refine_every=1, hybrid_grad_steps=30,
                    n_generations=3)
# Per-row |acc_card - acc_cpu| bounds of 8 three-axis genomes at 600 steps.
# A ternary first layer makes sums that are 0 in exact arithmetic come out
# +-1 ulp with a sign set by the order of summation, and the activation's
# gradient at 0 flips with it, so those rows part from the first step: the
# port's CPU path against the JAX package measured gaps up to 148 of 638
# over 88 rows (tests/test_torch_genome_axes.py), every other row within 49.
# On an H100 (80GB HBM3, 700 W) the card against the CPU path measured 0.086
# for one of these 8 rows' two ternary rows and 0 for the six others.
GENOME_PARITY_BOUND = {"ternary_first_layer": 0.25, "other": 0.08}
GENOME_STEPS = 600  # training steps of the phase's row-program calls (the slice's max_steps)
GENOME_STEP_ROUNDS = 2  # rounds of (adc, axes, axes, adc) calls timed


def _axes_rows(n: int, seed: int):
    """n three-axis cardio genomes whose act and wprec genes cover every choice
    (ternary included); returns (evaluator rows, seeds, genomes)."""
    import numpy as np

    from repro_torch.core import chromosome

    rng = np.random.default_rng(seed)
    cards = chromosome.cat_cardinalities(GENOME_AXES, 2)
    masks = rng.uniform(size=(n, C * 16)) < rng.uniform(0.1, 1.0, (n, 1))
    cats = np.stack([rng.integers(0, c, n) for c in cards], 1).astype(np.int64)
    cats[:, 5] = np.arange(n) % 4                  # relu, sat01, pwl2, step
    cats[:, 6] = (np.arange(n) + 1) % 4            # first layer: po2-6, -4, ternary, po2-8
    cats[:, 7] = rng.permutation(np.arange(n) % 4)
    dec = chromosome.decode_batch(masks, cats, C, N_BITS, GENOME_AXES, 2)
    rows = (dec["masks"], dec["weight_bits"], dec["act_bits"], dec["batch_size"],
            dec["epochs"], dec["lr"])
    return rows, (dec["act_sel"], dec["wprec"]), rng.integers(0, 2**31 - 1, n).astype(
        np.int32), (masks, cats)


class _Timed:
    """Wall seconds of each call of ``module.name`` while installed (synchronised)."""

    def __init__(self, torch, module, name: str):
        self.torch, self.module, self.name, self.seconds = torch, module, name, []

    def __enter__(self):
        self.orig = fn = getattr(self.module, self.name)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            self.torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)
            return out

        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def phase_genome_slice(torch):
    """The three-axis genome (act, wprec), the surrogate screen and the gradient/GA
    hybrid on cardio at full width, trained through K2/K3 under the step's CUDA
    graph.  Checks: the graph's bits equal the eager loop's for axes rows at P =
    24 and P = 5 (every act and wprec choice, ternary included); a row alone
    equals the same row in the batch; 8 genomes on the card within the measured
    bounds of the port's CPU path; a ``run_codesign`` with the axes, the screen
    (it defers rows) and the hybrid (warm start, refinement every generation),
    whose front is all exact memo rows; the refiner a pure function of its
    genomes; exact K2/K3 launch counts of that run.  Times: a generation and a
    graphed step against ADC-only in the same process, the surrogate's refits,
    the warm start and the refine calls."""
    import dataclasses
    import statistics

    import numpy as np

    from repro_torch.configs.printed_mlp import codesign_config
    from repro_torch.core import codesign, hybrid, memo_store, qat, surrogate, trainer
    from repro_torch.kernels.fused_qat import ops

    (X_tr, y_tr, X_te, y_te), sizes = _cardio()
    mcfg = qat.MLPConfig(sizes)
    ecfg = trainer.EvalConfig(max_steps=GENOME_STEPS, genome_axes=GENOME_AXES)
    checks = {}

    # -- the graph against the eager loop, and a row alone against its batch
    run = trainer.make_row_program(X_tr, y_tr, X_te, y_te, mcfg, ecfg, device="cuda")
    eager = trainer.make_row_program(X_tr, y_tr, X_te, y_te, mcfg, ecfg, device="cuda",
                                     graph=False)
    rows, extra, seeds, _ = _axes_rows(P, seed=21)
    params0, idx = trainer.draw_rows(seeds, ecfg, mcfg, X_tr.shape[0])
    out = run(*rows, params0, idx, *extra)
    checks["graph_equals_eager_p24"] = _same(torch, out, eager(*rows, params0, idx, *extra))
    five = slice(3, 8)
    sub = [r[five] for r in rows], {k: v[five] for k, v in params0.items()}, idx[five], [
        e[five] for e in extra]
    g5 = run(*sub[0], sub[1], sub[2], *sub[3])
    checks["graph_equals_eager_p5"] = _same(torch, g5, eager(*sub[0], sub[1], sub[2], *sub[3]))
    checks["p5_equals_its_rows_in_p24"] = _same(torch, g5, (out[0][five], {
        k: v[five] for k, v in out[1].items()}))
    alone_ok = True
    for p in (0, 10, P - 1):
        sl = slice(p, p + 1)
        a1, p1 = run(*(r[sl] for r in rows), {k: v[sl] for k, v in params0.items()}, idx[sl],
                     *(e[sl] for e in extra))
        alone_ok &= bool(torch.equal(a1[0], out[0][p])) and all(
            torch.equal(p1[k][0], out[1][k][p]) for k in p1)
    checks["alone_equals_batch"] = alone_ok
    checks["every_choice_covered"] = (set(extra[0][:, 0].tolist()) == {0, 1, 2, 3}
                                      and set(extra[1].ravel().tolist()) == {0.0, 4.0, 6.0, 8.0}
                                      and set(extra[1][3:8, 0].tolist()) >= {0.0})

    # -- the card against the port's CPU path, 8 genomes
    rows8, extra8, seeds8, _ = _axes_rows(8, seed=23)
    p8, i8 = trainer.draw_rows(seeds8, ecfg, mcfg, X_tr.shape[0])
    accs = {}
    for dev in ("cuda", "cpu"):
        prog = trainer.make_row_program(X_tr, y_tr, X_te, y_te, mcfg, ecfg, device=dev)
        accs[dev] = prog(*rows8, p8, i8, *extra8)[0].cpu()
    gap = (accs["cuda"] - accs["cpu"]).abs().numpy()
    ternary = extra8[1][:, 0] == 0.0
    checks["card_within_cpu_bounds"] = bool(
        (gap[ternary] <= GENOME_PARITY_BOUND["ternary_first_layer"]).all()
        and (gap[~ternary] <= GENOME_PARITY_BOUND["other"]).all()
        and torch.isfinite(accs["cuda"]).all())

    # -- a graphed step with the axes against ADC-only, in turns
    adc_cfg = trainer.EvalConfig(max_steps=GENOME_STEPS)
    adc_run = trainer.make_row_program(X_tr, y_tr, X_te, y_te, mcfg, adc_cfg, device="cuda")
    adc_run(*rows, params0, idx)  # its capture
    step_ms = {"adc": [], "axes": []}
    for _ in range(GENOME_STEP_ROUNDS):
        for name in ("adc", "axes", "axes", "adc"):
            t0 = time.perf_counter()
            if name == "adc":
                adc_run(*rows, params0, idx)
            else:
                run(*rows, params0, idx, *extra)
            torch.cuda.synchronize()
            step_ms[name].append((time.perf_counter() - t0) * 1e3 / GENOME_STEPS)

    # -- the refiner: a pure function of its genomes
    hcfg = hybrid.HybridConfig(grad_steps=GENOME_SLICE["hybrid_grad_steps"])
    refine = hybrid.make_refiner(X_tr, y_tr, sizes, N_BITS, GENOME_AXES, hcfg, device="cuda")
    _, _, _, (gm, gc) = _axes_rows(4, seed=25)
    r1, r2 = refine(gm, gc), refine(gm, gc)
    ra = refine(gm[1:2], gc[1:2])
    checks["refiner_deterministic"] = all(np.array_equal(a, b) for a, b in zip(r1, r2))
    checks["refiner_row_alone_equal"] = bool(np.array_equal(ra[0][0], r1[0][1])
                                             and np.array_equal(ra[1][0], r1[1][1]))

    # -- ADC-only and three-axis searches in one process; the latter is the path
    tmp = OUT / "genome_tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    base = dataclasses.replace(codesign_config("cardio", full=True),
                               n_generations=GENOME_SLICE["n_generations"], device="cuda")
    t0 = time.perf_counter()
    adc_res = codesign.run_codesign(base)
    adc_wall = time.perf_counter() - t0
    cfg = dataclasses.replace(base, **GENOME_SLICE, memo_path=str(tmp / "memo"))
    ops.reset_launch_counts()
    with EvaluatorTally() as tally, _Timed(torch, surrogate.SurrogateScreen, "_fit") as fits, \
            _Timed(torch, hybrid, "warm_start_genomes") as warm:
        refine_s = []
        make_refiner = hybrid.make_refiner

        def timed_refiner(*a, **kw):
            fn = make_refiner(*a, **kw)

            def refine_call(m, c):
                t0 = time.perf_counter()
                out = fn(m, c)
                refine_s.append(time.perf_counter() - t0)
                return out

            return refine_call

        hybrid.make_refiner = timed_refiner
        try:
            t0 = time.perf_counter()
            res = codesign.run_codesign(cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            hybrid.make_refiner = make_refiner
    launches = dict(ops.LAUNCHES)
    want = tally.expected_launches(cfg.max_steps)
    # every front point is a trained (memo) row: the memo holds exact rows only,
    # the screen's predictions live beside it
    norm_area = codesign._make_cost_batch(GENOME_AXES, N_BITS, sizes)[1]
    exact_objs = {(1.0 - float(o[0]), float(o[1]))
                  for o in memo_store.load_memo(str(tmp / "memo")).values()}
    exact = all((float(a), float(ar / norm_area)) in exact_objs
                for a, ar in zip(res.front_acc, res.front_area))
    checks.update({
        "front_nonempty_finite": res.front_acc.size >= 1 and bool(
            np.isfinite(res.front_acc).all()),
        "front_cats_three_axes": res.front_cats.shape[1] == 8,
        "screen_deferred_rows": res.n_deferred > 0,
        "last_generation_trained": res.history[-1]["deferred"] == 0,
        "front_exact": exact,
        "warm_started": len(warm.seconds) == 1,
        "refined_every_generation": len(refine_s) == cfg.n_generations,
        "launch_counts": launches == want,
        "k2_k3_launched": launches["fused_qat_forward"] > 0
        and launches["fused_qat_backward"] > 0,
    })
    gen = lambda r: [h["gen_s"] for h in r.history]  # noqa: E731
    emit("genome_slice", dataset="cardio", axes=list(GENOME_AXES),
         pop_size=cfg.pop_size, max_steps=cfg.max_steps, n_generations=cfg.n_generations,
         surrogate_min_rows=cfg.surrogate_min_rows, hybrid_warm_frac=cfg.hybrid_warm_frac,
         hybrid_refine_every=cfg.hybrid_refine_every, hybrid_grad_steps=cfg.hybrid_grad_steps,
         seconds_per_generation=gen(res), adc_only_seconds_per_generation=gen(adc_res),
         wall_s=wall, adc_only_wall_s=adc_wall,
         ms_per_graphed_step=step_ms,
         ms_per_graphed_step_median={k: statistics.median(v) for k, v in step_ms.items()},
         n_evaluations=res.n_evaluations, n_deferred=res.n_deferred,
         n_memo_hits=res.n_memo_hits, adc_only_n_evaluations=adc_res.n_evaluations,
         history=[{k: h[k] for k in ("n_evals", "deferred", "memo_hits", "eval_s", "gen_s")
                   if k in h} for h in res.history],
         surrogate_fit_s=fits.seconds, warm_start_s=warm.seconds, refine_call_s=refine_s,
         front_size=int(res.front_acc.size), front_acc=res.front_acc.tolist(),
         conv_acc=res.conv_acc, area_gain_at_5pct=codesign.gains_at_budget(res)["area_gain"],
         card_vs_cpu_gap=gap.tolist(), ternary_first_layer=ternary.tolist(),
         card_vs_cpu_bound=GENOME_PARITY_BOUND,
         graph_stats={k: tally.total(k) for k in tally.stats[0]}, launches=launches,
         expected_launches=want, checks=checks, ok=all(checks.values()))
    shutil.rmtree(tmp, ignore_errors=True)
    if not all(checks.values()):
        raise SystemExit(f"genome_slice checks failed: {checks}")
    return launches


# the service phase: ROADMAP Queue 1 item 8 on cardio at full width
SERVICE_SLOTS = 4  # request batches a device wave carries
SERVICE_REQUESTS = 4  # the workload, all at once, every second request a duplicate
SERVICE_DUPLICATE_EVERY = 2
SERVICE_GENERATIONS = 3  # a request's generations (the config's 16, cut)
SERVICE_COALESCE_S = 0.02
SERVICE_SURROGATE = dict(surrogate=True, surrogate_min_rows=16)  # GENOME_SLICE's cut
SERVICE_SURROGATE_SEEDS = (5, 6)
HOLD_FORWARDS = 5  # screen forwards the held capture waits for
HOLD_TIMEOUT_S = 120.0


class _ServiceWatch:
    """While installed: every graph capture's window and error, the surrogate fits in
    flight, and the screen's forward calls made while a capture was open.  Armed
    (``hold``), the next capture holds its body open until HOLD_FORWARDS screen
    forwards have run on another thread, then records the capture as held."""

    def __init__(self, torch):
        import threading

        from repro_torch.core import surrogate, trainer

        self.torch, self.surrogate, self.trainer = torch, surrogate, trainer
        self.cond = threading.Condition()
        self.capture_open = threading.Event()
        self.in_capture = False
        self.hold = False
        self.held = None
        self.captures: list[dict] = []
        self.fits: list[tuple[float, float]] = []
        self.forwards_in_capture = 0

    def __enter__(self):
        torch, trainer, surrogate = self.torch, self.trainer, self.surrogate
        self.orig = (trainer._Block.__init__, trainer._train_block,
                     surrogate.SurrogateScreen._fit, surrogate._forward)
        block_init, train_block, fit, forward = self.orig
        watch = self

        def init(blk, run, n, pool):
            t0, err = time.perf_counter(), None
            try:
                block_init(blk, run, n, pool)
            except BaseException as e:
                err = f"{type(e).__name__}: {e}"[:300]
                raise
            finally:
                watch.captures.append({"t0": t0, "t1": time.perf_counter(), "error": err})

        def train(*a, **kw):
            if not torch.cuda.is_current_stream_capturing():
                return train_block(*a, **kw)
            with watch.cond:
                watch.in_capture = True
            try:
                if watch.hold:
                    watch.hold = False
                    watch.capture_open.set()
                    with watch.cond:
                        watch.held = watch.cond.wait_for(
                            lambda: watch.forwards_in_capture >= HOLD_FORWARDS,
                            HOLD_TIMEOUT_S)
                return train_block(*a, **kw)
            finally:
                with watch.cond:
                    watch.in_capture = False

        def fit_w(scr, *a, **kw):
            t0 = time.perf_counter()
            try:
                return fit(scr, *a, **kw)
            finally:
                watch.fits.append((t0, time.perf_counter()))

        def fwd(*a, **kw):
            with watch.cond:
                if watch.in_capture:
                    watch.forwards_in_capture += 1
                    watch.cond.notify_all()
            return forward(*a, **kw)

        trainer._Block.__init__, trainer._train_block = init, train
        surrogate.SurrogateScreen._fit, surrogate._forward = fit_w, fwd
        return self

    def __exit__(self, *exc):
        (self.trainer._Block.__init__, self.trainer._train_block,
         self.surrogate.SurrogateScreen._fit, self.surrogate._forward) = self.orig


class _Waves:
    """A backend's ``stacked_evaluate`` that records each call: its batches, output,
    bucket and wall seconds.  ``fail_next`` makes the next call raise before it
    reaches the card (a lost wave)."""

    def __init__(self, backend, granule: int):
        self.backend, self.granule = backend, granule
        self.calls: list[dict] = []
        self.fail_next = False

    def __call__(self, batches):
        from repro_torch.runtime import failure

        if self.fail_next:
            self.fail_next = False
            raise failure.DeviceLossError("injected: the wave was lost")
        t0 = time.perf_counter()
        out = self.backend["stacked_evaluate"](batches)
        sizes = [int(m.shape[0]) for m, _ in batches]
        self.calls.append({"batches": batches, "out": out, "seconds": time.perf_counter() - t0,
                           "rows": sum(sizes),
                           "bucket": -(-max(sizes) // self.granule) * self.granule})
        return out


def _witness(res) -> dict:
    """What a request and its solo run must agree on: front, memo order, counters."""
    return {"objs": res["objs"], "masks": res["masks"], "cats": res["cats"],
            "memo_keys": res["memo_keys"], "n_evaluations": res["n_evaluations"],
            "n_memo_hits": res["n_memo_hits"], "n_deferred": res["n_deferred"]}


def _same_witness(a: dict, b: dict) -> bool:
    import numpy as np

    return all(a[k] == b[k] if k == "memo_keys" else np.array_equal(a[k], b[k]) for k in a)


def _served(r) -> dict:
    return _witness({**r.result, "memo_keys": r.memo_keys, "n_evaluations": r.n_evaluations,
                     "n_memo_hits": r.n_memo_hits, "n_deferred": r.n_deferred})


def phase_service(torch, profile: bool = False):
    """The co-design evaluation service on the card (cardio at full width, pop 24,
    600 steps, SERVICE_SLOTS-slot waves on K2/K3's graphed island evaluator).

    1. SERVICE_REQUESTS searches at once, every second one a duplicate, each from
       an empty memo; the shared memo saved to disk.
    2. Each request alone on a fresh backend from the same memo (a duplicate's
       solo run is its twin's): the same front, memo order and counters; the
       duplicates trained no row of their own.
    3. Each wave of the workload again, alone: the same objectives, its time
       against the wave's in service (the largest profiled with ``--profile``).
    4. A second service loads the memo from disk: a request again trains 0 rows.
    5. On a fresh backend (no bucket captured), the first capture is held open
       while two surrogate requests (``min_rows`` 16) start and fit their screens
       on the card from their threads: no capture error, screen forwards ran
       during the capture, and each request equals its solo run.
    6. A wave made to fail fails its request only; the next request is answered.
    K2/K3 launches are exact with replays over the phase, and each backend
    captured each bucket once."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.printed_mlp import codesign_config
    from repro_torch.core import codesign, eval_service, memo_store, nsga2, trainer
    from repro_torch.kernels.fused_qat import ops
    from repro_torch.launch import codesign_serve
    from repro_torch.runtime import failure

    tmp = OUT / "service_tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    memo_path = str(tmp / "memo")
    base = dataclasses.replace(codesign_config("cardio", full=True),
                               n_generations=SERVICE_GENERATIONS, device="cuda")
    granule = trainer.EvalConfig().pad_granule
    svc_cfg = eval_service.ServiceConfig(wave_slots=SERVICE_SLOTS, coalesce_s=SERVICE_COALESCE_S)
    checks, telemetry = {}, {}

    def service(waves, fingerprint, screen_factory=None, **kw):
        b = waves.backend
        return eval_service.EvalService(waves, b["n_mask_bits"], b["cat_cardinalities"],
                                        cfg=dataclasses.replace(svc_cfg, **kw),
                                        fingerprint=fingerprint, screen_factory=screen_factory)

    def solo(waves, ga, memo, screen=None) -> tuple[dict, float]:
        b = waves.backend
        empty = (np.zeros((0, b["n_mask_bits"]), bool),
                 np.zeros((0, len(b["cat_cardinalities"])), np.int64))

        def row_evaluate(masks, cats):
            return waves([(masks, cats)] + [empty] * (SERVICE_SLOTS - 1))[0]

        eng = nsga2.NSGA2(b["n_mask_bits"], b["cat_cardinalities"], row_evaluate, ga,
                          memo=dict(memo), screen=screen)
        t0 = time.perf_counter()
        out = eng.run()
        return _witness({**out, "memo_keys": list(eng.memo)}), time.perf_counter() - t0

    ops.reset_launch_counts()
    t_phase = time.perf_counter()
    with EvaluatorTally() as tally, _ServiceWatch(torch) as watch:
        # -- 1. the workload
        waves_a = _Waves(codesign.make_service_backend(base, SERVICE_SLOTS), granule)
        fp = waves_a.backend["fingerprint"]
        reqs = codesign_serve.build_requests(SERVICE_REQUESTS, base.pop_size,
                                             SERVICE_GENERATIONS, base.seed,
                                             duplicate_every=SERVICE_DUPLICATE_EVERY)
        for r in reqs:
            r.memo = {}
        svc = service(waves_a, fp, memo_path=memo_path)
        n_captures = len(watch.captures)
        with svc:
            t0 = time.perf_counter()
            results = codesign_serve.serve_workload(svc, reqs)
            workload_s = time.perf_counter() - t0
            stats = svc.stats()
        checks["workload_ok"] = all(r.ok for r in results)
        if not checks["workload_ok"]:
            raise SystemExit(f"service: a request failed: {[r.error for r in results]}")
        served = [_served(r) for r in results]
        workload_waves = list(waves_a.calls)
        workload_captures = [c["t1"] - c["t0"] for c in watch.captures[n_captures:]]

        # -- 2. each request alone on a fresh backend; a duplicate's solo run is its
        # twin's (the same search from the same memo), run and timed once
        waves_b = _Waves(codesign.make_service_backend(base, SERVICE_SLOTS), granule)
        solo_s, same, solos = [], [], {}
        for r, got in zip(reqs, served):
            if r.ga.seed not in solos:
                solos[r.ga.seed] = solo(waves_b, r.ga, {})
            want, s = solos[r.ga.seed]
            solo_s.append(s)
            same.append(_same_witness(got, want))
        sm = stats["shared_memo"]
        first = {}  # each distinct search's first request
        for r, w in zip(reqs, served):
            first.setdefault(r.ga.seed, w)
        distinct = set().union(*(w["memo_keys"] for w in first.values()))
        checks["duplicates_train_zero_rows"] = sm["trained"] == sm["entries"] == len(distinct)
        checks["every_row_accounted"] = (
            sm["hits"] + sm["coalesced"] + sm["trained"] == sm["rows_requested"])

        # -- 3. each wave of the workload again, alone (its buckets captured)
        alone_s, alone_same = [], []
        for w in workload_waves:
            t0 = time.perf_counter()
            again = waves_a.backend["stacked_evaluate"](w["batches"])
            alone_s.append(time.perf_counter() - t0)
            alone_same.append(all((a is None and b is None) or np.array_equal(a, b)
                                  for a, b in zip(again, w["out"])))
        checks["wave_alone_same_bits"] = all(alone_same)
        big = max(workload_waves, key=lambda c: c["rows"])
        if profile:
            telemetry["profile_wave"] = _profiled(
                torch, lambda: waves_a.backend["stacked_evaluate"](big["batches"]),
                "profile_service_wave.json")

        # -- 4. the memo reloaded from disk into a second service
        svc2 = service(waves_a, fp, memo_path=memo_path)
        reloaded_entries = len(svc2.shared)
        with svc2:
            svc2.submit(eval_service.SearchRequest("reload", ga=reqs[0].ga))
            rerun = svc2.result("reload")
            stats2 = svc2.stats()
        checks["reloaded_service_trains_zero_rows"] = (
            rerun.ok and reloaded_entries == sm["entries"]
            and stats2["shared_memo"]["trained"] == 0 and rerun.n_evaluations == 0
            and np.array_equal(rerun.result["objs"], served[0]["objs"]))

        # -- 5. surrogate requests while the first bucket is captured
        waves_c = _Waves(codesign.make_service_backend(
            dataclasses.replace(base, **SERVICE_SURROGATE), SERVICE_SLOTS), granule)
        table = memo_store.load_memo(memo_path, fp)
        sur_reqs = [eval_service.SearchRequest(
            f"screened-{s}", ga=nsga2.NSGA2Config(pop_size=base.pop_size,
                                                   n_generations=SERVICE_GENERATIONS, seed=s),
            memo=table) for s in SERVICE_SURROGATE_SEEDS]
        rng = np.random.default_rng(31)
        trig_m = rng.uniform(size=(base.pop_size, waves_c.backend["n_mask_bits"])) < 0.5
        trig_c = np.stack([rng.integers(0, c, base.pop_size)
                           for c in waves_c.backend["cat_cardinalities"]], 1).astype(np.int64)
        svc3 = service(waves_c, fp, screen_factory=waves_c.backend["screen_factory"])
        watch.hold = True
        n_captures_before = len(watch.captures)
        with svc3:
            t0 = time.perf_counter()
            trigger = svc3.scheduler.submit(trig_m, trig_c)
            if not watch.capture_open.wait(HOLD_TIMEOUT_S):
                raise SystemExit("service: the first capture never opened")
            for r in sur_reqs:  # submitted while the capture is open
                svc3.submit(r)
            trig_objs = trigger()
            sur_results = [svc3.result(r.request_id) for r in sur_reqs]
            surrogate_s = time.perf_counter() - t0
            stats3 = svc3.stats()
        fits_in_service = len(watch.fits)  # the rest are the solo runs' fits
        sur_captures = watch.captures[n_captures_before:]
        checks["no_capture_error_alongside_surrogate"] = (
            bool(watch.held) and watch.forwards_in_capture >= HOLD_FORWARDS
            and all(c["error"] is None for c in watch.captures)
            and all(r.ok for r in sur_results) and len(sur_captures) >= 1)
        trig_solo = waves_b([(trig_m, trig_c)] + [
            (trig_m[:0], trig_c[:0])] * (SERVICE_SLOTS - 1))[0]
        checks["trigger_rows_same_bits"] = bool(np.array_equal(trig_objs, trig_solo))
        for r, res in zip(sur_reqs, sur_results):
            if res.ok:
                want, s = solo(waves_b, r.ga, table, waves_c.backend["screen_factory"]())
                same.append(_same_witness(_served(res), want))
                solo_s.append(s)
            else:
                same.append(False)
        checks["screens_deferred_rows"] = all(r.ok and r.n_deferred > 0 for r in sur_results)
        checks["each_request_equals_solo"] = all(same) and len(same) == len(reqs) + len(sur_reqs)

        # -- 6. a lost wave
        svc4 = service(waves_a, fp)
        with svc4:
            waves_a.fail_next = True
            svc4.submit(eval_service.SearchRequest("victim", ga=reqs[-1].ga, memo={}))
            victim = svc4.result("victim")
            entries_after_loss = len(svc4.shared)
            svc4.submit(eval_service.SearchRequest("after", ga=reqs[0].ga, memo={}))
            after = svc4.result("after")
            stats4 = svc4.stats()
        checks["failed_wave_fails_only_its_request"] = (
            isinstance(victim.error, failure.DeviceLossError) and entries_after_loss == 0
            and stats4["admission"]["active"] == 0)
        checks["next_request_answered"] = after.ok and _same_witness(_served(after), served[0])
    torch.cuda.synchronize()
    phase_s = time.perf_counter() - t_phase
    launches = dict(ops.LAUNCHES)
    want_launches = tally.expected_launches(base.max_steps)
    checks["launch_counts"] = launches == want_launches
    blocks = -(-base.max_steps // trainer.EvalConfig().block_steps)
    per_backend = {}
    for name, waves, st in (("a", waves_a, tally.stats[0]), ("b", waves_b, tally.stats[1]),
                            ("c", waves_c, tally.stats[2])):
        buckets = sorted({c["bucket"] for c in waves.calls})
        per_backend[name] = {"buckets": buckets, "stats": dict(st)}
        checks[f"buckets_captured_once_{name}"] = (
            st["captures"] == len(buckets) and st["replays"] == st["calls"] * blocks)
    checks["buckets_reused"] = tally.total("calls") > tally.total("captures")

    lat = [r.latency_s for r in results]
    wait = [r.queue_wait_s for r in results]
    pct = lambda v, q: float(np.percentile(np.asarray(v), q))  # noqa: E731
    emit("service", dataset="cardio", pop_size=base.pop_size, max_steps=base.max_steps,
         n_generations=SERVICE_GENERATIONS, wave_slots=SERVICE_SLOTS,
         n_requests=SERVICE_REQUESTS, duplicate_every=SERVICE_DUPLICATE_EVERY,
         waves=stats["waves"]["n_waves"], mean_occupancy=stats["waves"]["mean_occupancy"],
         cross_request_hit_rate=stats["hit_rate"],
         rows={k: sm[k] for k in ("rows_requested", "trained", "hits", "coalesced", "entries")},
         latency_p50_s=pct(lat, 50), latency_p95_s=pct(lat, 95),
         queue_wait_p50_s=pct(wait, 50), queue_wait_p95_s=pct(wait, 95),
         workload_wall_s=workload_s, solo_wall_s=solo_s[:len(reqs)],
         solo_sum_s=sum(solo_s[:len(reqs)]),
         wave_rows=[c["rows"] for c in workload_waves],
         wave_s=[c["seconds"] for c in workload_waves], wave_alone_s=alone_s,
         wave_in_service_over_alone=[c["seconds"] / a for c, a in zip(workload_waves, alone_s)],
         workload_capture_s=workload_captures,
         capture_s=[c["t1"] - c["t0"] for c in watch.captures],
         largest_wave={"rows": big["rows"], "bucket": big["bucket"]},
         reload={"entries": reloaded_entries, "trained": stats2["shared_memo"]["trained"]},
         surrogate={"requests": len(sur_reqs), "wall_s": surrogate_s,
                    "n_deferred": [r.n_deferred for r in sur_results],
                    "n_evaluations": [r.n_evaluations for r in sur_results],
                    "captures_during": len(sur_captures), "held": watch.held,
                    "screen_forwards_in_capture": watch.forwards_in_capture,
                    "fits_in_service": fits_in_service,
                    "fit_s": [t1 - t0 for t0, t1 in watch.fits],
                    "waves": stats3["waves"]["n_waves"],
                    "hit_rate": stats3["hit_rate"]},
         lost_wave={"victim_error": repr(victim.error)[:200], "after_ok": after.ok},
         backends=per_backend, phase_s=phase_s, launches=launches,
         expected_launches=want_launches,
         **telemetry, checks=checks, ok=all(checks.values()))
    shutil.rmtree(tmp, ignore_errors=True)
    if not all(checks.values()):
        raise SystemExit(f"service checks failed: {checks}")
    return launches


REPEAT_CALLS = 16  # calls of each kernel on the same inputs in phase repeat_bits


def phase_repeat_bits(torch):
    """K4 (bf16, yi-9b's prefill), K5 (bf16, yi-9b's decode) and K1 (internvl2's
    patches) called REPEAT_CALLS times each, back to back on the same inputs:
    every output must have the same bits as the first (a race in a kernel, an
    mbarrier phase or a split-merge order, shows as a difference)."""
    from repro_torch.kernels.decode_attn import ops as dops
    from repro_torch.kernels.flash_attn import ops as fops
    from repro_torch.kernels.pruned_quant import ops as pq

    gen = torch.Generator(device="cuda").manual_seed(5)

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)

    B, Sq, Sk, Hq, Hkv, d, causal = YI_PREFILL
    q, k, v = rn(B, Sq, Hq, d), rn(B, Sk, Hkv, d), rn(B, Sk, Hkv, d)
    Bd, Hqd, Hkvd, S, dd = YI_DECODE
    qd, kd, vd = rn(Bd, Hqd, dd), rn(Bd, S, Hkvd, dd), rn(Bd, S, Hkvd, dd)
    kv_len = torch.randint(1, S + 1, (Bd,), generator=gen, device="cuda", dtype=torch.int32)
    x, mask = k1_inputs(torch, VLM_PATCHES, "random", seed=7)
    calls = {"flash_attention": lambda: fops.flash_attention(q, k, v, causal),
             "decode_attention": lambda: dops.decode_attention(qd, kd, vd, kv_len),
             "pruned_quantize": lambda: pq.pruned_quantize(x, mask)}
    out = {}
    for name, call in calls.items():
        outs = [call() for _ in range(REPEAT_CALLS)]  # back to back, no wait between
        torch.cuda.synchronize()
        differ = [i for i, o in enumerate(outs[1:], 1) if not torch.equal(o, outs[0])]
        out[name] = {"calls": REPEAT_CALLS, "differing_calls": differ}
    ok = not any(r["differing_calls"] for r in out.values())
    emit("repeat_bits", shapes={"flash_attention": list(YI_PREFILL),
                                "decode_attention": list(YI_DECODE),
                                "pruned_quantize": list(VLM_PATCHES)},
         kernels=out, ok=ok)
    if not ok:
        raise SystemExit(f"a kernel gave other bits on the same inputs: {out}")


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
    (after a first, capturing call), ADC-only and with the three genome axes;
    then one refine call of the hybrid (4 members, eager)."""
    from repro_torch.core import hybrid, qat, trainer

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
    ecfg = trainer.EvalConfig(max_steps=PROFILE_GRAPH_STEPS, genome_axes=GENOME_AXES)
    rows, extra, seeds, (gm, gc) = _axes_rows(P, seed=5)
    params0, idx = trainer.draw_rows(seeds, ecfg, mcfg, X_tr.shape[0])
    run = trainer.make_row_program(X_tr, y_tr, X_te, y_te, mcfg, ecfg, device="cuda")
    run(*rows, params0, idx, *extra)
    torch.cuda.synchronize()
    emit("profile", version="graph_axes", steps=ecfg.max_steps, rows=P,
         **_profiled(torch, lambda: run(*rows, params0, idx, *extra),
                     f"profile_graph_axes_{ecfg.max_steps}_steps.json"))
    refine = hybrid.make_refiner(X_tr, y_tr, sizes, N_BITS, GENOME_AXES, hybrid.HybridConfig(
        grad_steps=GENOME_SLICE["hybrid_grad_steps"]), device="cuda")
    refine(gm[:4], gc[:4])
    emit("profile", version="refine_call", members=4,
         grad_steps=GENOME_SLICE["hybrid_grad_steps"],
         **_profiled(torch, lambda: refine(gm[:4], gc[:4]), "profile_refine_call.json"))


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
# K4's windowed instance, bf16 only: (B, S, Hq, Hkv, d, window).  The first two
# are K-EXAONE-236B's window layers at the cell's shortest and longest
# prompts; the longest is timed.  The plain version runs in blocks of queries
# (its whole (S, S) scores at 32768 would be 275 GB).
WINDOW_CASES = [
    (1, 4096, 64, 8, 128, 128),
    (1, 32768, 64, 8, 128, 128),
    (1, 100, 64, 8, 128, 128),    # shorter than the window
    (2, 1000, 16, 2, 128, 128),   # ragged tile edge, two rows
    (1, 777, 8, 8, 64, 100),      # a window that is no multiple of a key tile
    (1, 513, 8, 2, 128, 1),       # each query keeps itself alone
]
KEXAONE_WINDOW = WINDOW_CASES[1]
WINDOW_BLOCK_Q = 1024
# K4's narrower-v instance, bf16 only: DeepSeek-V3's latent attention at the
# dsv3-long-ttft cell's shortest and longest prompts, (B, S, H, d, dv), causal.
# ATTN_TOL alone would hardly check it: each row at 32768 averages hundreds
# of keys, so outputs lie near 0.04.  So the RMS of the gap is held besides
# to MLA_REL_TOL of the plain output's RMS: both sides round to bf16 and the
# kernel's P.V takes bf16 P (2^-9 of a value or a term), some 0.3% of the
# RMS, while a wrong scale or a misplaced v column lands tens of percent off.
MLA_CASES = [(1, 4096, 128, 192, 128), (1, 32768, 128, 192, 128)]
MLA_REL_TOL = 1e-2
MLA_BLOCK_Q = 256
YI_DECODE = (4, 32, 4, 4096, 128)                  # B, Hq, Hkv, S, d
DECODE_EDGES = [
    (1, 8, 8, 128, 64),      # MHA
    (2, 8, 2, 513, 64),      # GQA, ragged tile edge
    (2, 64, 8, 1024, 128),   # command-r-like heads
    (1, 32, 8, 777, 160),    # mistral-nemo-like head dim
    (3, 16, 16, 96, 80),     # zamba2-like
]


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
                "flash_attention_fp32": int(variant == "fp32"), "flash_attention_window": 0,
                "flash_attention_dv": 0}
            err, ok = _close(torch, out, fref.flash_attention_ref(q, k, v, causal), dname)
            rec = {"kernel": "flash_attention", "variant": variant, "dtype": dname,
                   "shape": list(shape), "max_abs_err": err, "tol": ATTN_TOL[dname]}
            if shape == YI_PREFILL:
                qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
                bms, by = flash_bound(*shape, dtype.itemsize)
                rec.update(
                    ms=device_ms(torch, lambda: fops.flash_attention(q, k, v, causal), 3, 3),
                    plain_ms=device_ms(
                        torch, lambda: fref.flash_attention_ref(q, k, v, causal), 3, 3),
                    library_ms=device_ms(torch, lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal, enable_gqa=True), 10, 3),
                    bound_ms=bms, bound_by=by,
                    bound_ms_fp32_cuda_cores=flash_bound(*shape, torch.float32.itemsize)[0]
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
                bms, by = decode_bound(*shape, int(kv_len.clamp(max=S).sum()), dtype.itemsize)
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
    res["flash_attention_window"] = _window_kernels(torch, fops, fref, rn)
    res["flash_attention_dv"] = _dv_kernels(torch, fops, fref, rn)
    return res


def _dv_kernels(torch, fops, fref, rn) -> dict:
    """K4's narrower-v instance against the plain version at MLA_CASES with
    MLA's softmax scale, each call's launches counted; the longest case's
    record (timed beside the plain version, SDPA and the bound), with the
    narrower-v launches of this phase and the largest gaps."""
    import torch.nn.functional as F

    from cardbench.counts.deepseek import mla_attn_bound
    from repro_torch.configs import registry
    from repro_torch.models import mla

    bf16, scale = torch.bfloat16, mla.softmax_scale(registry.get("deepseek-v3"))
    errs, abs_errs, timed, launched = [], [], {}, 0
    for case in MLA_CASES:
        B, S, H, d, dv = case
        q, k = rn(B, S, H, d, dtype=bf16), rn(B, S, H, d, dtype=bf16)
        v = rn(B, S, H, dv, dtype=bf16)
        n0 = dict(fops.LAUNCHES)
        out = fops.flash_attention(q, k, v, True, scale=scale)
        torch.cuda.synchronize()
        counted = {n: fops.LAUNCHES[n] - n0[n] for n in n0} == {
            "flash_attention": 1, "flash_attention_tc": 1, "flash_attention_fp32": 0,
            "flash_attention_window": 0, "flash_attention_dv": 1}

        def plain():
            return fref.flash_attention_ref(q, k, v, True, block_q=MLA_BLOCK_Q, scale=scale)

        want = plain().float()
        gap = out.float() - want
        rms = float(want.square().mean().sqrt())
        err, rel = float(gap.abs().max()), float(gap.square().mean().sqrt()) / rms
        del want, gap
        same = bool(torch.equal(out, fops.flash_attention(q, k, v, True, scale=scale)))
        ok = err <= ATTN_TOL["bfloat16"] and rel <= MLA_REL_TOL and same
        rec = {"kernel": "flash_attention_dv", "variant": "tc", "dtype": "bfloat16",
               "shape": [B, S, H, d, dv], "scale": scale, "plain_rms": rms,
               "max_abs_err": err, "tol": ATTN_TOL["bfloat16"], "rms_rel_err": rel,
               "tol_rms_rel": MLA_REL_TOL, "same_bits_twice": same}
        if case == MLA_CASES[-1]:
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            bms, by = mla_attn_bound(S, H, d, dv)
            rec.update(
                ms=device_ms(torch, lambda: fops.flash_attention(q, k, v, True, scale=scale), 5, 3),
                plain_ms=device_ms(torch, plain, 1, 1),
                library_ms=device_ms(torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, scale=scale), 5, 3),
                bound_ms=bms, bound_by=by)
            timed = rec
        launched += fops.LAUNCHES["flash_attention_dv"] - n0["flash_attention_dv"]
        errs.append(rel)
        abs_errs.append(err)
        emit("attn_kernels", **rec, launch_counted=counted, ok=ok and counted)
        if not (ok and counted):
            raise SystemExit(f"K4's narrower-v instance disagrees with its plain version: {rec}")
        del q, k, v, out
    return {**timed, "max_abs_err": max(abs_errs), "rms_rel_err": max(errs),
            "launches": launched}


def _window_kernels(torch, fops, fref, rn) -> dict:
    """K4's windowed instance against the plain version at WINDOW_CASES, each
    launch counted; a window past every distance gives the causal kernel's
    bits; the fp32 kernel refuses a window and launches nothing.  K-EXAONE's
    longest call is timed beside the plain version, the causal kernel at the
    same shape and the bound (``cardbench/counts/exaone.window_bound``)."""
    from cardbench.counts.exaone import window_bound

    bf16, errs, timed = torch.bfloat16, [], {}
    for case in WINDOW_CASES:
        B, S, Hq, Hkv, d, W = case
        q, k, v = rn(B, S, Hq, d, dtype=bf16), rn(B, S, Hkv, d, dtype=bf16), rn(
            B, S, Hkv, d, dtype=bf16)
        n0 = dict(fops.LAUNCHES)
        out = fops.flash_attention(q, k, v, True, window=W)
        torch.cuda.synchronize()
        counted = {n: fops.LAUNCHES[n] - n0[n] for n in n0} == {
            "flash_attention": 1, "flash_attention_tc": 1, "flash_attention_fp32": 0,
            "flash_attention_window": 1, "flash_attention_dv": 0}

        def plain():
            return fref.flash_attention_ref(q, k, v, True, W, block_q=WINDOW_BLOCK_Q)

        err, ok = _close(torch, out, plain(), "bfloat16")
        rec = {"kernel": "flash_attention_window", "variant": "tc", "dtype": "bfloat16",
               "shape": [B, S, Hq, Hkv, d], "window": W, "max_abs_err": err,
               "tol": ATTN_TOL["bfloat16"]}
        if W >= S:  # no key lies past the window
            rec["equals_causal"] = bool(torch.equal(out, fops.flash_attention(q, k, v, True)))
            ok = ok and rec["equals_causal"]
        if case == KEXAONE_WINDOW:
            bms, by = window_bound(B, S, Hq, Hkv, d, W)
            rec.update(
                ms=device_ms(torch, lambda: fops.flash_attention(q, k, v, True, window=W), 10, 5),
                plain_ms=device_ms(torch, plain, 1, 3),
                causal_ms=device_ms(torch, lambda: fops.flash_attention(q, k, v, True), 2, 3),
                bound_ms=bms, bound_by=by, library_ms=None)
            timed = rec
        errs.append(err)
        emit("attn_kernels", **rec, launch_counted=counted, ok=ok and counted)
        if not (ok and counted):
            raise SystemExit(f"K4's window disagrees with its plain version: {rec}")
        del q, k, v, out
    q, k = rn(1, 256, 8, 64, dtype=torch.float32), rn(1, 256, 2, 64, dtype=torch.float32)
    n0 = dict(fops.LAUNCHES)
    try:
        fops.flash_attention(q, k, k, True, window=64)
        refused = False
    except ValueError as e:
        refused = "no sliding window" in str(e)
    refused = refused and fops.LAUNCHES == n0
    emit("attn_kernels", kernel="flash_attention_window", dtype="float32",
         fp32_refuses_window=refused, ok=refused)
    if not refused:
        raise SystemExit("K4's fp32 kernel took a window")
    return {**timed, "max_abs_err": max(errs)}


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
    """K4's per-variant launch counts for n calls in one dtype without a
    window: bf16 runs on the tensor-core kernel, fp32 on the CUDA-core one."""
    tc = n if dtype == "bfloat16" else 0
    return {"flash_attention_tc": tc, "flash_attention_fp32": n - tc, "flash_attention_window": 0,
            "flash_attention_dv": 0}


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
        bms, by = flash_bound(*shape, dtype.itemsize)
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
        bms, by = decode_bound(B, Hq, Hkv, S, d, int(kv_len.clamp(max=S).sum()),
                               dtype.itemsize)
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
    from repro_torch.kernels.rms_norm import ops as nops
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
        nops.reset_launch_counts()
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
        launches = {**read_counts(), **nops.LAUNCHES}
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
            "decode_attention": cfg.n_layers * main_calls["decode_step"],
            # ln1, ln2 a layer and the final norm, a prefill or a decode step: 97
            "rms_norm": _norms_a_call(transformer, cfg)[0] * sum(main_calls.values()),
            "rms_norm_residual": 0}
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


# ---------------------------------------------------------------------------
# the MoE, RWKV-6 and Zamba2 families: reduced parity, then full width
# ---------------------------------------------------------------------------

PHI = "phi3.5-moe-42b-a6.6b"
# phi3.5-moe's 32 layers are 83.7 GB of bf16 weights, more than the card's
# 80 GB; 28 would leave under 8 GiB for caches and activations; 24 take 62.9 GB
MOE_LAYERS = 24
# decode vs prefill on a full-width 2-layer draw (after the 24 layers are
# freed) with capacity_factor 8: C = S at the prefill and 1 a decode step, so
# neither drops a pair (at the config's 1.25 a 64-token prefill has C = 10)
MOE_CHECK_LAYERS = 2
MOE_CHECK_CAPACITY = 8.0
FAMILY_PARITY = (("moe_parity", (PHI, "arctic-480b")), ("ssm_parity", ("rwkv6-1.6b",)),
                 ("hybrid_parity", ("zamba2-2.7b",)))
PARITY_SCHEDULES = {"together": (), "staggered": (0, 1, 3, 5)}
FULL_PREFILL = 4096  # tokens of the full-width prefill, B = 1
DECODE_PROMPT = 64   # tokens of the full-width decode-vs-prefill check
ZAMBA_PREFILL = (1, 4096, 4096, 32, 32, 80, True)  # B, Sq, Sk, Hq, Hkv, d, causal
ZAMBA_DECODE = (4, 32, 32, 4096, 80)                # B, Hq, Hkv, S, d


def _family_module(family: str):
    """The module whose ``forward``/``prefill``/``decode_step`` a family's model calls."""
    from repro_torch.models import hybrid, rwkv6, transformer, whisper

    return {"dense": transformer, "moe": transformer, "vlm": transformer, "audio": whisper,
            "ssm": rwkv6, "hybrid": hybrid}[family]


def phase_family_parity(torch):
    """Reduced phi3.5-moe, arctic, rwkv6 and zamba2 in fp32: one set of
    seed-drawn parameters on the card and on the port's CPU path."""
    import numpy as np

    from repro_torch.configs import registry
    from repro_torch.kernels.decode_attn import ops as dops
    from repro_torch.kernels.flash_attn import ops as fops
    from repro_torch.launch import serve
    from repro_torch.models import build_model, init_cache

    fields = ("requests", "decode_steps", "peak_active", "first_token_step", "finish_step")
    for phase, archs in FAMILY_PARITY:
        for arch in archs:
            started = time.perf_counter()
            cfg = registry.reduced(registry.get(arch))
            model, module = build_model(cfg), _family_module(cfg.family)
            params = {"cpu": model.init_params(torch.Generator().manual_seed(0))}
            params["cuda"] = {k: v.to("cuda") for k, v in params["cpu"].items()}
            k4_before, k5_before = dict(fops.LAUNCHES), dops.LAUNCHES["decode_attention"]
            served_equal, tokens_card = {}, {}
            for name, arrival in PARITY_SCHEDULES.items():
                kw = dict(SERVE_PARITY, arch=arch, arrival_steps=arrival)
                run = {dev: serve.run(serve.ServeConfig(**kw, device=dev), params=params[dev])
                       for dev in ("cuda", "cpu")}
                served_equal[name] = all(run["cuda"][f] == run["cpu"][f] for f in fields)
                tokens_card[name] = run["cuda"]["requests"]
            B, S = 2, 16
            toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
            res = {}
            for dev in ("cuda", "cpu"):
                p, tok = params[dev], torch.from_numpy(toks).to(dev)
                with torch.inference_mode():
                    r = {"forward_logits": module.forward(p, tok, cfg)}
                    r["prefill_logits"], cache = model.prefill(p, tok)
                    r.update({f"prefill_{n}": t for n, t in cache.items()})
                    c = init_cache(model, B, S, dev)
                    kv, steps = torch.zeros(B, dtype=torch.int32, device=dev), []
                    for t in range(S):
                        lg, c = model.decode_step(p, tok[:, t], c, kv)
                        kv = kv + 1
                        steps.append(lg)
                    r["decode_logits"] = torch.stack(steps, 1)
                    r.update({f"decode_{n}": t for n, t in c.items()})
                res[dev] = {n: t.float().cpu() for n, t in r.items()}
            gaps = {n: float((res["cuda"][n] - res["cpu"][n]).abs().max()) for n in res["cpu"]}
            close = all(torch.allclose(res["cuda"][n], res["cpu"][n], rtol=LM_PARITY_TOL,
                                       atol=LM_PARITY_TOL) for n in res["cpu"])
            k5 = dops.LAUNCHES["decode_attention"] - k5_before
            if cfg.family == "ssm":  # attention-free: neither kernel
                kernels_ok = k5 == 0 and dict(fops.LAUNCHES) == k4_before
            else:
                kernels_ok = k5 > 0 and fp32_variant_only(fops, k4_before)
            ok = all(served_equal.values()) and close and kernels_ok
            emit(phase, seconds=time.perf_counter() - started, arch=f"{arch} (reduced, fp32)",
                 served_equal=served_equal,
                 tokens_card=tokens_card, max_abs_gap=gaps, tol=LM_PARITY_TOL,
                 k5_launches=k5, kernels_ok=kernels_ok, ok=ok)
            if not ok:
                raise SystemExit(f"the card's reduced {arch} leaves the port's CPU path")


def _full_width_main_path(torch, model, module, params, serve_cfg, tokens,
                          keep_logits: bool = False) -> dict:
    """A served family's main path at full width, its launches read from this
    run alone: a prefill of ``tokens`` (B = 1) twice (the first includes
    cuBLAS's set-up), then ``serve.run``; the last prefill's logits kept
    when asked."""
    from repro_torch.kernels.rms_norm import ops as nops
    from repro_torch.launch import serve

    calls = {"prefill": 0, "decode_step": 0}
    originals = {n: _count_calls(module, n, calls) for n in calls}
    try:
        # -- the main path: counts set to 0 just before, read just after
        read_counts = _reset_all_counts()
        nops.reset_launch_counts()
        prefill_ms = []
        with torch.inference_mode():
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, _ = model.prefill(params, tokens)
                torch.cuda.synchronize()
                prefill_ms.append((time.perf_counter() - t0) * 1e3)
            finite = bool(torch.isfinite(logits).all())
            if not keep_logits:
                del logits
        t0 = time.perf_counter()
        out = serve.run(serve_cfg, params=params)
        serve_s = time.perf_counter() - t0
        launches = {**read_counts(), **nops.LAUNCHES}
        main_calls = dict(calls)
    finally:
        for n, f in originals.items():
            setattr(module, n, f)
    return dict(prefill_ms=prefill_ms, prefill_finite=finite, serve_s=serve_s, out=out,
                launches=launches, calls=main_calls, logits=logits if keep_logits else None)


def _norms_a_call(module, cfg) -> tuple[int, int]:
    """RMS norms a prefill or a decode step sends to the norm kernel, and how
    many of them add the residual: the transformer family's ln1 and ln2 (and
    q/k norms) a layer, the final norm; the other families keep
    ``layers.rms_norm``."""
    from repro_torch.models import transformer

    if module is not transformer:
        return 0, 0
    per_layer = 4 if cfg.qk_norm else 2
    return per_layer * cfg.n_layers + 1, 2 * cfg.n_layers if cfg.post_norm else 0


def _expected_launches(attn_per_call: int, calls: dict, window_layers: int = 0,
                       norms: tuple[int, int] = (0, 0)) -> dict:
    want = {"pruned_quantize": 0, "flash_attention": attn_per_call * calls["prefill"],
            "decode_attention": attn_per_call * calls["decode_step"]}
    want.update(k4_variants(want["flash_attention"]))
    want["flash_attention_window"] = window_layers * calls["prefill"]
    n_calls = calls["prefill"] + calls["decode_step"]
    want.update(rms_norm=norms[0] * n_calls, rms_norm_residual=norms[1] * n_calls)
    return want


def _decode_step_ms(torch, model, params, tok, n: int = 16):
    """Wall ms of a decode step at B = 4, 64 positions in (a warm-up step first)."""
    from repro_torch.models import init_cache

    c = init_cache(model, 4, FULL_PREFILL, "cuda")
    kv_len = torch.full((4,), 64, dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        model.decode_step(params, tok, c, kv_len)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            model.decode_step(params, tok, c, kv_len + i)
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3, c, kv_len + n


def _profile_family(torch, phase, tag, model, params, tokens, c, kv_len):
    tok = tokens[0, :4].contiguous()

    def four_steps():
        for i in range(4):
            model.decode_step(params, tok, c, kv_len + i)

    with torch.inference_mode():
        emit(f"{phase}_profile", what="4 decode steps, B=4",
             **_profiled(torch, four_steps, f"profile_{tag}_decode.json"))
        emit(f"{phase}_profile", what=f"prefill of {tokens.shape[1]} tokens, B=1",
             **_profiled(torch, lambda: model.prefill(params, tokens),
                         f"profile_{tag}_prefill.json"))


def _teacher_forced(torch, model, params, prompt):
    """Decode over ``prompt`` (1, S) from a zeroed cache: (1, S, V) fp32 logits."""
    from repro_torch.models import init_cache

    c = init_cache(model, 1, prompt.shape[1], "cuda")
    kv_len = torch.zeros(1, dtype=torch.int32, device="cuda")
    dec = []
    for t in range(prompt.shape[1]):
        lg, c = model.decode_step(params, prompt[:, t], c, kv_len)
        kv_len = kv_len + 1
        dec.append(lg)
    return torch.stack(dec, 1).float()


# fp32 decode vs fp32 prefill of the recurrent families at full width: their
# bf16 floor is as large as the logits (random weights at full depth amplify
# rounding: rwkv6's per-head RMS norm of near-zero WKV outputs), so the same
# check runs in fp32 with a bound on the logits' range: the largest gap at
# most FP32_DECODE_REL of max |logit| (rwkv6 measured 1.4%, zamba2 0.1%, on
# an NVIDIA H100 80GB HBM3), and the greedy token equal at FP32_DECODE_ARGMAX
# of the positions (measured 98.4% and 100%).  A stale state or a wrong
# position moves the logits by the whole range and the tokens to chance.
FP32_DECODE_REL = 0.05
FP32_DECODE_ARGMAX = 0.9


def _decode_vs_prefill(torch, model, module, cfg, params, prompt, fp32_check=False) -> dict:
    """Teacher-forced decode over ``prompt`` (1, S) from a zeroed cache against
    the prefill's logits, beside the bf16 prefill's distance from an fp32
    evaluation of the same weights (the floor).  With ``fp32_check`` (rwkv6,
    zamba2), also the fp32 decode against that fp32 prefill, within
    FP32_DECODE_REL of its max |logit| and FP32_DECODE_ARGMAX greedy tokens."""
    import dataclasses

    from repro_torch.models import build_model

    V = cfg.vocab_size
    with torch.inference_mode():
        pre, _ = model.prefill(params, prompt)
        dec = _teacher_forced(torch, model, params, prompt)
        params32 = {k: v.float() for k, v in params.items()}
        f32, _ = module.prefill(params32, prompt, cfg)
        pre = pre.float()
        extra = {}
        if fp32_check:
            cfg32 = dataclasses.replace(cfg, dtype="float32")
            dec32 = _teacher_forced(torch, build_model(cfg32), params32, prompt)
            gap32 = float((dec32 - f32).abs().max())
            agree32 = float((dec32[..., :V].argmax(-1) == f32[..., :V].argmax(-1)).float().mean())
            tol32 = FP32_DECODE_REL * float(f32.abs().max())
            extra = dict(decode_vs_prefill_fp32_max_abs=gap32, decode_fp32_tol=tol32,
                         argmax_agreement_fp32=agree32,
                         consistent_fp32=gap32 <= tol32 and agree32 >= FP32_DECODE_ARGMAX)
        del params32
    gap = float((dec - pre).abs().max())
    floor = float((pre - f32).abs().max())
    return dict(decode_vs_prefill_max_abs=gap, prefill_bf16_vs_fp32_max_abs=floor,
                fp32_logits_max_abs=float(f32.abs().max()),
                decode_bf16_vs_fp32_max_abs=float((dec - f32).abs().max()),
                decode_tol=DECODE_FLOOR_FACTOR * floor,
                argmax_agreement=float(
                    (dec[..., :V].argmax(-1) == pre[..., :V].argmax(-1)).float().mean()),
                consistent=gap <= DECODE_FLOOR_FACTOR * floor, **extra)


def _draw(torch, model, seed: int):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    n_bytes = sum(p.numel() * p.element_size() for p in params.values())
    return params, time.perf_counter() - t0, n_bytes


def _served_checks(main: dict, serve_cfg, V: int, attn_per_call: int,
                   window_layers: int = 0, norms: tuple[int, int] = (0, 0)) -> dict:
    out = main["out"]
    want = _expected_launches(attn_per_call, main["calls"], window_layers, norms)
    return {
        "prefill_logits_finite": main["prefill_finite"],
        "every_request_done": len(out["requests"]) == serve_cfg.n_requests and all(
            len(t) == serve_cfg.gen_len for t in out["requests"].values()),
        "tokens_in_vocab": all(0 <= x < V for t in out["requests"].values() for x in t),
        "launch_counts": main["launches"] == want and main["calls"]["prefill"] == 2
        and main["calls"]["decode_step"] > 0,
    }


def _served_fields(main: dict, serve_cfg, attn_per_call: int, window_layers: int = 0,
                   norms: tuple[int, int] = (0, 0)) -> dict:
    import dataclasses

    out, n_dec = main["out"], main["calls"]["decode_step"]
    return dict(prefill_tokens=FULL_PREFILL, prefill_ms=main["prefill_ms"],
                serve=dataclasses.asdict(serve_cfg), serve_s=main["serve_s"], decode_calls=n_dec,
                serve_ms_per_decode_call=main["serve_s"] / n_dec * 1e3,
                tokens_generated=out["tokens_generated"], tokens_per_s=out["tokens_per_s"],
                decode_steps=out["decode_steps"], peak_active=out["peak_active"],
                first_token_step=out["first_token_step"], finish_step=out["finish_step"],
                calls=main["calls"], launches=main["launches"],
                expected_launches=_expected_launches(attn_per_call, main["calls"],
                                                     window_layers, norms))


def phase_moe_slice(torch, profile: bool = False):
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.launch import serve
    from repro_torch.models import (
        build_model,
        exact_n_active_params,
        exact_n_params,
        transformer,
    )

    started = time.perf_counter()
    allocated_before = _free_device(torch)
    cfg = dataclasses.replace(registry.get(PHI), n_layers=MOE_LAYERS)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params, init_s, n_bytes = _draw(torch, model, 0)
    V = cfg.vocab_size
    tokens = torch.randint(0, V, (1, FULL_PREFILL), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(1))
    serve_cfg = serve.ServeConfig(
        arch=PHI, reduced=False, n_layers=MOE_LAYERS, max_batch=4, max_len=4096, n_requests=4,
        prompt_len=32, gen_len=16, arrival_steps=(0, 4, 8, 12), device="cuda")
    main = _full_width_main_path(torch, model, transformer, params, serve_cfg, tokens)
    peak = torch.cuda.max_memory_allocated()

    # -- the share of (token, k) pairs the prefill's capacity dropped (a third,
    # untimed prefill, its routes read)
    dropped, route = [], transformer._moe_route

    def routed(h, lp, c):
        res = route(h, lp, c)
        dropped.append((~res[3]).sum())
        return res

    transformer._moe_route = routed
    try:
        with torch.inference_mode():
            model.prefill(params, tokens)
    finally:
        transformer._moe_route = route
    C = max(int(cfg.capacity_factor * FULL_PREFILL * cfg.top_k / cfg.n_experts), 1)
    pairs = cfg.n_layers * FULL_PREFILL * cfg.top_k
    per_layer = (torch.stack(dropped).float() / (FULL_PREFILL * cfg.top_k)).tolist()
    drop_share = sum(per_layer) / cfg.n_layers

    step_ms, c, kv_len = _decode_step_ms(torch, model, params, tokens[0, :4].contiguous())
    if profile:
        _profile_family(torch, "moe", "phi35moe", model, params, tokens, c, kv_len)
    del c
    # -- scheduling independence: the same requests all at once
    again = serve.run(dataclasses.replace(serve_cfg, arrival_steps=()), params=params)
    same_tokens = again["requests"] == main["out"]["requests"]
    del params
    # -- decode vs prefill on a full-width 2-layer draw, nothing dropped
    _free_device(torch)
    cut = dataclasses.replace(registry.get(PHI), n_layers=MOE_CHECK_LAYERS,
                              capacity_factor=MOE_CHECK_CAPACITY)
    m2 = build_model(cut)
    p2, _, _ = _draw(torch, m2, 2)
    dvp = _decode_vs_prefill(torch, m2, transformer, cut, p2, tokens[:, :DECODE_PROMPT])
    del p2

    # reckonings from the shapes: a decode step computes every expert (E*C =
    # 16 slots a row) so it reads every layer weight; the prefill's expert GEMMs
    d, f, E = cfg.d_model, cfg.expert_d_ff, cfg.n_experts
    layer_bytes = n_bytes - 2 * cfg.padded_vocab * d * 2
    expert_flops = 2 * 3 * E * C * d * f * cfg.n_layers
    norms = _norms_a_call(transformer, cfg)
    checks = _served_checks(main, serve_cfg, V, cfg.n_layers, norms=norms)
    checks.update(decode_matches_prefill=dvp.pop("consistent"), scheduling_independent=same_tokens)
    emit("moe_slice", seconds=time.perf_counter() - started, arch=PHI, dtype=cfg.dtype,
         n_layers=cfg.n_layers,
         n_layers_published=registry.get(PHI).n_layers, d_model=d, n_experts=E,
         top_k=cfg.top_k, expert_d_ff=f, capacity_factor=cfg.capacity_factor,
         n_params=exact_n_params(cfg),
         n_active_params=exact_n_active_params(cfg), param_bytes=n_bytes,
         allocated_before_bytes=allocated_before, init_s=init_s, peak_memory_bytes=peak,
         prefill_capacity=C, prefill_pairs=pairs, prefill_dropped_share=drop_share,
         prefill_dropped_share_by_layer=per_layer,
         decode_step_ms_b4=step_ms,
         reckoning={"layer_weight_bytes": layer_bytes,
                    "decode_step_bound_ms": layer_bytes / HBM_BYTES_PER_S * 1e3,
                    "prefill_expert_flops": expert_flops,
                    "prefill_expert_bound_ms": expert_flops / BF16_FLOPS * 1e3},
         **_served_fields(main, serve_cfg, cfg.n_layers, norms=norms),
         decode_check_layers=MOE_CHECK_LAYERS, decode_check_capacity_factor=MOE_CHECK_CAPACITY,
         **dvp, checks=checks, ok=all(checks.values()))
    if not all(checks.values()):
        raise SystemExit(f"moe_slice checks failed: {checks}")
    return main["launches"]


def phase_ssm_slice(torch, profile: bool = False):
    from repro_torch.configs import registry
    from repro_torch.launch import serve
    from repro_torch.models import build_model, exact_n_params, rwkv6

    started = time.perf_counter()
    allocated_before = _free_device(torch)
    cfg = registry.get("rwkv6-1.6b")
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params, init_s, n_bytes = _draw(torch, model, 0)
    V = cfg.vocab_size
    tokens = torch.randint(0, V, (1, FULL_PREFILL), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(1))
    serve_cfg = serve.ServeConfig(arch=cfg.name, reduced=False, max_batch=4, max_len=4096,
                                  n_requests=4, prompt_len=64, gen_len=32, device="cuda")
    main = _full_width_main_path(torch, model, rwkv6, params, serve_cfg, tokens,
                                 keep_logits=True)
    peak = torch.cuda.max_memory_allocated()

    # -- the two chunked forms at 4096 tokens: forward (recursive) against
    # the main path's prefill (explicit), within the factor of the prefill's
    # bf16-vs-fp32 floor
    pre = main.pop("logits")
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fwd = rwkv6.forward(params, tokens, cfg)
        torch.cuda.synchronize()
        forward_ms = (time.perf_counter() - t0) * 1e3
        forms_gap = float((fwd.float() - pre.float()).abs().max())
        del fwd
        params32 = {k: v.float() for k, v in params.items()}
        pre32, _ = rwkv6.prefill(params32, tokens, cfg)
        forms_floor = float((pre.float() - pre32).abs().max())
        fwd32 = rwkv6.forward(params32, tokens, cfg)
        forms_gap_fp32 = float((fwd32 - pre32).abs().max())
        del pre, pre32, fwd32, params32

    step_ms, c, kv_len = _decode_step_ms(torch, model, params, tokens[0, :4].contiguous())
    if profile:
        _profile_family(torch, "ssm", "rwkv6", model, params, tokens, c, kv_len)
    del c
    dvp = _decode_vs_prefill(torch, model, rwkv6, cfg, params, tokens[:, :DECODE_PROMPT],
                             fp32_check=True)
    del params
    checks = _served_checks(main, serve_cfg, V, 0)
    checks.update(forward_matches_prefill=forms_gap <= DECODE_FLOOR_FACTOR * forms_floor,
                  decode_matches_prefill=dvp.pop("consistent"),
                  decode_matches_prefill_fp32=dvp.pop("consistent_fp32"))
    emit("ssm_slice", seconds=time.perf_counter() - started, arch=cfg.name, dtype=cfg.dtype,
         n_layers=cfg.n_layers, d_model=cfg.d_model,
         ssm_chunk=cfg.ssm_chunk, n_params=exact_n_params(cfg), param_bytes=n_bytes,
         allocated_before_bytes=allocated_before, init_s=init_s, peak_memory_bytes=peak,
         forward_ms=forward_ms, forward_vs_prefill_max_abs=forms_gap,
         forward_vs_prefill_tol=DECODE_FLOOR_FACTOR * forms_floor,
         forward_vs_prefill_fp32_max_abs=forms_gap_fp32, decode_step_ms_b4=step_ms,
         **_served_fields(main, serve_cfg, 0), **dvp, checks=checks, ok=all(checks.values()))
    if not all(checks.values()):
        raise SystemExit(f"ssm_slice checks failed: {checks}")
    return main["launches"]


def _zamba_kernels(torch) -> dict:
    """K4 and K5 in bf16 at zamba2's full-length shapes (d = 80, G = 1)
    against their plain versions, timed by CUDA events beside plain, SDPA
    and the bound (K5 by events, not the profiler: after the profiled
    phases a session loses too many records at this size)."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attn import ops as dops
    from repro_torch.kernels.decode_attn import ref as dref
    from repro_torch.kernels.flash_attn import ops as fops
    from repro_torch.kernels.flash_attn import ref as fref

    gen = torch.Generator(device="cuda").manual_seed(3)
    bf = torch.bfloat16

    def rn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(bf)

    B, Sq, Sk, Hq, Hkv, d, causal = ZAMBA_PREFILL
    q, k, v = rn(B, Sq, Hq, d), rn(B, Sk, Hkv, d), rn(B, Sk, Hkv, d)
    err, ok = _close(torch, fops.flash_attention(q, k, v, causal),
                     fref.flash_attention_ref(q, k, v, causal), "bfloat16")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    bms, by = flash_bound(*ZAMBA_PREFILL, bf.itemsize)
    res = {"flash_attention": dict(
        shape=list(ZAMBA_PREFILL), variant=fops.variant(bf, d), max_abs_err=err,
        tol=ATTN_TOL["bfloat16"], ok=ok,
        ms=device_ms(torch, lambda: fops.flash_attention(q, k, v, causal), 3, 3),
        plain_ms=device_ms(torch, lambda: fref.flash_attention_ref(q, k, v, causal), 3, 3),
        library_ms=device_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal), 10, 3),
        bound_ms=bms, bound_by=by)}
    B, Hq, Hkv, S, d = ZAMBA_DECODE
    q, k, v = rn(B, Hq, d), rn(B, S, Hkv, d), rn(B, S, Hkv, d)
    kv_len = torch.randint(1, S + 1, (B,), generator=gen, device="cuda", dtype=torch.int32)
    kv_len[0], kv_len[1] = S, 1
    err, ok = _close(torch, dops.decode_attention(q, k, v, kv_len),
                     dref.decode_attention_ref(q, k, v, kv_len), "bfloat16")
    mask = (torch.arange(S, device="cuda")[None, :] < kv_len[:, None])[:, None, None]
    q4, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    bms, by = decode_bound(*ZAMBA_DECODE, int(kv_len.clamp(max=S).sum()), bf.itemsize)
    res["decode_attention"] = dict(
        shape=list(ZAMBA_DECODE), kv_len=kv_len.tolist(),
        n_split=dops.split_plan(B, Hkv, S)[0], max_abs_err=err, tol=ATTN_TOL["bfloat16"], ok=ok,
        ms=device_ms(torch, lambda: dops.decode_attention(q, k, v, kv_len)),
        plain_ms=device_ms(torch, lambda: dref.decode_attention_ref(q, k, v, kv_len)),
        library_ms=device_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, kt, vt, attn_mask=mask)),
        bound_ms=bms, bound_by=by)
    return res


def phase_hybrid_slice(torch, profile: bool = False):
    from repro_torch.configs import registry
    from repro_torch.launch import serve
    from repro_torch.models import build_model, exact_n_params, hybrid

    started = time.perf_counter()
    allocated_before = _free_device(torch)
    cfg = registry.get("zamba2-2.7b")
    model = build_model(cfg)
    n_super = hybrid._n_super(cfg)[0]
    torch.cuda.reset_peak_memory_stats()
    params, init_s, n_bytes = _draw(torch, model, 0)
    V = cfg.vocab_size
    tokens = torch.randint(0, V, (1, FULL_PREFILL), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(1))
    serve_cfg = serve.ServeConfig(arch=cfg.name, reduced=False, max_batch=4, max_len=4096,
                                  n_requests=4, prompt_len=64, gen_len=32, device="cuda")
    main = _full_width_main_path(torch, model, hybrid, params, serve_cfg, tokens)
    peak = torch.cuda.max_memory_allocated()
    step_ms, c, kv_len = _decode_step_ms(torch, model, params, tokens[0, :4].contiguous())
    if profile:
        _profile_family(torch, "hybrid", "zamba2", model, params, tokens, c, kv_len)
    del c
    dvp = _decode_vs_prefill(torch, model, hybrid, cfg, params, tokens[:, :DECODE_PROMPT],
                             fp32_check=True)
    del params
    kernels = _zamba_kernels(torch)
    checks = _served_checks(main, serve_cfg, V, n_super)
    checks.update(decode_matches_prefill=dvp.pop("consistent"),
                  decode_matches_prefill_fp32=dvp.pop("consistent_fp32"),
                  kernels_at_zamba2_shapes=all(r["ok"] for r in kernels.values()))
    emit("hybrid_slice", seconds=time.perf_counter() - started, arch=cfg.name, dtype=cfg.dtype,
         n_layers=cfg.n_layers,
         shared_attention_calls=n_super, d_model=cfg.d_model, n_params=exact_n_params(cfg),
         param_bytes=n_bytes, allocated_before_bytes=allocated_before, init_s=init_s,
         peak_memory_bytes=peak, decode_step_ms_b4=step_ms,
         **_served_fields(main, serve_cfg, n_super), **dvp, kernels_at_zamba2_shapes=kernels,
         checks=checks, ok=all(checks.values()))
    if not all(checks.values()):
        raise SystemExit(f"hybrid_slice checks failed: {checks}")
    return main["launches"]


# ---------------------------------------------------------------------------
# LM training: K4/K5 refuse autograd, the card against the CPU, yi-9b at
# full width, the train_lm drill
# ---------------------------------------------------------------------------

TRAIN_FAMILIES = ("yi-9b", PHI, "internvl2-26b", "rwkv6-1.6b", "zamba2-2.7b", "whisper-medium")
TRAIN_PARITY_SHAPE = (2, 32)  # B, seq_len of the reduced families' parity step
# the recurrent families' gradients (rwkv6, zamba2) are held to this share of
# each leaf's largest magnitude: at init a per-head or gated RMS norm
# normalises near-zero outputs and scales their gradients up, so the order
# of a sum shows (tests/test_torch_loss.py; the reference's own jitted and
# op-by-op gradients part by up to 4.4e-5 (rwkv6) and 7.1e-5 (zamba2) of a
# leaf's scale on the CPU)
RECURRENT_GRAD_REL = 5e-4
OPTIM_SHAPES = {"w": (512, 768), "stack": (4, 128, 96), "b": (768,)}
OPTIM_FP32_REL = 1e-5  # fp32 leaves, card vs CPU, of the leaf's largest magnitude
BF16_ULP = 2.0 ** -8
TRAIN_SLICE_LAYERS = 8      # yi-9b's 48 layers and their AdamW state are 106 GB
TRAIN_SLICE_SHAPE = (2, 4096)  # global batch, seq_len: the reference's train_4k shape
TRAIN_SLICE_STEPS = 6
TRAIN_SLICE_EF_STEPS = 2    # int8_ef steps at full width, where the peak leaves room
EF_BYTES_PER_PARAM = 13     # the old and new fp32 error buffers, the int8 codes, fp32 grads
TRAIN_LM_STEPS = 60         # the train_lm drill: a crash at half, resumes from the newest
TRAIN_LM_EF_STEPS = 10


KEXAONE = "k-exaone-236b-a23b"
KEXAONE_LAYERS = 8   # two periods of "LLLG": 6 window layers, 2 global; 11 GB in bf16
KEXAONE_DECODE = (200, 8)  # the decode check: prompt tokens, positions compared


def phase_kexaone_slice(torch, profile: bool = False):
    """``profile`` is taken as the other slices take it; the cell's traced runs
    profile this model (``cardbench``), so this phase does not."""
    import dataclasses

    from cardbench import harness
    from cardbench.reference import exaone_moe
    from repro_torch.configs import registry
    from repro_torch.launch import serve
    from repro_torch.models import build_model, init_cache, transformer

    started = time.perf_counter()
    allocated_before = _free_device(torch)
    cfg = dataclasses.replace(registry.get(KEXAONE), n_layers=KEXAONE_LAYERS)
    n_win = sum(map(cfg.windowed, range(cfg.n_layers)))
    model = build_model(cfg)
    # the kexaone-long-ttft cell's files at this depth: its weights (normal /
    # sqrt(fan_in), norms one: the router's scores spread as in its check),
    # its check's gap, limit and positions
    run = harness.Run("kexaone-long-ttft", 0, 0.0, False,
                      overrides={"config": {"num_hidden_layers": KEXAONE_LAYERS}})
    run.torch = torch
    driver = harness.load_module("drivers", run.traffic["driver"])
    ref_cfg, limit, P = (driver.sizes(run.config), run.cell["limits"]["logit_err"],
                         run.cell["check_positions"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = driver.make_weights(run, model)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_bytes = sum(p.numel() * p.element_size() for p in params.values())
    V = cfg.vocab_size
    tokens = torch.randint(0, V, (1, FULL_PREFILL), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(1))
    # prompts of 32 tokens and 160 generated: every ring wraps
    serve_cfg = serve.ServeConfig(
        arch=KEXAONE, reduced=False, n_layers=KEXAONE_LAYERS, max_batch=4, max_len=512,
        n_requests=4, prompt_len=32, gen_len=160, arrival_steps=(0, 4, 8, 12), device="cuda")
    main = _full_width_main_path(torch, model, transformer, params, serve_cfg, tokens,
                                 keep_logits=True)
    peak = torch.cuda.max_memory_allocated()

    # the cell's check at this depth: the prefill's last positions, and decode
    # steps through the rings, against the fp32 reference
    got = main.pop("logits")[0, -P:]
    S, n_dec = KEXAONE_DECODE
    seq = tokens[0, :S + n_dec]
    with torch.inference_mode():
        want = exaone_moe.logits_at(params, ref_cfg, [tokens[0]],
                                    [list(range(FULL_PREFILL - P, FULL_PREFILL))])[0]
        prefill_gaps = driver._gaps(got, want, V)
        del got, want
        logits, pre = model.prefill(params, seq[None, :S])
        served = [logits[0, -1]]
        cache = init_cache(model, 1, S + n_dec, "cuda")
        cache["k"][:, :, :S], cache["v"][:, :, :S] = pre["k"], pre["v"]
        cache["k_win"].copy_(pre["k_win"])
        cache["v_win"].copy_(pre["v_win"])
        del logits, pre
        kv_len = torch.full((1,), S, dtype=torch.int32, device="cuda")
        for j in range(n_dec - 1):
            step, cache = model.decode_step(params, seq[S + j][None], cache, kv_len)
            served.append(step[0])
            kv_len += 1
        want = exaone_moe.logits_at(params, ref_cfg, [seq], [list(range(S - 1, S + n_dec - 1))])
        decode_gaps = driver._gaps(torch.stack(served), want[0], V)
    del params, cache, served, want
    _free_device(torch)

    norms = _norms_a_call(transformer, cfg)
    checks = _served_checks(main, serve_cfg, V, cfg.n_layers, n_win, norms)
    checks.update(prefill_logit_err=statistics.median(prefill_gaps) <= limit,
                  decode_logit_err=statistics.median(decode_gaps) <= limit)
    emit("kexaone_slice", seconds=time.perf_counter() - started, arch=KEXAONE, dtype=cfg.dtype,
         n_layers=cfg.n_layers, n_layers_published=registry.get(KEXAONE).n_layers,
         window_layers=n_win, window=cfg.window, experts_held=cfg.experts_held,
         n_experts=cfg.n_experts, param_bytes=n_bytes, allocated_before_bytes=allocated_before,
         init_s=init_s, peak_memory_bytes=peak, logit_err_limit=limit,
         prefill_logit_err_median=statistics.median(prefill_gaps),
         prefill_logit_err_positions=prefill_gaps, decode_prompt=S,
         decode_logit_err_median=statistics.median(decode_gaps),
         decode_logit_err_positions=decode_gaps,
         **_served_fields(main, serve_cfg, cfg.n_layers, n_win, norms), checks=checks,
         ok=all(checks.values()))
    if not all(checks.values()):
        raise SystemExit(f"kexaone_slice checks failed: {checks}")
    return main["launches"]


def _dv_row(attn: dict) -> dict:
    """The kernels line's row of K4's narrower-v instance (no TPU kernel: the
    JAX package has no latent attention), timed at dsv3-long-ttft's longest
    prompt; its launches are phase 7's own (no serving path here runs it),
    and beside the widest gap the gap's RMS over the plain output's."""
    w = attn["flash_attention_dv"]
    return {"name": "flash_attention_dv", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attn/csrc/flash_attn_tc.cu",
            "replaces": "none: the JAX package has no latent attention",
            "launches": w["launches"], "max_abs_err": w["max_abs_err"],
            "rms_rel_err": w["rms_rel_err"],
            "ms": w["ms"], "plain_ms": w["plain_ms"], "bound_ms": w["bound_ms"],
            "bound_by": w["bound_by"], "library_ms": w["library_ms"]}


def _window_row(attn: dict, launches: dict) -> dict:
    """The kernels line's row of K4's windowed instance (no TPU kernel: the
    JAX package has no window), timed at K-EXAONE's longest prompt."""
    w = attn["flash_attention_window"]
    return {"name": "flash_attention_window", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attn/csrc/flash_attn_tc.cu",
            "replaces": "none: the JAX package has no sliding window",
            "launches": launches["flash_attention_window"], "max_abs_err": w["max_abs_err"],
            "ms": w["ms"], "plain_ms": w["plain_ms"], "bound_ms": w["bound_ms"],
            "bound_by": w["bound_by"], "library_ms": None}


# the norm kernel's cases: K-EXAONE's prefill at its longest and shortest
# prompt (the hidden state, d 6144, as internvl2's; q's 64 and k's 8 heads of
# 128) and a decode step's hidden state; the first two are timed in bf16
NORM_CASES = (("hidden_32768", (1, 32768, 6144)), ("q_32768", (1, 32768, 64, 128)),
              ("k_32768", (1, 32768, 8, 128)), ("hidden_4096", (1, 4096, 6144)),
              ("decode_hidden", (4, 6144)))
NORM_TIMED = ("hidden_32768", "q_32768")
NORM_EPS = 1e-5


def phase_norm_kernel(torch) -> dict:
    """The norm kernel against ``layers.rms_norm`` at NORM_CASES (see 17c);
    returns the timed cases by (case, residual)."""
    sys.path.insert(0, str(ROOT / "tests"))
    from _torch_rms_norm import check_close

    from repro_torch.kernels.rms_norm import ops as nops
    from repro_torch.models import layers as L

    started, timed = time.perf_counter(), {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, shape in NORM_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            def rn(*shape_, scale=1.0):
                return scale * torch.randn(shape_, generator=gen, device="cuda")

            x = (rn(*shape) * torch.exp(3 * torch.rand(shape[:-1] + (1,), generator=gen,
                                                       device="cuda"))).to(dtype)
            scale, res = (1 + rn(shape[-1], scale=0.2)).to(dtype), rn(*shape, scale=4).to(dtype)
            for r in (None, res):
                def kernel(r=r):
                    return nops.rms_norm(x, scale, NORM_EPS, r)

                def plain(r=r):
                    y = L.rms_norm(x, scale, NORM_EPS)
                    return y if r is None else r + y

                with torch.inference_mode():
                    n0 = dict(nops.LAUNCHES)
                    out = kernel()
                    counted = {k: nops.LAUNCHES[k] - n0[k] for k in n0} == {
                        "rms_norm": 1, "rms_norm_residual": int(r is not None)}
                    same = bool(torch.equal(out, kernel()))
                    torch.cuda.synchronize()
                    rec = {"case": name, "shape": list(shape), "dtype": str(dtype)[6:],
                           "residual": r is not None, "launch_counted": counted,
                           "repeat_bits": same,
                           "max_abs_err": float((out.float() - plain().float()).abs().max())}
                    try:
                        rec.update(check_close(out, x, scale, NORM_EPS, r), close=True)
                    except AssertionError as e:
                        rec.update(close=False, why=str(e))
                    if dtype == torch.bfloat16 and name in NORM_TIMED:
                        bms, by = roofline(x.numel() * x.element_size() * (2 + (r is not None)),
                                           0, BF16_FLOPS)
                        rec.update(ms=kernel_ms(torch, kernel, "rms_norm_kernel"),
                                   plain_ms=device_ms(torch, plain, 5, 3), bound_ms=bms,
                                   bound_by=by)
                        rec["bound_share"] = bms / rec["ms"]
                        timed[(name, r is not None)] = rec
                ok = counted and same and rec["close"]
                emit("norm_kernel", **rec, ok=ok)
                if not ok:
                    raise SystemExit(f"the norm kernel disagrees with layers.rms_norm: {rec}")
                del out
            del x, scale, res
    emit("norm_kernel", seconds=time.perf_counter() - started, ok=True)
    return timed


def _norm_row(norm: dict, launches: dict) -> dict:
    """The kernels line's row of the norm kernel (no TPU kernel: the JAX
    package's norm is plain code), at K-EXAONE's 32768 x 6144 hidden state."""
    w = norm[("hidden_32768", False)]
    return {"name": "rms_norm", "route": "cuda",
            "source": "src/repro_torch/kernels/rms_norm/csrc/rms_norm.cu",
            "replaces": "none: the JAX package has no norm kernel",
            "launches": launches.get("rms_norm", 0),
            "max_abs_err": max(r["max_abs_err"] for r in norm.values()), "ms": w["ms"],
            "plain_ms": w["plain_ms"], "bound_ms": w["bound_ms"], "bound_by": w["bound_by"],
            "library_ms": None}


def _parity_gap(got, want, recurrent_grads: bool) -> tuple[float, float, bool]:
    """The largest |got - want| of one leaf (card, CPU), the same as a share
    of the leaf's largest magnitude, and whether it is within the bound:
    LM_PARITY_TOL absolute and relative; for a recurrent family's gradients
    RECURRENT_GRAD_REL of the leaf's largest magnitude."""
    diff = (got.float().cpu() - want.float()).abs()
    gap = float(diff.max())
    scaled = gap / max(float(want.float().abs().max()), 1e-30)
    if recurrent_grads:
        return gap, scaled, scaled <= RECURRENT_GRAD_REL
    return gap, scaled, bool((diff <= LM_PARITY_TOL * (1 + want.float().abs())).all())


def phase_train_guard(torch):
    """K4 and K5 on the card refuse a call that autograd would record (any of
    q, k, v requiring grad) and launch nothing; under no_grad each launches
    once, as before."""
    from repro_torch.kernels.decode_attn import ops as dops
    from repro_torch.kernels.flash_attn import ops as fops

    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=torch.bfloat16)

    kv_len = torch.full((4,), 512, dtype=torch.int32, device="cuda")
    cases = {
        "flash_attention": (fops, lambda q, k, v: fops.flash_attention(q, k, v, causal=True),
                            (rnd(1, 256, 32, 128), rnd(1, 256, 4, 128), rnd(1, 256, 4, 128))),
        "decode_attention": (dops, lambda q, k, v: dops.decode_attention(q, k, v, kv_len),
                             (rnd(4, 32, 128), rnd(4, 512, 4, 128), rnd(4, 512, 4, 128))),
    }
    records = {}
    for name, (mod, call, inputs) in cases.items():
        refused = {}
        for i, which in enumerate("qkv"):
            args = [t.clone().requires_grad_(j == i) for j, t in enumerate(inputs)]
            before = mod.LAUNCHES[name]
            try:
                call(*args)
                refused[which] = False
            except RuntimeError as e:
                refused[which] = "no backward" in str(e) and mod.LAUNCHES[name] == before
        before = mod.LAUNCHES[name]
        with torch.no_grad():
            out = call(*[t.clone().requires_grad_() for t in inputs])
        torch.cuda.synchronize()
        records[name] = dict(refused_under_autograd=refused,
                             no_grad_launches=mod.LAUNCHES[name] - before,
                             no_grad_finite=bool(torch.isfinite(out).all()))
    ok = all(all(r["refused_under_autograd"].values()) and r["no_grad_launches"] == 1
             and r["no_grad_finite"] for r in records.values())
    emit("train_guard", **records, ok=ok)
    if not ok:
        raise SystemExit(f"K4/K5 must refuse autograd on the card: {records}")


def _optim_gap(got: dict, want: dict, slack: dict | None = None) -> tuple[float, bool]:
    """The largest gap of a dict of leaves as a share of each leaf's largest
    magnitude, and whether every leaf is within its bound (fp32
    OPTIM_FP32_REL, bf16 one ulp, plus ``slack`` of the leaf)."""
    worst, ok = 0.0, True
    for k, w in want.items():
        g, w32 = got[k].float().cpu(), w.float()
        rel = float((g - w32).abs().max()) / max(float(w32.abs().max()), 1e-30)
        bound = (BF16_ULP if w.element_size() == 2 else OPTIM_FP32_REL) + (slack or {}).get(k, 0.0)
        worst, ok = max(worst, rel), ok and rel <= bound
    return worst, ok


def phase_optim(torch):
    """Each optimizer (three updates), clip and compress -> decompress (three
    steps) on one fixed tree, on the card and on the CPU: the int8 codes
    equal, the rest within OPTIM_FP32_REL of each leaf's scale (bf16: one
    ulp; Adafactor's parameters also lr x one bf16 ulp of its momentum an
    update)."""
    import numpy as np

    from repro_torch import optim
    from repro_torch.optim import compress

    started = time.perf_counter()
    rng = np.random.default_rng(0)
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in OPTIM_SHAPES.items()}
    gs = [{k: (rng.normal(size=s) * 0.5).astype(np.float32) for k, s in OPTIM_SHAPES.items()}
          for _ in range(3)]
    peak_lr = 0.1
    makers = {"adamw": lambda: optim.adamw(lr=optim.cosine_warmup(peak_lr, 2, 10)),
              "adafactor": lambda: optim.adafactor(lr=optim.cosine_warmup(peak_lr, 2, 10)),
              "sgd": lambda: optim.sgd_momentum(lr=0.05)}

    def tensors(tree, dev, dtype=torch.float32):
        return {k: torch.from_numpy(v).to(dev, dtype) for k, v in tree.items()}

    records, ok = {}, True
    for name, make in makers.items():
        for dtype in (torch.float32, torch.bfloat16):
            out = {}
            for dev in ("cuda", "cpu"):
                opt = make()
                p = tensors(p0, dev, dtype)
                s = opt.init(p)
                for g in gs:
                    p, s = opt.update(tensors(g, dev, dtype), s, p)
                out[dev] = (p, s)
            (pc, sc), (pp, sp) = out["cuda"], out["cpu"]
            slack = ({k: 3 * peak_lr * BF16_ULP * float(sp.mu[k].float().abs().max())
                      / max(float(pp[k].float().abs().max()), 1e-30) for k in pp}
                     if name == "adafactor" else None)
            gaps = {"params": _optim_gap(pc, pp, slack)}
            for field in sp._fields:
                if isinstance(getattr(sp, field), dict):
                    gaps[field] = _optim_gap(getattr(sc, field), getattr(sp, field))
            step_equal = int(sc.step) == int(sp.step) == 3
            rec_ok = step_equal and all(v[1] for v in gaps.values())
            records[f"{name}_{str(dtype)[6:]}"] = {k: v[0] for k, v in gaps.items()} | {
                "ok": rec_ok}
            ok = ok and rec_ok
    clip = {dev: optim.clip_by_global_norm(tensors(gs[0], dev), 1.0) for dev in ("cuda", "cpu")}
    norm_rel = abs(float(clip["cuda"][1]) - float(clip["cpu"][1])) / float(clip["cpu"][1])
    clip_gap, clip_ok = _optim_gap(clip["cuda"][0], clip["cpu"][0])
    records["clip"] = {"norm_rel_gap": norm_rel, "grads": clip_gap,
                       "ok": clip_ok and norm_rel <= OPTIM_FP32_REL}
    state = {dev: compress.init_state(tensors(p0, dev)) for dev in ("cuda", "cpu")}
    codes_equal, scales_equal, err_gap, deq_gap = True, True, 0.0, 0.0
    for it, g in enumerate(gs):
        res = {}
        for dev in ("cuda", "cpu"):
            codes, scales, state[dev] = compress.compress_gradients(
                tensors({k: v * 10.0 ** (it - 1) for k, v in g.items()}, dev), state[dev])
            res[dev] = (codes, scales, compress.decompress_gradients(codes, scales))
        for k in g:
            codes_equal &= torch.equal(res["cuda"][0][k].cpu(), res["cpu"][0][k])
            scales_equal &= float(res["cuda"][1][k]) == float(res["cpu"][1][k])
            err_gap = max(err_gap, float((state["cuda"].error[k].cpu()
                                          - state["cpu"].error[k]).abs().max()))
            deq_gap = max(deq_gap, float((res["cuda"][2][k].cpu() - res["cpu"][2][k]).abs().max()))
    records["compress"] = {"codes_equal": codes_equal, "scales_equal": scales_equal,
                           "error_max_abs_gap": err_gap, "decompressed_max_abs_gap": deq_gap,
                           "ok": codes_equal}
    ok = ok and records["clip"]["ok"] and codes_equal
    emit("optim", seconds=time.perf_counter() - started, shapes=OPTIM_SHAPES,
         fp32_rel_bound=OPTIM_FP32_REL, bf16_bound=BF16_ULP, **records, ok=ok)
    if not ok:
        raise SystemExit(f"the optimizers on the card leave the CPU path: {records}")


def phase_train_parity(torch):
    """The six reduced families in fp32, one set of seed-drawn parameters on
    the card and on the port's CPU path: the loss, every gradient, and one
    ``train_step`` (clip, AdamW) within the fp32 bound; K4 and K5 launch 0
    times in a step, K1 once for internvl2 and whisper (their patches and
    frames)."""
    from repro_torch.configs import registry
    from repro_torch.data.tokens import TokenConfig, TokenStream
    from repro_torch.launch import train

    B, S = TRAIN_PARITY_SHAPE
    for arch in TRAIN_FAMILIES:
        started = time.perf_counter()
        cfg = registry.reduced(registry.get(arch))
        tcfg = train.TrainConfig(arch=arch, global_batch=B, seq_len=S)
        model, opt, _, step = train.build_train_state(cfg)
        params = {"cpu": model.init_params(torch.Generator().manual_seed(0))}
        params["cuda"] = {k: v.to("cuda") for k, v in params["cpu"].items()}
        stream = TokenStream(TokenConfig(cfg.vocab_size, S, B, 0))
        res, launches = {}, None
        for dev in ("cuda", "cpu"):
            batch = train.step_batch(stream, 0, cfg, tcfg, dev)
            leaves = {k: v.detach().clone().requires_grad_() for k, v in params[dev].items()}
            loss = model.loss_fn(leaves, batch)
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
            counts = _reset_all_counts()
            p1, s1, _, loss1, gnorm = step(params[dev], opt.init(params[dev]), None, batch)
            if dev == "cuda":
                torch.cuda.synchronize()
                launches = counts()
            res[dev] = {"loss": {"loss": loss.detach(), "step_loss": loss1, "gnorm": gnorm},
                        "grads": grads, "params": p1, "mu": s1.mu, "nu": s1.nu}
        recurrent = cfg.family in ("ssm", "hybrid")
        gaps, scaled, ok = {}, {}, True
        for part, leaves in res["cpu"].items():
            per = {k: _parity_gap(res["cuda"][part][k], v, recurrent and part == "grads")
                   for k, v in leaves.items()}
            gaps[part] = max(g for g, _, _ in per.values())
            scaled[part] = max(s for _, s, _ in per.values())
            ok = ok and all(within for _, _, within in per.values())
        k1_want = 1 if cfg.family in ("vlm", "audio") else 0
        kernels_ok = (launches["flash_attention"] == 0 and launches["decode_attention"] == 0
                      and launches["pruned_quantize"] == k1_want)
        ok = ok and kernels_ok
        emit("train_parity", seconds=time.perf_counter() - started,
             arch=f"{arch} (reduced, fp32)", batch=[B, S],
             loss_card=float(res["cuda"]["loss"]["loss"]),
             max_abs_gap=gaps, max_gap_of_leaf_scale=scaled, tol=LM_PARITY_TOL,
             grad_bound=(f"{RECURRENT_GRAD_REL} of each leaf's scale" if recurrent else "tol"),
             step_launches={k: launches[k] for k in
                            ("flash_attention", "decode_attention", "pruned_quantize")},
             kernels_ok=kernels_ok, ok=ok)
        if not ok:
            raise SystemExit(f"the card's reduced {arch} training step leaves the CPU path")


def _attention_fp32_flops(cfg, B: int, S: int) -> float:
    """fp32 FLOPs of the plain attention's two score GEMMs (QK^T, PV; the
    mask is applied after, so all S^2 pairs) in one rematted step: the
    forward, its recomputation and the backward's two GEMMs a product."""
    per_forward = 2 * (2 * B * cfg.n_heads * S * S * cfg.hd)
    return 4 * per_forward * cfg.n_layers


def phase_train_slice(torch, profile: bool = False):
    """yi-9b at full width, depth cut to TRAIN_SLICE_LAYERS, bf16, AdamW,
    remat: TRAIN_SLICE_STEPS steps of ``train.build_train_state``'s step on
    the reference's train_4k shape, timed by CUDA events; peak memory; the
    parameters checkpointed and restored bit for bit; int8_ef at full width
    where the peak leaves room."""
    import os
    import tempfile

    from repro_torch.checkpoint import ckpt
    from repro_torch.data.tokens import TokenConfig, TokenStream
    from repro_torch.launch import train
    from repro_torch.models import exact_n_params
    from repro_torch.optim import compress

    started = time.perf_counter()
    allocated_before = _free_device(torch)
    B, S = TRAIN_SLICE_SHAPE
    tcfg = train.TrainConfig(arch="yi-9b", reduced=False, n_layers=TRAIN_SLICE_LAYERS,
                             global_batch=B, seq_len=S)
    cfg = train.model_config(tcfg)
    model, opt, init_fn, step = train.build_train_state(cfg)
    n_params = exact_n_params(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt_state = init_fn(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state_bytes = torch.cuda.memory_allocated() - allocated_before
    stream = TokenStream(TokenConfig(cfg.vocab_size, S, B, 0))

    def run_steps(fn, first: int, n: int, comp=None):
        nonlocal params, opt_state
        out = {"losses": [], "gnorms": [], "step_ms": [], "wall_ms": []}
        for i in range(first, first + n):
            batch = train.step_batch(stream, i, cfg, tcfg, "cuda")
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            params, opt_state, comp, loss, gnorm = fn(params, opt_state, comp, batch)
            end.record()
            torch.cuda.synchronize()
            out["wall_ms"].append((time.perf_counter() - t0) * 1e3)
            out["step_ms"].append(start.elapsed_time(end))
            out["losses"].append(float(loss))
            out["gnorms"].append(float(gnorm))
        return out

    counts = _reset_all_counts()
    timed = run_steps(step, 0, TRAIN_SLICE_STEPS)
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    steady_ms = statistics.median(timed["step_ms"][1:])
    tokens = B * S
    model_flops = 6 * n_params * tokens
    attn_flops = _attention_fp32_flops(cfg, B, S)
    prof = None
    if profile:
        prof = _profiled(torch, lambda: step(params, opt_state, None,
                                             train.step_batch(stream, 0, cfg, tcfg, "cuda")),
                         "profile_train_yi9b_step.json")
    # int8_ef at full width where the measured peak leaves room for its buffers
    total = torch.cuda.get_device_properties(0).total_memory
    ef_room = peak + EF_BYTES_PER_PARAM * n_params < 0.9 * total
    ef = None
    if ef_room:
        torch.cuda.reset_peak_memory_stats()
        _, _, _, ef_step = train.build_train_state(cfg, "int8_ef")
        ef = run_steps(ef_step, TRAIN_SLICE_STEPS, TRAIN_SLICE_EF_STEPS,
                       compress.init_state(params))
        ef["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    # the parameters through a checkpoint: bf16 bits out and back
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "params")
        t0 = time.perf_counter()
        ckpt.save_pytree(path, params, step=TRAIN_SLICE_STEPS)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tree, manifest = ckpt.load_pytree(path)
        load_s = time.perf_counter() - t0
        restored_equal = all(tree[k].dtype == p.dtype == torch.bfloat16
                             and torch.equal(tree[k].to("cuda"), p) for k, p in params.items())
        bf16_manifest = all(m["dtype"] == "bfloat16" for m in manifest["leaves"].values())
        del tree
    del params, opt_state
    finite = all(math.isfinite(x) for x in timed["losses"] + timed["gnorms"]
                 + (ef["losses"] + ef["gnorms"] if ef else []))
    checks = dict(finite=finite, restored_bit_equal=restored_equal,
                  manifest_bfloat16=bf16_manifest,
                  no_attention_kernel=launches["flash_attention"] == 0
                  and launches["decode_attention"] == 0 and launches["pruned_quantize"] == 0)
    emit("train_slice", seconds=time.perf_counter() - started, arch=cfg.name, dtype=cfg.dtype,
         n_layers=cfg.n_layers, d_model=cfg.d_model, global_batch=B, seq_len=S,
         optimizer=type(opt).__name__, remat=cfg.remat, n_params=n_params,
         state_bytes=state_bytes, allocated_before_bytes=allocated_before, init_s=init_s,
         first_step_ms=timed["step_ms"][0], step_ms_median=steady_ms, **timed,
         tokens_per_step=tokens, tokens_per_s=tokens / (steady_ms / 1e3),
         peak_memory_bytes=peak, total_memory_bytes=total,
         model_flops_per_step=model_flops,
         bf16_peak_share=model_flops / (steady_ms / 1e3) / BF16_FLOPS,
         attention_fp32_flops_per_step=attn_flops,
         attention_fp32_ms_at_peak=attn_flops / FP32_FLOPS * 1e3,
         attention_fp32_share_at_peak=attn_flops / FP32_FLOPS * 1e3 / steady_ms,
         profile=prof, int8_ef_full_width=ef_room, int8_ef=ef,
         checkpoint={"save_s": save_s, "load_s": load_s, "bytes": 2 * n_params},
         launches=launches, checks=checks, ok=all(checks.values()))
    if not all(checks.values()):
        raise SystemExit(f"train_slice checks failed: {checks}")
    return ef_room, steady_ms


def phase_train_lm(torch, int8_ef: bool):
    """The twin of ``examples/train_lm.py`` on the card: yi-100m in fp32, B 4,
    S 128, TRAIN_LM_STEPS steps with a crash at half, a resume from the
    newest checkpoint and a second resume from the same checkpoint, which
    must give the same losses bit for bit (the embedding's backward sorts
    its indices on CUDA: on an NVIDIA H100 80GB HBM3 the two agreed with and
    without ``torch.use_deterministic_algorithms``); with
    ``int8_ef``, TRAIN_LM_EF_STEPS steps with int8 gradient compression."""
    import os
    import shutil
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import registry
    from repro_torch.launch import train, train_lm

    started = time.perf_counter()
    _free_device(torch)
    cfg = train_lm.hundred_m_config()
    registry.ARCHS[cfg.name] = cfg
    common = dict(arch=cfg.name, reduced=False, steps=TRAIN_LM_STEPS, global_batch=4,
                  seq_len=128, ckpt_every=25, log_every=10 ** 9, device="cuda")
    counts = _reset_all_counts()
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {n: os.path.join(tmp, n) for n in "ab"}
        t0 = time.perf_counter()
        try:
            train.run(train.TrainConfig(**common, ckpt_dir=dirs["a"],
                                        crash_at=TRAIN_LM_STEPS // 2))
            crashed = False
        except RuntimeError as e:
            crashed = "injected" in str(e)
        crash_run_s = time.perf_counter() - t0
        mgr = CheckpointManager(dirs["a"])
        newest = mgr.latest_step()
        mgr.close()
        shutil.copytree(dirs["a"], dirs["b"])
        runs, seconds = {}, {}
        for n in "ab":
            t0 = time.perf_counter()
            runs[n] = train.run(train.TrainConfig(**common, ckpt_dir=dirs[n], resume=True))
            seconds[n] = time.perf_counter() - t0
        ef = None
        if int8_ef:
            ef = train.run(train.TrainConfig(**dict(common, steps=TRAIN_LM_EF_STEPS),
                                             ckpt_dir=os.path.join(tmp, "ef"),
                                             grad_compression="int8_ef"))
    launches = counts()
    a, b = runs["a"], runs["b"]
    losses = a["losses"] + b["losses"] + (ef["losses"] if ef else [])
    checks = dict(
        crashed=crashed,
        checkpoint_before_crash=newest is not None,
        resumed_from_newest=all(r["start_step"] == (newest or 0) for r in runs.values()),
        replayed_steps=all(len(r["losses"]) == TRAIN_LM_STEPS - (newest or 0)
                           for r in runs.values()),
        finite=all(math.isfinite(x) for x in losses),
        loss_falls=a["final_loss"] < a["losses"][0],
        replay_equal=a["losses"] == b["losses"],
        no_attention_kernel=launches["flash_attention"] == 0
        and launches["decode_attention"] == 0,
    )
    if ef:
        checks["int8_ef_loss_falls"] = ef["final_loss"] < ef["losses"][0]
    registry.ARCHS.pop(cfg.name)  # registered for these runs only: later phases serve configs/'s
    emit("train_lm", seconds=time.perf_counter() - started, arch=cfg.name,
         n_params=train_lm.exact_n_params(cfg), dtype=cfg.dtype, global_batch=4, seq_len=128,
         steps=TRAIN_LM_STEPS, crash_at=TRAIN_LM_STEPS // 2, newest_checkpoint=newest,
         crash_run_s=crash_run_s, resume_s=seconds, first_resume_losses=a["losses"],
         replay_max_abs_gap=max(abs(p - q) for p, q in zip(a["losses"], b["losses"])),
         int8_ef=(dict(losses=ef["losses"]) if ef else None),
         checks=checks, ok=all(checks.values()))
    if not all(checks.values()):
        raise SystemExit(f"train_lm checks failed: {checks}")


@contextlib.contextmanager
def _expandable_segments(torch):
    """PyTorch's allocator growing its segments in place while the block
    runs.  train_slice's int8_ef steps peak at ~70 GB of the card's 85, and
    the state each step writes anew lies between freed activations: in
    fixed-size segments 12.7 GiB of them stayed unusable (out of memory on
    an NVIDIA H100 80GB HBM3 under torch 2.11)."""
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        yield
    finally:
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")


def phase_train(torch, profile: bool = False) -> float:
    """Phases 18-22: LM training; returns train_slice's median step time (ms)."""
    phase_train_guard(torch)
    phase_optim(torch)
    phase_train_parity(torch)
    with _expandable_segments(torch):
        full_width_ef, step_ms = phase_train_slice(torch, profile=profile)
    phase_train_lm(torch, int8_ef=not full_width_ef)
    return step_ms


# ---------------------------------------------------------------------------
# the multi-device layer on one card: grids, plans, elastic, pipeline, dry run
# ---------------------------------------------------------------------------

MESH_ISLAND_SIZES = (8, 5, 11)  # rows of the three islands of mesh_codesign's island call
PLAN_PREFILL = (1, 4096)        # B, tokens of plan_serve's prefill_step
PLAN_DECODE = (4, 4096)         # B, cache positions of plan_serve's serve_step
PLAN_DECODE_STEPS = 16          # serve_steps timed
# B, tokens of plan_serve's DTensor prefill: DTensor cannot reshape a batch
# of 1 sharded over a mesh dim of size 1, so the DTensor route takes 2 rows
PLAN_DTENSOR_PREFILL = (2, 4096)
PR21_TRAIN_STEP_MS = 1179.2     # yi-9b 8 layers, B 2 x 4096: PR 21's measured step (PERF.md)
ELASTIC_STEPS, ELASTIC_DRILL_AT = 6, 3
PIPELINE_SHAPE = dict(n_stages=4, n_micro=4, mb=2, d=16)  # tests/test_distributed.py:33-55
DRYRUN_TIMEOUT_S = 180


def phase_mesh_codesign(torch) -> dict:
    """The population and island evaluators on the card's grid
    (``population_mesh()``, ``island_mesh(3)``: one card gives (1,) and
    (1, 1)) against ``mesh=None``: the same accuracies bit for bit, and the
    same K2/K3 launches; cardio at full width, pop 24, 600 steps."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.printed_mlp import codesign_config
    from repro_torch.core import qat, trainer
    from repro_torch.kernels.fused_qat import ops
    from repro_torch.parallel import sharding as shd

    (X_tr, y_tr, X_te, y_te), sizes = _cardio()
    ccfg = codesign_config("cardio", full=True)
    ecfg = trainer.EvalConfig(max_steps=ccfg.max_steps)
    mcfg = qat.MLPConfig(sizes)
    rows, seeds = _cardio_rows(sum(MESH_ISLAND_SIZES), seed=23)
    rows = tuple(rows) + (seeds,)
    cut = np.cumsum((0,) + MESH_ISLAND_SIZES)
    batches = [tuple(a[cut[i]:cut[i + 1]] for a in rows) for i in range(3)]
    data = (X_tr, y_tr, X_te, y_te, mcfg, ecfg)
    out, launches = {}, {}
    total = {k: 0 for k in ops.LAUNCHES}
    for name, make in (
            ("population_none", lambda: trainer.make_population_evaluator(*data, device="cuda")),
            ("population_grid", lambda: trainer.make_population_evaluator(
                *data, mesh=shd.population_mesh())),
            ("islands_none", lambda: trainer.make_island_evaluator(*data, 3, device="cuda")),
            ("islands_grid", lambda: trainer.make_island_evaluator(
                *data, 3, mesh=shd.island_mesh(3)))):
        ev = make()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = ev(batches) if name.startswith("islands") else ev(*rows)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches[name] = dict(ops.LAUNCHES)
        for k, v in ops.LAUNCHES.items():
            total[k] += v
        out[name] = {"acc": (np.concatenate(res) if isinstance(res, list) else res).tolist(),
                     "seconds": seconds, "stats": dict(ev.stats.items()),
                     "grid": list(ev.mesh.dims)}
    checks = {
        "population_bit_equal": out["population_grid"]["acc"] == out["population_none"]["acc"],
        "islands_bit_equal": out["islands_grid"]["acc"] == out["islands_none"]["acc"],
        "island_rows_are_population_rows": out["islands_none"]["acc"]
        == out["population_none"]["acc"],
        "population_launches_equal": launches["population_grid"]
        == launches["population_none"],
        "islands_launches_equal": launches["islands_grid"] == launches["islands_none"],
        "grids_one_card": out["population_grid"]["grid"] == [1]
        and out["islands_grid"]["grid"] == [1, 1],
        "launched": all(v > 0 for v in total.values()),
        "acc_finite": bool(np.isfinite(out["population_grid"]["acc"]).all()),
    }
    emit("mesh_codesign", dataset="cardio", rows=len(seeds), island_sizes=MESH_ISLAND_SIZES,
         max_steps=ecfg.max_steps, runs=out, launches=launches, checks=checks,
         ok=all(checks.values()))
    if not all(checks.values()):
        raise SystemExit(f"mesh_codesign checks failed: {checks}")
    return total


def _share(flops: float, nbytes: float, ms: float) -> dict:
    """Achieved rates of ``flops`` and ``nbytes`` (host counts) in ``ms`` of
    card time, against the bf16 peak and HBM3."""
    s = ms / 1e3
    return {"flop_per_s": flops / s, "bf16_peak_share": flops / s / BF16_FLOPS,
            "bytes_per_s": nbytes / s, "hbm_share": nbytes / s / HBM_BYTES_PER_S,
            "bound_ms": max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3}


def _attention_credit(torch, cfg, prefill: tuple, decode: tuple) -> dict:
    """Per layer, for plan_serve's two steps: op_cost's count of the plain
    attention the trace runs in the kernel's place (traced alone on fake
    tensors at the step's shapes) and the kernel's own work there.  K4: the
    two products over the causal (query, key) pairs, and q, k, v and o
    moved once; K5: the two products over the positions each row reads
    (its kv_len + 1, the whole cache in this run), and q, those cache rows,
    kv_len and o moved once."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import op_cost
    from repro_torch.models import layers as L

    hd, Hq, Hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    dt = getattr(torch, cfg.dtype)
    elt = torch.empty((), dtype=dt).element_size()
    (Bp, Sp), (Bd, Sd) = prefill, decode
    plain = {}
    with FakeTensorMode():
        for name, fn, args in (
                ("prefill", lambda q, k: L.plain_attention(q, k, k, causal=True),
                 (torch.empty(Bp, Sp, Hq, hd, dtype=dt), torch.empty(Bp, Sp, Hkv, hd, dtype=dt))),
                ("decode", lambda q, k: L.decode_attention_plain(
                    q, k, k, torch.full((Bd,), Sd, dtype=torch.int32)),
                 (torch.empty(Bd, Hq, hd, dtype=dt), torch.empty(Bd, Sd, Hkv, hd, dtype=dt)))):
            counter = op_cost.OpCounter()
            with counter:
                fn(*args)
            plain[name] = {"flops": counter.costs.flops, "hbm_bytes": counter.costs.hbm_bytes}
    own = {
        "prefill": {"flops": 4.0 * hd * Hq * Bp * Sp * (Sp + 1) / 2,
                    "hbm_bytes": float(elt * Bp * Sp * hd * (2 * Hq + 2 * Hkv))},
        "decode": {"flops": 4.0 * hd * Hq * Bd * Sd,
                   "hbm_bytes": float(elt * (2 * Bd * Hq * hd + 2 * Bd * Sd * Hkv * hd)
                                      + 4 * Bd)},
    }
    return {step: {"plain_per_layer": plain[step], "kernel_per_layer": own[step]}
            for step in ("prefill", "decode")}


def _credited(cost, credit: dict, n_layers: int) -> dict:
    """``cost`` (a step's op_cost count) with each layer's plain attention
    replaced by the kernel's own work."""
    return {k: getattr(cost, k) + n_layers * (credit["kernel_per_layer"][k]
                                              - credit["plain_per_layer"][k])
            for k in ("flops", "hbm_bytes")}


def _event_ms(torch, fn, n: int) -> float:
    """Mean card time of ``fn()`` over n calls, by CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


@contextlib.contextmanager
def _plain_norms():
    """The transformer's norms as ``layers.rms_norm`` on plain CUDA tensors
    too, the route a DTensor step takes (``transformer.norm``): the model's
    own calls under it give a DTensor step's bits."""
    from repro_torch.kernels.rms_norm import ops as nops
    from repro_torch.kernels.rms_norm import ref as nref

    kernel, nops.rms_norm = nops.rms_norm, nref.rms_norm_ref
    try:
        yield
    finally:
        nops.rms_norm = kernel


def phase_plan_serve(torch, mesh) -> dict:
    """yi-9b at full width and depth in bf16 (random weights from seed 0, as
    lm_slice draws them): the plan's ``prefill_step`` (B = 1, 4096 tokens)
    and ``serve_step`` (B = 4 against a 4096-long cache) on the 1-rank
    ``make_mesh((1, 1))`` inside ``activation_mesh``, bit-equal to the
    model's ``prefill`` and ``decode_step`` (``launch/serve``'s calls); K4
    and K5 counted on that run alone.  Then the same two steps on DTensor
    parameters, inputs and caches laid out by the plans' placements
    (wrapped without a copy; the prefill at PLAN_DTENSOR_PREFILL), whose
    local shards must take K4 and K5 too (``parallel.local``), with the
    bits of the model's own calls with their norms plain (a DTensor's
    route: ``_plain_norms``).  Each step's card time
    beside its op_cost count at the same shapes (traced on fake tensors on
    the host), in which each layer's plain attention is replaced by the
    kernel's own work before the roofline shares are taken."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import registry
    from repro_torch.kernels.decode_attn import ops as dops
    from repro_torch.kernels.flash_attn import ops as fops
    from repro_torch.launch import shapes, steps
    from repro_torch.models import build_model, init_cache
    from repro_torch.parallel import sharding as shd

    def _wrap(t, sh):
        return DTensor.from_local(t, mesh, list(sh.placements), run_check=False)

    def _full(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    started = time.perf_counter()
    _free_device(torch)
    cfg = registry.get("yi-9b")
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    Bp, Sp = PLAN_PREFILL
    Bd, Sd = PLAN_DECODE
    plan_p = steps.build_plan(cfg, "prefill_32k", mesh,
                              shape=shapes.ShapeSpec("prefill_32k", "prefill", Sp, Bp))
    plan_d = steps.build_plan(cfg, "decode_32k", mesh,
                              shape=shapes.ShapeSpec("decode_32k", "decode", Sd, Bd))
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (Bp, Sp), device="cuda", generator=gen)
    tok = torch.randint(0, cfg.vocab_size, (Bd,), device="cuda", generator=gen)
    kv_len = torch.full((Bd,), Sd - 1, dtype=torch.int32, device="cuda")
    cache = init_cache(model, Bd, Sd, "cuda")
    for t in cache.values():
        t.normal_(generator=gen)
    tokens2 = torch.randint(0, cfg.vocab_size, PLAN_DTENSOR_PREFILL, device="cuda",
                            generator=gen)
    plan_p2 = steps.build_plan(cfg, "prefill_32k", mesh, shape=shapes.ShapeSpec(
        "prefill_32k", "prefill", PLAN_DTENSOR_PREFILL[1], PLAN_DTENSOR_PREFILL[0]))
    with torch.inference_mode():
        # -- the main path: counts set to 0 just before, read just after
        fops.reset_launch_counts()
        dops.reset_launch_counts()
        with shd.activation_mesh(mesh):
            logits_p, cache_p = plan_p.step_fn(params, {"tokens": tokens})
            c_plan = {k: v.clone() for k, v in cache.items()}
            logits_d, c_plan, kv_next = plan_d.step_fn(params, tok, c_plan, kv_len)
        torch.cuda.synchronize()
        launches = {**fops.LAUNCHES, **dops.LAUNCHES}
        ref_p, ref_cache_p = model.prefill(params, tokens)
        c_ref = {k: v.clone() for k, v in cache.items()}
        ref_d, c_ref = model.decode_step(params, tok, c_ref, kv_len)
        equal = {
            "prefill_logits": bool(torch.equal(logits_p, ref_p)),
            "prefill_cache": all(torch.equal(cache_p[k], ref_cache_p[k]) for k in ref_cache_p),
            "decode_logits": bool(torch.equal(logits_d, ref_d)),
            "decode_cache": all(torch.equal(c_plan[k], c_ref[k]) for k in c_ref),
            "kv_len_next": bool(torch.equal(kv_next, kv_len + 1)),
        }
        finite = bool(torch.isfinite(logits_p).all() and torch.isfinite(logits_d).all())
        del logits_p, cache_p, ref_p, ref_cache_p, c_ref
        with _plain_norms():  # the norms a DTensor step runs (transformer.norm)
            ref_p2, ref_cache_p2 = model.prefill(params, tokens2)
            c_ref2 = {k: v.clone() for k, v in cache.items()}
            ref_d2, c_ref2 = model.decode_step(params, tok, c_ref2, kv_len)
    # -- the DTensor route of the same steps: counts set to 0 just before, read just after
    fops.reset_launch_counts()
    dops.reset_launch_counts()
    with torch.no_grad(), shd.activation_mesh(mesh), implicit_replication():
        dparams = {k: _wrap(v, plan_p.in_shardings[0][k]) for k, v in params.items()}
        dl_p, dc_p = plan_p2.step_fn(dparams, {"tokens": _wrap(
            tokens2, plan_p2.in_shardings[1]["tokens"])})
        _, sh_tok, sh_cache, sh_len = plan_d.in_shardings
        dc_d = {k: _wrap(v.clone(), sh_cache[k]) for k, v in cache.items()}
        dl_d, dc_d, dkv = plan_d.step_fn(dparams, _wrap(tok, sh_tok), dc_d,
                                         _wrap(kv_len, sh_len))
        torch.cuda.synchronize()
        dt_launches = {**fops.LAUNCHES, **dops.LAUNCHES}
        dt_out = {"prefill_logits": (_full(dl_p), ref_p2),
                  "decode_logits": (_full(dl_d), ref_d2)}
        dt_out.update({f"prefill_cache_{k}": (_full(dc_p[k]), ref_cache_p2[k]) for k in dc_p})
        dt_out.update({f"decode_cache_{k}": (_full(dc_d[k]), c_ref2[k]) for k in dc_d})
        dt_err = {k: (a.float() - b.float()).abs().max().item() for k, (a, b) in dt_out.items()}
        dt_equal = all(torch.equal(a, b) for a, b in dt_out.values()) and bool(
            torch.equal(_full(dkv), kv_len + 1))
    del dparams, dl_p, dc_p, dc_d, dl_d, dt_out, ref_p2, ref_cache_p2, ref_d2, c_ref2
    with torch.inference_mode(), shd.activation_mesh(mesh):
        prefill_ms = _event_ms(torch, lambda: plan_p.step_fn(params, {"tokens": tokens}), 3)
        decode_ms = _event_ms(torch, lambda: plan_d.step_fn(params, tok, c_plan, kv_len),
                              PLAN_DECODE_STEPS)
    del params, c_plan, cache
    t0 = time.perf_counter()
    cost_p = steps.lower_plan(plan_p, mesh)
    cost_d = steps.lower_plan(plan_d, mesh)
    credit = _attention_credit(torch, cfg, PLAN_PREFILL, PLAN_DECODE)
    trace_s = time.perf_counter() - t0
    own_p = _credited(cost_p, credit["prefill"], cfg.n_layers)
    own_d = _credited(cost_d, credit["decode"], cfg.n_layers)
    want = {"flash_attention": cfg.n_layers, "decode_attention": cfg.n_layers}
    want.update(k4_variants(cfg.n_layers))
    checks = {**{f"{k}_bit_equal": v for k, v in equal.items()}, "finite": finite,
              "launch_counts": launches == want,
              "dtensor_launch_counts": dt_launches == want, "dtensor_bit_equal": dt_equal}
    emit("plan_serve", arch=cfg.name, dtype=cfg.dtype, n_layers=cfg.n_layers,
         mesh=list(mesh.shape),
         prefill=dict(B=Bp, tokens=Sp, ms=prefill_ms, counts=cost_p.as_dict(),
                      credit=credit["prefill"], counts_with_kernel=own_p,
                      **_share(own_p["flops"], own_p["hbm_bytes"], prefill_ms)),
         decode=dict(B=Bd, cache=Sd, ms=decode_ms, counts=cost_d.as_dict(),
                     credit=credit["decode"], counts_with_kernel=own_d,
                     **_share(own_d["flops"], own_d["hbm_bytes"], decode_ms)),
         counted_by="launch/op_cost.py on fake tensors on the host (the plain versions' "
                    "work: K4 as the full S x S scores); shares and bound_ms from "
                    "counts_with_kernel, in which each layer's plain attention is replaced "
                    "by the kernel's own work (K4's causal pairs)",
         trace_s=trace_s, launches=launches, expected_launches=want,
         dtensor=dict(launches=dt_launches, max_abs_err=dt_err, equal=dt_equal),
         seconds=time.perf_counter() - started, checks=checks, ok=all(checks.values()))
    if not all(checks.values()):
        raise SystemExit(f"plan_serve checks failed: {checks}")
    return {k: launches[k] + dt_launches[k] for k in launches}


def phase_plan_train(torch, mesh, step_ms: float | None) -> None:
    """The op_cost count of train_slice's step (yi-9b at TRAIN_SLICE_LAYERS
    layers, B x S = TRAIN_SLICE_SHAPE, AdamW, remat) beside 6·N·D, and the
    bf16-peak share each gives with this run's train_slice step time (when
    it ran) and PR 21's; no second full-width step."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.launch import shapes, steps
    from repro_torch.models import exact_n_params

    B, S = TRAIN_SLICE_SHAPE
    cfg = dataclasses.replace(registry.get("yi-9b"), n_layers=TRAIN_SLICE_LAYERS)
    plan = steps.build_plan(cfg, "train_4k", mesh,
                            shape=shapes.ShapeSpec("train_4k", "train", S, B))
    t0 = time.perf_counter()
    cost = steps.lower_plan(plan, mesh)
    trace_s = time.perf_counter() - t0
    six_nd = 6 * exact_n_params(cfg) * B * S
    times = {"pr21": PR21_TRAIN_STEP_MS}
    if step_ms is not None:
        times["this_run"] = step_ms
    shares = {name: {"op_cost": cost.flops / (ms / 1e3) / BF16_FLOPS,
                     "six_nd": six_nd / (ms / 1e3) / BF16_FLOPS} for name, ms in times.items()}
    checks = {"counted": cost.flops > six_nd > 0, "no_collectives": cost.collective_total == 0}
    emit("plan_train", arch=cfg.name, n_layers=cfg.n_layers, global_batch=B, seq_len=S,
         counts=cost.as_dict(), six_nd=six_nd, op_cost_over_six_nd=cost.flops / six_nd,
         step_ms=times, bf16_peak_share=shares, trace_s=trace_s,
         counted_by="launch/op_cost.py on fake tensors on the host (plain attention: fp32 "
                    "S x S score GEMMs, remat's recompute included)",
         checks=checks, ok=all(checks.values()))
    if not all(checks.values()):
        raise SystemExit(f"plan_train checks failed: {checks}")


def phase_elastic_drill(torch) -> None:
    """``ElasticRunner.drill`` on yi-100m (fp32, B 4, S 128): ELASTIC_STEPS
    steps with a drill after ELASTIC_DRILL_AT (save, recover onto (1, 1),
    go on from the restored state); the losses equal an uninterrupted run's
    bit for bit."""
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data.tokens import TokenConfig, TokenStream
    from repro_torch.launch import steps, train, train_lm
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.elastic import ElasticRunner

    started = time.perf_counter()
    cfg = train_lm.hundred_m_config()
    tcfg = train.TrainConfig(arch=cfg.name, reduced=False, global_batch=4, seq_len=128)
    model, opt, init_fn, step = train.build_train_state(cfg)
    stream = TokenStream(TokenConfig(cfg.vocab_size, 128, 4, 0))

    def run(params, opt_state, first, n):
        losses = []
        for i in range(first, first + n):
            batch = train.step_batch(stream, i, cfg, tcfg, "cuda")
            params, opt_state, _, loss, _ = step(params, opt_state, None, batch)
            losses.append(float(loss))
        return params, opt_state, losses

    init = lambda: init_fn(torch.Generator(device="cuda").manual_seed(0))  # noqa: E731
    _, _, straight = run(*init(), 0, ELASTIC_STEPS)

    def shardings(mesh):
        psh = train.param_shardings(cfg, mesh)
        osh = steps.opt_state_shardings(opt, steps.specs_to_structs(model.param_specs()),
                                        psh, mesh)
        return {"params": psh, **{f"opt_{f}": s for f, s in zip(osh._fields, osh)}}

    with tempfile.TemporaryDirectory() as tmp:
        runner = ElasticRunner(ckpt=CheckpointManager(tmp), model_parallel=1,
                               make_mesh=lambda shape: make_mesh(shape, "cuda"),
                               make_shardings=shardings, build_step=lambda mesh: step)
        params, opt_state, before = run(*init(), 0, ELASTIC_DRILL_AT)
        state = {"params": params, **{f"opt_{f}": getattr(opt_state, f)
                                      for f in opt_state._fields}}
        t0 = time.perf_counter()
        mesh, tree, at, step_fn = runner.drill(state, ELASTIC_DRILL_AT)
        drill_s = time.perf_counter() - t0
        runner.ckpt.close()
    restored = type(opt_state)(*(tree[f"opt_{f}"] for f in opt_state._fields))
    on_card = all(t.is_cuda for t in tree["params"].values())
    _, _, after = run(tree["params"], restored, at, ELASTIC_STEPS - at)
    checks = {"recovered_onto_1x1": tuple(mesh.shape) == (1, 1), "step": at == ELASTIC_DRILL_AT,
              "restored_on_card": on_card, "losses_equal": before + after == straight}
    emit("elastic_drill", arch=cfg.name, steps=ELASTIC_STEPS, drill_at=ELASTIC_DRILL_AT,
         losses=before + after, uninterrupted=straight, drill_s=drill_s,
         seconds=time.perf_counter() - started, checks=checks, ok=all(checks.values()))
    if not all(checks.values()):
        raise SystemExit(f"elastic_drill checks failed: {checks}")


def phase_pipeline(torch) -> None:
    """``pipeline_apply`` on a 1-rank ``stage`` group at the reference test's
    shapes (4 layers of d 16, 4 microbatches of 2): the one stage holds the
    four layers; bit-equal to their sequential composition, microbatch by
    microbatch, and within 1e-6 of it on the whole batch."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.parallel.pipeline import pipeline_apply

    sh = PIPELINE_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    Ws = torch.randn(sh["n_stages"], sh["d"], sh["d"], device="cuda", generator=gen) / 4.0
    x = torch.randn(sh["n_micro"] * sh["mb"], sh["d"], device="cuda", generator=gen)
    mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("stage",))

    def layers(p, h):
        for w in p["w"]:
            h = torch.tanh(h @ w)
        return h

    out = pipeline_apply(layers, {"w": Ws[None]}, x, mesh=mesh, n_micro=sh["n_micro"])
    per_mb = torch.cat([layers({"w": Ws}, m) for m in x.split(sh["mb"])])
    whole = layers({"w": Ws}, x)
    gap = float((out - whole).abs().max())
    checks = {"bit_equal_per_microbatch": bool(torch.equal(out, per_mb)),
              "whole_batch_within_1e-6": gap <= 1e-6}
    emit("pipeline", **sh, stage_group=1, whole_batch_max_abs=gap, checks=checks,
         ok=all(checks.values()))
    if not all(checks.values()):
        raise SystemExit(f"pipeline checks failed: {checks}")


def start_dryrun():
    """``launch.dryrun`` for yi-9b on pod16x16 in a subprocess (host only),
    started now and read by :func:`phase_dryrun`."""
    import os

    out_dir = OUT / "dryrun_torch"
    shutil.rmtree(out_dir, ignore_errors=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "CUDA_VISIBLE_DEVICES": ""}
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "yi-9b",
           "--mesh", "single", "--out-dir", str(out_dir)]
    proc = subprocess.Popen(cmd, cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, out_dir, time.perf_counter()


def phase_dryrun(job) -> None:
    proc, out_dir, t0 = job
    try:
        stdout, stderr = proc.communicate(timeout=max(DRYRUN_TIMEOUT_S - (time.perf_counter()
                                                                           - t0), 1))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise SystemExit(f"dryrun took more than {DRYRUN_TIMEOUT_S} s")
    seconds = time.perf_counter() - t0
    cells = {}
    for path in sorted(out_dir.glob("*.json")):
        rec = json.loads(path.read_text())
        rec.pop("traceback", None)
        cells[rec["shape"]] = rec
    checks = {"exit_0": proc.returncode == 0, "four_cells": len(cells) == 4,
              "three_ok": sum(bool(c.get("ok")) for c in cells.values()) == 3,
              "long_skipped": cells.get("long_500k", {}).get("status") == "skipped(full-attention)"}
    emit("dryrun", arch="yi-9b", mesh="pod16x16", seconds=seconds, cells=cells,
         stdout_tail=stdout[-2000:], stderr_tail="" if proc.returncode == 0 else stderr[-4000:],
         checks=checks, ok=all(checks.values()))
    if not all(checks.values()):
        raise SystemExit(f"dryrun checks failed: {checks}")


def phase_mesh(torch, train_step_ms: float | None = None) -> dict:
    """Phases 23-28: the multi-device layer on the card's 1-rank mesh; returns
    the K2-K5 launches of mesh_codesign and plan_serve."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_single_card_group, make_mesh

    started = time.perf_counter()
    job = start_dryrun()  # host-only: it runs beside the card's phases
    launches = phase_mesh_codesign(torch)
    own = not dist.is_initialized()
    init_single_card_group("nccl")
    try:
        mesh = make_mesh((1, 1), "cuda")
        launches.update(phase_plan_serve(torch, mesh))
        phase_plan_train(torch, mesh, train_step_ms)
        phase_elastic_drill(torch)
        phase_pipeline(torch)
    finally:
        if own:
            dist.destroy_process_group()
    phase_dryrun(job)
    emit("mesh", seconds=time.perf_counter() - started)
    return launches


# phase 29's yardsticks: the paper's mean gains at <5% drop, and the mean that
# the campaign phase (CampaignConfig's defaults, the CI budget) gave on an NVIDIA
# H100 80GB HBM3 at 700 W (PERF.md §5)
PAPER_GAINS = {"area": 11.2, "power": 13.2}
CI_BUDGET_GAINS = {"area": 5.564089820370899, "power": 5.388826508428816}


def phase_adc_codesign(torch) -> dict:
    """Phase 29: the twin of ``examples/adc_codesign.py`` without ``--quick`` on the
    card (the six datasets at the paper's search budget, then K1 on the searched
    Seeds bank and the KV codebook); returns its K1-K3 launches."""
    import numpy as np

    from repro_torch.configs.printed_mlp import codesign_config
    from repro_torch.core import area
    from repro_torch.kernels.fused_qat import ops
    from repro_torch.kernels.pruned_quant import ops as pq
    from repro_torch.launch import adc_codesign

    # -- the main path: counts set to 0 just before, read just after
    ops.reset_launch_counts()
    pq.reset_launch_counts()
    t0 = time.perf_counter()
    with EvaluatorTally() as tally:
        out = adc_codesign.run(quick=False, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**ops.LAUNCHES, **pq.LAUNCHES}
    # every dataset's full budget trains 600 steps a row
    want = {**tally.expected_launches(codesign_config("seeds", full=True).max_steps),
            "pruned_quantize": 1}

    # the plain versions on the CPU, from the same draws (no launch)
    x_cpu, levels_cpu = adc_codesign.searched_bank_levels(
        out["searches"]["seeds"][1]["mask"], "cpu")
    _, codes_cpu, deq_cpu = adc_codesign.kv_codebook_demo("cpu")

    datasets, exact, within = {}, {}, {}
    for ds, (res, g5, g1) in out["searches"].items():
        conv_area, conv_power = area.conventional_cost(res.spec.n_features, 4)
        for budget, g in ((0.05, g5), (0.01, g1)):
            a, p = area.adc_cost(g["mask"], 4)
            exact[f"{ds}@{budget}"] = (conv_area / max(a, 1e-12) == g["area_gain"]
                                       and conv_power / max(p, 1e-12) == g["power_gain"])
            # gains_at_budget falls back to the front's most accurate point when
            # no point is within the budget; the check asks for none to need it
            within[f"{ds}@{budget}"] = bool(g["acc"] >= res.conv_acc - budget)
        datasets[ds] = dict(
            conv_acc=res.conv_acc, front_size=int(res.front_acc.size),
            acc_5pct=g5["acc"], area_gain_5pct=g5["area_gain"],
            power_gain_5pct=g5["power_gain"], acc_1pct=g1["acc"],
            area_gain_1pct=g1["area_gain"], power_gain_1pct=g1["power_gain"],
            kept_levels_mean_5pct=g5["kept_levels_mean"],
            n_evaluations=res.n_evaluations, n_memo_hits=res.n_memo_hits,
            seconds_per_generation=[h["gen_s"] for h in res.history])
    checks = {
        "six_datasets": list(out["searches"]) == list(adc_codesign.PAPER_DATASETS),
        "fronts_nonempty_finite": all(
            r.front_acc.size >= 1 and bool(np.isfinite(r.front_acc).all())
            and bool(np.isfinite(r.front_area).all()) for r, _, _ in out["searches"].values()),
        "level0_kept": all(bool(r.front_masks[:, :, 0].all())
                           for r, _, _ in out["searches"].values()),
        "within_budget": all(within.values()),
        "gains_recomputed_exactly": all(exact.values()),
        "launch_counts": launches == want,
        "k1_equals_plain": torch.equal(out["x"].cpu(), x_cpu)
        and torch.equal(out["levels"].cpu(), levels_cpu),
        "kv_codebook_equals_cpu": out["codes"].is_cuda
        and torch.equal(out["codes"].cpu(), codes_cpu)
        and torch.equal(out["deq"].cpu(), deq_cpu),
    }
    print("\n".join(out["lines"]), flush=True)
    emit("adc_codesign", budget="full (pop 24, 16 generations, step_scale 1.0, 600 steps)",
         seconds=wall, datasets=datasets,
         mean_gain_5pct={"area": out["mean_area_gain"], "power": out["mean_power_gain"]},
         paper_mean_gain=PAPER_GAINS, ci_budget_mean_gain=CI_BUDGET_GAINS,
         n_evaluations=sum(d["n_evaluations"] for d in datasets.values()),
         n_memo_hits=sum(d["n_memo_hits"] for d in datasets.values()),
         k1_levels_row0=out["levels"][0].tolist(), kv_err=out["kv_err"],
         graph_stats={k: tally.total(k) for k in tally.stats[0]},
         launches=launches, expected_launches=want, checks=checks, ok=all(checks.values()))
    if not all(checks.values()):
        raise SystemExit(f"adc_codesign checks failed: {checks}")
    return launches


def phase_quickstart(torch) -> dict:
    """Phase 30: the twin of ``examples/quickstart.py`` on the card; returns its
    K2/K3 launches."""
    from repro_torch.kernels.fused_qat import ops
    from repro_torch.launch import quickstart

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with EvaluatorTally() as tally:
        out = quickstart.run("cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    res, want = out["result"], tally.expected_launches(out["cfg"].max_steps)
    checks = {
        "front_nonempty": res.front_acc.size >= 1,
        "level0_kept": bool(res.front_masks[:, :, 0].all()),
        "baseline_above_chance": res.conv_acc > 1.0 / res.spec.n_classes,
        "launch_counts": launches == want,
    }
    print("\n".join(out["lines"]), flush=True)
    emit("quickstart", seconds=wall, conv_acc=res.conv_acc,
         front_size=int(res.front_acc.size), gains_5pct={
             k: out["gains"][k] for k in ("acc", "area_gain", "power_gain")},
         n_evaluations=res.n_evaluations, n_memo_hits=res.n_memo_hits,
         seconds_per_generation=[h["gen_s"] for h in res.history],
         launches=launches, expected_launches=want, checks=checks, ok=all(checks.values()))
    if not all(checks.values()):
        raise SystemExit(f"quickstart checks failed: {checks}")
    return launches


def _attention_calls_a_step(cfg) -> int:
    """K5 calls in one ``decode_step`` of a family: a layer's self-attention
    (whisper: self and cross), zamba2's shared-attention invocations, rwkv6 none."""
    if cfg.family == "audio":
        return 2 * cfg.n_layers
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    return 0 if cfg.family == "ssm" else cfg.n_layers


def phase_serve_lm(torch) -> dict:
    """Phase 31: the twin of ``examples/serve_lm.py`` for yi-9b, then every other
    arch of ``configs/``, reduced and in fp32: one set of parameters drawn on the
    CPU serves on the card and on the port's CPU path; returns the K5 launches."""
    from repro_torch.configs import registry
    from repro_torch.launch import serve_lm
    from repro_torch.models import build_model

    fields = ("requests", "decode_steps", "first_token_step", "finish_step")
    started, total, per_arch = time.perf_counter(), 0, {}
    threads = torch.get_num_threads()
    for arch in ("yi-9b", *(a for a in registry.ARCHS if a != "yi-9b")):
        cfg = registry.reduced(registry.get(arch))
        params = {"cpu": build_model(cfg).init_params(torch.Generator().manual_seed(0))}
        params["cuda"] = {k: v.to("cuda") for k, v in params["cpu"].items()}
        module, calls = _family_module(cfg.family), {"decode_step": 0}
        orig = _count_calls(module, "decode_step", calls)
        try:
            # -- the main path: counts set to 0 just before, read just after
            read_counts = _reset_all_counts()
            t0 = time.perf_counter()
            card = serve_lm.run(arch, "cuda", params=params["cuda"])
            card_s = time.perf_counter() - t0
            launches = read_counts()
        finally:
            module.decode_step = orig
        torch.set_num_threads(1)  # tiny CPU tensors: one intra-op thread is faster
        try:
            cpu = serve_lm.run(arch, "cpu", params=params["cpu"])
        finally:
            torch.set_num_threads(threads)
        sc = serve_lm.config(arch)
        k5 = _attention_calls_a_step(cfg) * calls["decode_step"]
        checks = {
            "card_equals_cpu": all(card[f] == cpu[f] for f in fields),
            "decode_calls": calls["decode_step"]
            == sc.n_requests * sc.prompt_len + card["decode_steps"],
            "k5_launches": launches["decode_attention"] == k5,
            "no_k4_no_k1": launches["flash_attention"] == 0
            and launches["pruned_quantize"] == 0,
        }
        total += launches["decode_attention"]
        per_arch[arch] = dict(family=cfg.family, seconds=card_s, tokens_per_s=card["tokens_per_s"],
                              decode_steps=card["decode_steps"],
                              decode_calls=calls["decode_step"],
                              k5_launches=launches["decode_attention"], expected_k5=k5,
                              checks=checks)
        if arch == "yi-9b":
            print("\n".join(card["lines"]), flush=True)
        if not all(checks.values()):
            emit("serve_lm", arch=arch, **per_arch[arch], ok=False)
            raise SystemExit(f"serve_lm checks failed for {arch}: {checks}")
    emit("serve_lm", seconds=time.perf_counter() - started, archs=per_arch,
         k5_launches=total, ok=True)
    return {"decode_attention": total}


def phase_examples(torch) -> dict:
    """Phases 29-31: the twins of the reference's three remaining examples;
    returns their launches."""
    started = time.perf_counter()
    launches = phase_adc_codesign(torch)
    for kname, n in phase_quickstart(torch).items():
        launches[kname] += n
    launches.update(phase_serve_lm(torch))
    emit("examples", seconds=time.perf_counter() - started)
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
    from repro_torch.kernels.rms_norm import ops as nops

    def timed(build):
        t0 = time.perf_counter()
        so = build()
        return so, time.perf_counter() - t0

    t0 = time.perf_counter()
    builds = {"fused_qat": qops.build, "decode_attn": dops.build, "flash_attn": fops.build,
              "flash_attn_tc": fops.build_tc, "pruned_quant": pq.build,
              "rms_norm": nops.build}
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
        # spill would put the tables back in memory.  So do the training
        # step's head instances of fixed widths (qat_step_head_kernel<H, K>,
        # H > 0) with a thread's products and sums.
        want = {"pruned_quant": 2, "fused_qat": 4}.get(n)
        if want:
            spills = {k["kernel"]: k["spill_stores"] + k["spill_loads"] for k in report
                      if "RegBank" in k["kernel"] or ("qat_step_head_kernel" in k["kernel"]
                                                      and "ILi0E" not in k["kernel"])}
            if len(spills) != want or any(spills.values()):
                raise SystemExit(f"{n}'s register-path kernels spill or are missing: {spills}")
        # K4's schedule overlaps softmax with asynchronous wgmma groups; a
        # kernel whose wgmma ptxas serialized, or that spills, has lost that.
        # Two instances a head dim (causal, window), one a narrower-v pair.
        if n == "flash_attn_tc":
            lost = [k["kernel"] for k in report if k["wgmma_serialized"]
                    or k["spill_stores"] + k["spill_loads"]]
            if len(report) != 2 * len(fops.TC_HEAD_DIMS) + len(fops.TC_DV_PAIRS) or lost:
                raise SystemExit(f"flash_attn_tc kernels serialized, spilling or missing: {lost}")


def phase_capture_fails(torch):
    """A capture that fails raises, and the trainer does not fall back to the
    eager loop: a step that reads a value back to the host while it is being
    captured (here an injected ``float(...)`` of a parameter before the fused
    step) ends the call with an error, no graph is cached, and only the
    warm-up's launches ran (K2, K3 and the step's three kernels).  Run last:
    the failed capture leaves the CUDA stream state to the driver."""
    from repro_torch.core import qat, trainer
    from repro_torch.kernels.fused_qat import ops

    (X_tr, y_tr, X_te, y_te), sizes = _cardio()
    mcfg, ecfg = qat.MLPConfig(sizes), trainer.EvalConfig(max_steps=20)
    run = trainer.make_row_program(X_tr, y_tr, X_te, y_te, mcfg, ecfg, device="cuda")
    rows, seeds = _cardio_rows(4, seed=3)
    params0, idx = trainer.draw_rows(seeds, ecfg, mcfg, X_tr.shape[0])
    qat_step = ops.qat_step

    def reads_host(X_tr, y_tr, s, j, momentum):
        if torch.cuda.is_current_stream_capturing():
            float(s.params["w0"].sum())  # a host read: not capturable
        return qat_step(X_tr, y_tr, s, j, momentum)

    before = dict(ops.LAUNCHES)
    ops.qat_step = reads_host
    try:
        run(*rows, params0, idx)
        error = None
    except RuntimeError as e:
        error = f"{type(e).__name__}: {e}"[:300]
    finally:
        ops.qat_step = qat_step
    launched = {k: ops.LAUNCHES[k] - before[k] for k in before}
    checks = {"capture_raised": error is not None,
              "no_graph_cached": run.stats["captures"] == 0 and run.stats["replays"] == 0,
              "only_warmup_launched": launched == dict.fromkeys(ops.LAUNCHES,
                                                                trainer.WARMUP_STEPS)}
    emit("capture_fails", error=error, launches=launched, stats=dict(run.stats),
         checks=checks, ok=all(checks.values()))
    if not all(checks.values()):
        raise SystemExit(f"capture_fails: {checks}")


FLAGS = ("--profile", "--attn", "--kexaone", "--families", "--train", "--mesh", "--examples",
         "--service")


def main() -> int:
    unknown = [a for a in sys.argv[1:] if a not in FLAGS]
    if unknown:
        print(f"chip_smoke: unknown arguments {unknown}; known: {' '.join(FLAGS)}",
              file=sys.stderr)
        return 2
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

    profile = "--profile" in args
    build_all(torch)
    if "--attn" in args:  # a kernel change's first call: build, check, time, stop
        attn = phase_attn_kernels(torch)
        phase_mm_attn_kernels(torch)
        print(json.dumps({"kernels": [_dv_row(attn)]}), flush=True)
        return 0
    if "--kexaone" in args:  # K4's window and the norm checked and timed, then its served path
        attn = phase_attn_kernels(torch)
        norm = phase_norm_kernel(torch)
        launches = phase_kexaone_slice(torch, profile=profile)
        print(json.dumps({"kernels": [_window_row(attn, launches), _norm_row(norm, launches)]}),
              flush=True)
        return 0
    if "--families" in args:  # the MoE, RWKV-6 and Zamba2 phases alone: build, run, stop
        phase_family_parity(torch)
        for path in (phase_moe_slice, phase_ssm_slice, phase_hybrid_slice):
            path(torch, profile=profile)
        return 0
    if "--train" in args:  # LM training alone: build, run phases 18-22, stop
        phase_train(torch, profile)
        return 0
    if "--mesh" in args:  # the multi-device layer alone: build, run phases 23-28, stop
        phase_mesh(torch)
        return 0
    if "--examples" in args:  # the three example twins alone: build, run phases 29-31, stop
        phase_examples(torch)
        return 0
    if "--service" in args:  # the evaluation service alone: build, run phase 6d, stop
        phase_service(torch, profile=profile)
        return 0
    kern = phase_kernels(torch)
    phase_placement(torch)
    phase_parity(torch)
    launches = phase_slice(torch)
    for kname, n in phase_campaign(torch).items():
        launches[kname] += n
    for kname, n in phase_genome_slice(torch).items():
        launches[kname] += n
    for kname, n in phase_service(torch, profile=profile).items():
        launches[kname] += n
    phase_qat_profiler(torch)
    step_kernels = phase_qat_step(torch)  # after qat_profiler: more sessions lose records
    if profile:
        phase_profile(torch)
    attn = phase_attn_kernels(torch)
    norm = phase_norm_kernel(torch)
    phase_lm_parity(torch)
    k1 = phase_frontend_kernel(torch)
    phase_repeat_bits(torch)
    phase_mm_attn_kernels(torch)
    phase_vlm_parity(torch)
    phase_audio_parity(torch)
    phase_family_parity(torch)
    # each serving path's launches, read from its own run, summed over the paths
    for path in (phase_lm_slice, phase_vlm_slice, phase_audio_slice, phase_moe_slice,
                 phase_ssm_slice, phase_hybrid_slice, phase_kexaone_slice):
        for kname, n in path(torch, profile=profile).items():
            launches[kname] = launches.get(kname, 0) + n
    train_step_ms = phase_train(torch, profile)
    for kname, n in phase_mesh(torch, train_step_ms).items():
        launches[kname] = launches.get(kname, 0) + n
    for kname, n in phase_examples(torch).items():
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
    rows.append(_window_row(attn, launches))
    rows.append(_dv_row(attn))
    rows.append(_norm_row(norm, launches))
    for kname, t in step_kernels.items():  # no TPU kernel: the plain chain around K2/K3
        rows.append({"name": kname, "route": "cuda",
                     "source": "src/repro_torch/kernels/fused_qat/csrc/fused_qat.cu",
                     "replaces": "src/repro_torch/core/trainer.py:_chain_step (plain ops)",
                     "launches": launches[kname], "max_abs_err": t["max_abs_err"],
                     "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "library_ms": None})
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
