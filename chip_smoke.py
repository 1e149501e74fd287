#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py             # build, check every kernel, run the co-design slice
    python3 chip_smoke.py --profile   # also profile 20 training steps (trace to chiprun_out/)

Phases, one JSON line each; any failure ends the run with a nonzero exit:

1. device     the card's name, count, power limit.
2. build      the kernels, built with nvcc for sm_90a from the repository's sources.
3. kernels    K2 (forward) and K3 (backward) of the fused pruned-ADC QAT layer
              against their plain PyTorch versions on the card, at the main
              path's shapes (P=24 rows, C=21 inputs, F=5 hidden, B=128 and
              the 638-sample test set) and at the comparator edge cases; times
              by CUDA events.
4. placement  a row trained alone and inside a batch of 24 gives the same bits;
              two runs of one batch give the same bits.
5. parity     8 cardio genomes from one draw, on the card and through the
              port's CPU plain path, 600 steps: the per-row accuracy gap must
              stay within the bound measured on the CPU against the JAX package.
6. slice      ``run_codesign`` on cardio at full width (pop 24, 600 steps, 4-bit
              ADCs), 2 generations, with the kernels' launch counts read from
              that run alone.

The last three lines are the card's name and power limit, the kernels'
summary, and ``{"ok": true, "device": {...}}``.  Without CUDA, or without
the repository beside it, the script fails and prints no result.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 (non-tensor) FLOP/s
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

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


def kernel_inputs(torch, B: int, seed: int):
    """Random (P, B, C) inputs and per-row banks with the comparator edge cases."""
    import numpy as np

    from repro_torch.kernels.pruned_quant.ref import make_tables

    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.1, 1.1, (P, B, C)).astype(np.float32)
    x[:, :16, 0] = np.arange(16) / 16       # exact thresholds must fire
    x[:, 16, :] = -0.5                        # below the range
    x[:, 17, :] = 1.0                         # at vref
    x[:, 18, :] = 7.0                         # far above vref
    masks = rng.uniform(size=(P, C, 16)) < rng.uniform(0.1, 1.0, (P, 1, 1))
    masks[0] = True                           # full bank
    masks[1, :, 1:] = False                   # all pruned: level 0 only
    masks[2, 3, 1:] = False                   # one all-pruned channel
    w = rng.normal(0, 0.3, (P, C, F)).astype(np.float32)
    b = rng.normal(0, 0.1, (P, F)).astype(np.float32)
    g = rng.normal(size=(P, B, F)).astype(np.float32)
    dev = torch.device("cuda")
    thr, ids = make_tables(torch.from_numpy(masks).to(dev), N_BITS)
    as_dev = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return as_dev(x), thr, ids, as_dev(w), as_dev(b), as_dev(g)


def bound_ms(B: int, backward: bool) -> tuple[float, str]:
    """Least time of one call at (P, B): bytes over HBM rate vs fp32 ops over peak."""
    reads = P * B * C * 4 + 2 * P * C * T * 4 + P * C * F * 4
    bank_ops = P * B * C * (2 * T + 3)  # compare + select per threshold, dequant
    if backward:
        reads += P * B * F * 4                       # g
        writes = P * B * C * 4 + P * C * F * 4       # dx, dw
        ops = bank_ops + 2 * (2 * P * B * C * F)     # dx and dw products
    else:
        reads += P * F * 4                           # bias
        writes = P * B * F * 4
        ops = bank_ops + 2 * P * B * C * F
    t_bytes = (reads + writes) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(torch):
    from repro_torch.kernels.fused_qat import ops, ref

    out = {}
    for B in (128, 638):
        x, thr, ids, w, b, g = kernel_inputs(torch, B, seed=B)
        before = dict(ops.LAUNCHES)
        y = ops.fused_forward(x, thr, ids, w, b, SCALE)
        dx, dw = ops.fused_backward(x, thr, ids, w, g, SCALE)
        torch.cuda.synchronize()
        if {k: ops.LAUNCHES[k] - before[k] for k in before} != {
                "fused_qat_forward": 1, "fused_qat_backward": 1}:
            raise SystemExit(f"launch counters did not count one launch each: {ops.LAUNCHES}")
        y_ref = ref.fused_forward_tables(x, thr, ids, w, b, SCALE)
        dx_ref, dw_ref = ref.fused_backward_tables(x, thr, ids, w, g, SCALE)
        # forward and dx: 21- and 5-term fp32 sums, the reference's 1-ulp bound
        fwd_ok = torch.allclose(y, y_ref, rtol=1e-6, atol=1e-6)
        dx_ok = torch.allclose(dx, dx_ref, rtol=1e-6, atol=1e-6)
        # dw: B-term fp32 sums in two orders; bound each by the classic
        # recursive-summation error B * eps * sum|h g|, eps = 2^-23
        h = ref.dequant_ste_tables(x, thr, ids, SCALE)
        dw_tol = B * 2.0 ** -23 * torch.matmul(h.abs().transpose(1, 2), g.abs())
        dw_err = (dw - dw_ref).abs()
        dw_ok = bool((dw_err <= dw_tol).all())
        rec = {
            "B": B,
            "forward_max_abs_err": float((y - y_ref).abs().max()),
            "dx_max_abs_err": float((dx - dx_ref).abs().max()),
            "dw_max_abs_err": float(dw_err.max()),
            "dw_max_err_over_bound": float((dw_err / dw_tol.clamp(min=1e-30)).max()),
            "forward_ms": device_ms(torch, lambda: ops.fused_forward(x, thr, ids, w, b, SCALE)),
            "forward_plain_ms": device_ms(
                torch, lambda: ref.fused_forward_tables(x, thr, ids, w, b, SCALE)),
            "backward_ms": device_ms(
                torch, lambda: ops.fused_backward(x, thr, ids, w, g, SCALE)),
            "backward_plain_ms": device_ms(
                torch, lambda: ref.fused_backward_tables(x, thr, ids, w, g, SCALE)),
            "forward_bound_ms": bound_ms(B, False)[0],
            "backward_bound_ms": bound_ms(B, True)[0],
        }
        emit("kernels", **rec, ok=bool(fwd_ok and dx_ok and dw_ok))
        if not (fwd_ok and dx_ok and dw_ok):
            raise SystemExit(f"kernel disagrees with its plain version at B={B}: {rec}")
        out[B] = rec
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


def phase_placement(torch):
    from repro_torch.core import qat, trainer

    (X_tr, y_tr, X_te, y_te), sizes = _cardio()
    mcfg, ecfg = qat.MLPConfig(sizes), trainer.EvalConfig(max_steps=600)
    run = trainer.make_row_program(X_tr, y_tr, X_te, y_te, mcfg, ecfg, device="cuda")
    rows, seeds = _cardio_rows(P, seed=7)
    params0, idx = trainer.draw_rows(seeds, ecfg, mcfg, X_tr.shape[0])
    t0 = time.perf_counter()
    acc, params = run(*rows, params0, idx)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    acc2, params2 = run(*rows, params0, idx)
    same_run = bool(torch.equal(acc, acc2)) and all(
        torch.equal(params[k], params2[k]) for k in params)
    alone_ok = True
    for p in (0, P // 2, P - 1):
        sl = slice(p, p + 1)
        a1, p1 = run(*(r[sl] for r in rows), {k: v[sl] for k, v in params0.items()}, idx[sl])
        alone_ok &= bool(torch.equal(a1[0], acc[p])) and all(
            torch.equal(p1[k][0], params[k][p]) for k in p1)
    emit("placement", rows=P, steps=600, batch_of_24_s=batch_s,
         alone_equals_batch=alone_ok, run_to_run_equal=same_run,
         ok=alone_ok and same_run)
    if not (alone_ok and same_run):
        raise SystemExit("a row's result depends on its batch or on the run")


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
    res = codesign.run_codesign(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    # evaluator calls: the seed population, each generation that trained
    # rows, and the 4-seed conventional baseline
    calls = 1 + sum(1 for r in res.history if r["n_evals"] > 0) + 1
    want = {"fused_qat_forward": calls * (cfg.max_steps + 1),
            "fused_qat_backward": calls * cfg.max_steps}
    gen_s = [r["gen_s"] for r in res.history]
    step_s = [r["eval_s"] / cfg.max_steps for r in res.history if r["n_evals"] > 0]
    checks = {
        "front_nonempty": res.front_acc.size >= 1,
        "acc_finite_in_range": bool(np.isfinite(res.front_acc).all()
                                    and ((res.front_acc >= 0) & (res.front_acc <= 1)).all()),
        "level0_kept": bool(res.front_masks[:, :, 0].all()),
        "pruned_on_front": bool(res.front_area.min() < res.conv_area),
        "baseline_learns": res.conv_acc > 0.70,
        "launch_counts": launches == want,
    }
    emit("slice", dataset="cardio", pop_size=cfg.pop_size, max_steps=cfg.max_steps,
         n_generations=cfg.n_generations, front_size=int(res.front_acc.size),
         front_acc=res.front_acc.tolist(), conv_acc=res.conv_acc,
         area_gain_at_5pct=codesign.gains_at_budget(res, 0.05)["area_gain"],
         n_evaluations=res.n_evaluations, n_memo_hits=res.n_memo_hits,
         evaluator_calls=calls, launches=launches, expected_launches=want,
         seconds_per_generation=gen_s, seconds_per_step=step_s, wall_s=wall,
         checks=checks, ok=all(checks.values()))
    if not all(checks.values()):
        raise SystemExit(f"slice checks failed: {checks}")
    return launches


def phase_profile(torch):
    """Device time by kernel over 20 training steps of 24 cardio rows."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import qat, trainer

    (X_tr, y_tr, X_te, y_te), sizes = _cardio()
    mcfg, ecfg = qat.MLPConfig(sizes), trainer.EvalConfig(max_steps=20)
    run = trainer.make_row_program(X_tr, y_tr, X_te, y_te, mcfg, ecfg, device="cuda")
    rows, seeds = _cardio_rows(P, seed=5)
    params0, idx = trainer.draw_rows(seeds, ecfg, mcfg, X_tr.shape[0])
    run(*rows, params0, idx)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(*rows, params0, idx)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    OUT.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(OUT / "profile_20_steps.json"))
    kernels: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(e.name[:80], [0, 0.0])
            k[0] += 1
            k[1] += e.time_range.elapsed_us()
    device_us = sum(v[1] for v in kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:15]
    emit("profile", steps=20, rows=P, wall_s=wall, device_busy_us=device_us,
         device_idle_share=1.0 - device_us / (wall * 1e6), kernel_launches=sum(
             v[0] for v in kernels.values()),
         top=[{"name": n, "launches": c, "device_us": us} for n, (c, us) in top])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import resolve_device
    from repro_torch.kernels.fused_qat import ops

    resolve_device("cuda")  # fp32 matmuls: TF32 off
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    emit("device", kind=name, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    so = ops.build()
    emit("build", seconds=time.perf_counter() - t0, library=str(so.relative_to(ROOT)))

    kern = phase_kernels(torch)
    phase_placement(torch)
    phase_parity(torch)
    launches = phase_slice(torch)
    if "--profile" in sys.argv[1:]:
        phase_profile(torch)

    train = kern[128]
    rows = []
    for key, kname, line in (("forward", "fused_qat_forward", 76),
                             ("backward", "fused_qat_backward", 84)):
        bms, by = bound_ms(128, key == "backward")
        rows.append({
            "name": kname,
            "route": "cuda",
            "source": "src/repro_torch/kernels/fused_qat/csrc/fused_qat.cu",
            "replaces": f"src/repro/kernels/fused_qat/fused_qat.py:{line}",
            "launches": launches[kname],
            "max_abs_err": max(
                kern[B][e] for B in kern
                for e in (("forward_max_abs_err",) if key == "forward"
                          else ("dx_max_abs_err", "dw_max_abs_err"))),
            "ms": train[f"{key}_ms"],
            "plain_ms": train[f"{key}_plain_ms"],
            "bound_ms": bms,
            "bound_by": by,
            "library_ms": None,
        })
    if not all(math.isfinite(r["ms"]) and r["launches"] > 0 for r in rows):
        raise SystemExit(f"a kernel has no time or was not launched on the main path: {rows}")
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
