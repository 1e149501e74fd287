"""Where a row's training parts from the fp32 reference's, read on the card.

    python3 cardbench/tools/divergence.py --out chiprun_out/divergence \
        --cell cardio-search --seed 501 --seconds 1

A window of ``--seconds`` of the cell (the harness's own driver and output
check), then every row of its first search trained again, step by step and
from the same inputs, on both sides:

* the program's trainer, its eager step ``trainer._train_block`` (the step
  its CUDA graphs capture) run as blocks of one step, the parameters kept
  after each;
* the plain fp32 reference, ``reference/printed_mlp.train_rows``.

After each step it compares the two sides' parameters and what the next
step's forward makes discrete from them, each side's worked out by the
reference's rules: every weight's quantized value (its po2 code, or its
ternary sign and liveness) and every hidden unit's state on that step's
batch (the sign of its pre-activation, its comparator gate, the clip's
upper rail, its ``act_bits`` level).  Per row it records the first step's gradient gap
and the hidden units whose states the two sides' first layers set
differently (both start from the same parameters: the program's K2
against the reference's sums), the first step at which a
discrete quantity differs and which, and the first step at which the
parameters part by more than ``--part`` of their scale; beside them whether
the row is one the check finds mismatched and whether the step-by-step
replay gives the window's accuracy.  One JSON line a row goes to
``<out>/<cell>.<seed>.jsonl``; a summary by group (mismatched or not,
ternary or not) to standard output.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402

from cardbench import harness  # noqa: E402
from cardbench.reference import printed_mlp as ref  # noqa: E402
from cardbench.tracing import Trace  # noqa: E402


def weight_codes(torch, w, bits):
    """Each weight's quantized value as an integer: sign x (exponent step) for
    po2 at ``bits`` (0 where flushed to zero), sign x liveness for ternary."""
    P = w.shape[0]
    b = bits.view(-1, 1, 1)
    e_lo = -torch.exp2(b.clamp(min=1.0) - 1.0) + 1.0
    mag = w.abs()
    e = torch.clamp(torch.maximum(torch.round(torch.log2(mag.clamp(min=1e-12))), e_lo), max=0.0)
    po2 = torch.where(mag < torch.exp2(e_lo - 1.0), torch.zeros_like(e),
                      torch.sign(w) * (e - e_lo + 1.0))
    live = mag > (0.7 * mag.reshape(P, -1).mean(1)).view(-1, 1, 1)
    tern = torch.where(live, torch.sign(w), torch.zeros_like(w))
    return torch.where(b > 0, po2, tern).to(torch.int32)


def pre_activations(torch, params, x, rows, n_bits):
    """The hidden layer's pre-activations on the batch ``x`` (P, B, C) under
    ``params``, by the reference's arithmetic."""
    bits0 = rows["wprec"][:, 0] if "wprec" in rows else rows["weight_bits"]
    h = ref.matmul(ref._adc(x, rows["masks"], n_bits), ref._weights(params["w0"], bits0))
    return h + params["b0"][:, None]


KINDS = ("sign", "gate", "rail", "level")


def states(torch, h, rows):
    """(sign, gate, upper rail, level) of every hidden unit of pre-activations
    ``h``: the sign is three-valued, as the ReLU's and the clip's gradients
    at 0 are (a tie at 0 splits the clip's); the gate is the comparator's
    (the step activation), else the sign's; the rail is three-valued about
    where the activation reaches 1 (the clip's upper kink)."""
    sel = (rows["act_sel"][:, 0] if "act_sel" in rows
           else torch.zeros(h.shape[0], dtype=torch.int64, device=h.device))
    s3 = sel.view(-1, 1, 1)
    gate = torch.where(s3 == 3, h > 0.5, h > 0)
    rail = torch.sign(h - torch.where(s3 == 2, 1.5, 1.0))
    scale = torch.exp2(rows["act_bits"]).view(-1, 1, 1) - 1.0
    level = torch.round(ref._clip01(ref._act(h, sel)) * scale)
    return torch.sign(h), gate, rail, level


def first_states(torch, qat, params, x, rows, n_bits):
    """Per row: the hidden units whose states (``KINDS``) the program's and
    the reference's first layer set differently, and the widest gap of
    their pre-activations: the same parameters and batch, each side's own
    arithmetic (the program's K2 behind ``qat.fused_qat_first_layer``)."""
    w0 = params["w0"]
    if "wprec" in rows:
        q = qat.quantize_layer_weights(w0, rows["wprec"][:, 0])
    else:
        q = qat.quantize_pow2(w0, rows["weight_bits"].view(-1, 1, 1))
    mine = qat.fused_qat_first_layer(x, rows["masks"], q, params["b0"], n_bits)
    theirs = pre_activations(torch, params, x, rows, n_bits)
    flips = [(a != b).flatten(1).sum(1)
             for a, b in zip(states(torch, mine, rows), states(torch, theirs, rows))]
    return flips, (mine - theirs).abs().flatten(1).amax(1)


def rel_gap(torch, a: dict, b: dict):
    """Per row: the largest over the leaves of max |a - b| over the larger of
    that leaf's max |b| and the median leaf's (a leaf near nought, as a bias
    is at the start, would read its rounding as a gap of its own size)."""
    scale = torch.stack([b[k].abs().flatten(1).amax(1) for k in b])
    floor = scale.median(0).values
    gaps = [(a[k] - b[k]).abs().flatten(1).amax(1) / torch.maximum(s, floor).clamp(min=1e-30)
            for k, s in zip(b, scale)]
    return torch.stack(gaps).amax(0)


def search_rows(run, driver, state, d: int):
    """The rows the window's search ``d`` trained, their accuracies in the
    window, its seed and which rows the check found mismatched."""
    rows, acc_prog, seeds = driver.trained_rows(state, driver._axes(run))
    pick = np.asarray(rows["data"]) == d
    rows = {k: np.asarray(v)[pick] for k, v in rows.items()}
    rec = run.records
    miss = driver.mismatched(rec["acc_program"], rec["acc_ref"], rec["n_test"])[pick]
    return rows, acc_prog[pick], seeds[d], miss


def diverge(run, driver, state, d: int, part: float) -> list[dict]:
    import torch

    from repro_torch.core import qat, trainer

    dev = torch.device(run.device)
    c = run.config
    rows, acc_window, seed, miss = search_rows(run, driver, state, d)
    P = len(rows["seeds"])
    X_tr, y_tr, X_te, y_te = (a[0] for a in driver.problem(run, [seed]))
    budget = run.records["budget"]
    steps = budget["max_steps"]
    draws = [ref.draw_row(seed, s, c["layer_sizes"], X_tr.shape[0], steps, c["max_batch"])
             for s in rows["seeds"]]
    params0 = {k: torch.stack([p[k] for p, _ in draws]) for k in draws[0][0]}
    idx = torch.stack([i for _, i in draws])
    axes = driver._axes(run)
    extra = [rows[driver.EXTRA_NAMES[a]] for a in axes if a in driver.EXTRA_NAMES]

    # the program, a block a step, keeping every step's parameters
    snaps, vel0 = [], {}
    orig = trainer._train_block

    def stepped(X, y, mlp_cfg, momentum, s, n_steps):
        orig(X, y, mlp_cfg, momentum, s, n_steps)
        snaps.append({k: v.detach()[:P].clone() for k, v in s.params.items()})
        if not vel0:
            vel0.update({k: v[:P].clone() for k, v in s.vel.items()})

    mlp_cfg = qat.MLPConfig(layer_sizes=tuple(c["layer_sizes"]), adc_bits=c["adc_bits"])
    cfg = trainer.EvalConfig(max_steps=steps, step_scale=budget["step_scale"], seed=seed,
                             genome_axes=axes, block_steps=1)
    prog = trainer._Program(X_tr, y_tr, X_te, y_te, mlp_cfg, cfg, dev, graph=False)
    trainer._train_block = stepped
    try:
        acc_replay, _, _ = prog.launch(rows["masks"], rows["weight_bits"], rows["act_bits"],
                                       rows["batch_size"], rows["epochs"], rows["lr"], params0,
                                       idx, extra)
    finally:
        trainer._train_block = orig
    acc_replay = acc_replay[:P].cpu().numpy()

    # the reference, step by step, against the kept steps
    t_rows = {k: torch.as_tensor(v).to(dev) for k, v in rows.items() if k != "seeds"}
    t_rows["masks"] = t_rows["masks"].to(torch.bool)
    t_rows["data"] = torch.zeros(P, dtype=torch.int64, device=dev)
    as_t = lambda a, dt: torch.as_tensor(a[None], dtype=dt, device=dev)  # noqa: E731
    Xd, yd = as_t(X_tr, torch.float32), as_t(y_tr, torch.int64)
    idx_d = idx.to(dev)
    first = {k: np.full(P, -1) for k in ("code", *KINDS, "part")}
    gap_at_part = np.full(P, np.nan)
    gap_at_flip = np.full(P, np.nan)  # the parameters' gap that the first flip came from
    g0 = np.zeros(P)
    with torch.no_grad():
        p0 = {k: v.to(dev) for k, v in params0.items()}
        flips0, pre0 = first_states(torch, qat, p0, Xd[0][idx_d[:, 0]], t_rows, c["adc_bits"])
        flips0 = [f.cpu().numpy() for f in flips0]
        pre0 = pre0.cpu().numpy()
    prev_gap = torch.zeros(P, device=dev)

    def note(kind, t, hit, gap=None):
        hit = hit.cpu().numpy() & (first[kind] < 0)
        first[kind][hit] = t
        if gap is not None:
            new = hit & np.isnan(gap_at_flip)
            gap_at_flip[new] = gap.cpu().numpy()[new]

    def on_step(t, params, vel):
        nonlocal prev_gap
        with torch.no_grad():
            mine = snaps[t]
            if t == 0:  # both sides started from params0: the first gradients' gap
                g0[:] = rel_gap(torch, vel0, vel).cpu().numpy()
            ref_p = {k: v.detach() for k, v in params.items()}
            gap = rel_gap(torch, mine, ref_p)
            newly = (gap > part).cpu().numpy() & (first["part"] < 0)
            gap_at_part[newly] = prev_gap.cpu().numpy()[newly]
            note("part", t, gap > part)
            prev_gap = gap
            if t + 1 >= steps:
                return
            nb = len(c["layer_sizes"]) - 1
            code_diff = torch.zeros(P, dtype=torch.bool, device=dev)
            for i in range(nb):
                bits = t_rows["wprec"][:, i] if "wprec" in t_rows else t_rows["weight_bits"]
                code_diff |= (weight_codes(torch, mine[f"w{i}"], bits)
                              != weight_codes(torch, ref_p[f"w{i}"], bits)).flatten(1).any(1)
            note("code", t + 1, code_diff, gap)
            x = Xd[0][idx_d[:, t + 1]]
            a = states(torch, pre_activations(torch, mine, x, t_rows, c["adc_bits"]), t_rows)
            b = states(torch, pre_activations(torch, ref_p, x, t_rows, c["adc_bits"]), t_rows)
            for kind, u, v in zip(KINDS, a, b):
                note(kind, t + 1, (u != v).flatten(1).any(1), gap)

    acc_ref = ref.train_rows(Xd, yd, as_t(X_te, torch.float32), as_t(y_te, torch.int64),
                             t_rows, {k: v.to(dev) for k, v in params0.items()}, idx_d,
                             c["adc_bits"],
                             steps, budget["step_scale"], on_step=on_step).cpu().numpy()
    ternary = ~driver.no_ternary(rows)
    out = []
    for j in range(P):
        kinds = {k: int(first[k][j]) for k in ("code", *KINDS) if first[k][j] >= 0}
        flip = min(kinds.values()) if kinds else None
        out.append({
            "row": j, "mismatched": bool(miss[j]), "ternary": bool(ternary[j]),
            "acc_window": float(acc_window[j]), "acc_replay": float(acc_replay[j]),
            "acc_ref": float(acc_ref[j]), "first_grad_gap": float(g0[j]),
            "first_state_flips": {k: int(f[j]) for k, f in zip(KINDS, flips0)},
            "first_pre_gap": float(pre0[j]),
            "first_flip": flip, "flip_kinds": sorted(k for k, v in kinds.items() if v == flip),
            "part_step": int(first["part"][j]) if first["part"][j] >= 0 else None,
            "gap_before_part": None if np.isnan(gap_at_part[j]) else float(gap_at_part[j]),
            "gap_at_flip": None if np.isnan(gap_at_flip[j]) else float(gap_at_flip[j]),
        })
    return out


def summary(rows: list[dict]) -> dict:
    out = {}
    for mis in (True, False):
        for tern in (True, False):
            g = [r for r in rows if r["mismatched"] == mis and r["ternary"] == tern]
            if not g:
                continue
            part = [r["part_step"] for r in g if r["part_step"] is not None]
            flip = [r for r in g if r["first_flip"] is not None]
            kinds: dict = {}
            for r in flip:
                for k in r["flip_kinds"]:
                    kinds[k] = kinds.get(k, 0) + 1
            before = [r for r in flip if r["part_step"] is not None
                      and r["first_flip"] <= r["part_step"] + 1]
            gb = [r["gap_before_part"] for r in g if r["gap_before_part"] is not None]
            out[f"{'mismatched' if mis else 'matched'}.{'ternary' if tern else 'po2'}"] = {
                "rows": len(g),
                "replay_equals_window": sum(r["acc_replay"] == r["acc_window"] for r in g),
                "parted": len(part),
                "part_step_quartiles": (np.percentile(part, [0, 25, 50, 75, 100]).tolist()
                                        if part else None),
                "flipped": len(flip),
                "flip_step_quartiles": (np.percentile([r["first_flip"] for r in flip],
                                                      [0, 25, 50, 75, 100]).tolist()
                                        if flip else None),
                "first_flip_kinds": kinds,
                "flip_by_part": len(before),
                "gap_before_part_max": max(gb) if gb else None,
                "gap_at_flip_quartiles": (np.percentile(
                    [r["gap_at_flip"] for r in flip], [0, 25, 50, 75, 100]).tolist()
                    if flip else None),
                "first_state_flips": {k: sum(r["first_state_flips"][k] > 0 for r in g)
                                      for k in KINDS},
                "first_pre_gap_max": max(r["first_pre_gap"] for r in g),
                "first_grad_gap_quartiles": np.percentile(
                    [r["first_grad_gap"] for r in g], [0, 25, 50, 75, 100]).tolist(),
            }
    return out


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--part", type=float, default=1e-4,
                    help="a row has parted once its parameters differ by this share")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    t0 = time.time()
    run = harness.Run(args.cell, args.seed, args.seconds, False, device=args.device)
    run.torch = torch
    run.trace = Trace(torch, False, 0.0)
    driver = harness.load_module("drivers", run.traffic["driver"])
    state = driver.setup(run)
    driver.window(run, state)
    correct, compared = harness.judge(run, driver.check(run, state))
    rows = diverge(run, driver, state, 0, args.part)
    out_dir = ROOT / args.out
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / f"{args.cell}.{args.seed}.jsonl", "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    print(json.dumps({"cell": args.cell, "seed": args.seed, "correct": correct,
                      "checks": {k: v["value"] for k, v in compared.items()},
                      "summary": summary(rows), "wall_s": time.time() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
