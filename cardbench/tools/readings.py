"""Readings of the output check on the card: the program's and the control's.

    python3 cardbench/tools/readings.py --out chiprun_out/readings \
        --cell internvl2-image-ttft --seeds 201,202,203 --seconds 15 --control-seeds 3

For each seed, in one process: the cell's set-up, a window of ``--seconds``
at the cell's own load, then the numbers the check compares for the program
and, on the first ``--control-seeds`` seeds, the same numbers for the
control: the plain reference computed one precision below the
configuration's (fp32 -> TF32 inputs for the printed MLP's QAT, bf16 -> fp8
e4m3 for the language model), put in the program's place.  Both go through
the harness's own limits (``harness.judge``), which give each its
``correct``.  One JSON line a seed goes to standard output and to
``<out>/<cell>.jsonl``.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from cardbench import harness  # noqa: E402
from cardbench.tracing import Trace  # noqa: E402


def judged(run, prefix: str, checks) -> dict:
    correct, compared = harness.judge(run, checks)
    out = {f"{prefix}_{k}": v["value"] for k, v in compared.items()}
    out[f"{prefix}_correct"] = correct
    return out


def search_readings(run, driver, state, control: bool) -> dict:
    import numpy as np

    out = judged(run, "program", driver.check(run, state))
    rec = run.records
    plain = driver.no_ternary(rec["checked_rows"])
    accs = {"program": rec["acc_program"]}
    if control:
        out.update(judged(run, "control", driver.control_numbers(run, state)))
        accs["control"] = rec["acc_control"]
    out.update(rows=int(plain.size), rows_no_ternary=int(plain.sum()))
    for who, acc in accs.items():
        miss = driver.mismatched(acc, rec["acc_ref"], rec["n_test"])
        gap = np.abs(np.asarray(acc, np.float64) - rec["acc_ref"])
        # not compared: the share over all rows and over the ternary rows alone
        out[f"{who}_share_all"] = float(miss.mean())
        out[f"{who}_share_ternary"] = float(miss[~plain].mean()) if (~plain).any() else None
        out[f"{who}_acc_gap_max"] = float(gap.max())
        out[f"{who}_acc_gap_mean"] = float(gap.mean())
    return out


def lm_readings(run, driver, state, control: bool) -> dict:
    precision = "fp8" if control else "fp32"
    if run.traffic["driver"] == "prefill":
        got = driver.compare(run, state, driver.sample(run, run.records["requests"]),
                             precision)
        extra = {"longest": max(r["n_text"] for r in run.records["requests"])}
    else:
        rows = driver.sample_rows(run, driver.kept_rows(state))
        got = driver.compare(run, state, driver.sample(run, state), rows, precision)
        extra = {"tokens_checked": len(got["token_gap"]), "rows_checked": len(rows)}
    out = judged(run, "program", driver.numbers(got))
    if control:
        out.update(judged(run, "control", driver.control_numbers(got)))
    # not compared: each list's largest, beside the compared ones
    out.update({f"max_{k}": max(v) for k, v in got.items() if v})
    out.update(extra)
    return out


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control-seeds", type=int, default=3,
                    help="the control is read on this many of the first seeds")
    args = ap.parse_args(argv)
    out_dir = ROOT / args.out
    out_dir.mkdir(parents=True, exist_ok=True)
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        run = harness.Run(args.cell, seed, args.seconds, False)
        run.torch = torch
        run.trace = Trace(torch, False, 0.0)
        driver = harness.load_module("drivers", run.traffic["driver"])
        state = driver.setup(run)
        driver.window(run, state)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        row = {"cell": args.cell, "seed": seed, "attempted": run.records.get("attempted"),
               "failed": run.records.get("failed")}
        control = n < args.control_seeds
        read = search_readings if run.traffic["driver"] == "search" else lm_readings
        row.update(read(run, driver, state, control))
        row["wall_s"] = time.time() - t0
        print(json.dumps(row), flush=True)
        with open(out_dir / f"{args.cell}.jsonl", "a") as f:
            f.write(json.dumps(row) + "\n")
        del state, run
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
