"""Run cells of the benchmark one process after another and summarise them.

    python3 cardbench/tools/runs.py --out chiprun_out/runs \
        cardio-search:101:30:0 cardio-search:102:30:1 ...

Each argument is ``cell:seed:seconds:trace``.  Every run's standard output
and error go to ``<out>/<cell>.<seed>.<trace>.{out,err}``; one summary line
a run (wall time, exit code, the result line's metrics and checks) is
printed and appended to ``<out>/summary.jsonl``.  The card's name and
power limit come first.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--timeout", type=float, default=1200)
    ap.add_argument("runs", nargs="+")
    args = ap.parse_args(argv)
    out = ROOT / args.out
    out.mkdir(parents=True, exist_ok=True)
    print(json.dumps({"card": card()}), flush=True)
    worst = 0
    for spec in args.runs:
        cell, seed, seconds, trace = spec.split(":")
        stem = out / f"{cell}.{seed}.{trace}"
        cmd = [sys.executable, "cardbench/run.py", "--workload", cell, "--seed", seed,
               "--seconds", seconds, "--trace", trace]
        t0 = time.time()
        with open(f"{stem}.out", "w") as fo, open(f"{stem}.err", "w") as fe:
            try:
                rc = subprocess.run(cmd, cwd=ROOT, stdout=fo, stderr=fe,
                                    timeout=args.timeout).returncode
            except subprocess.TimeoutExpired:
                rc = 124
        wall = time.time() - t0
        lines = Path(f"{stem}.out").read_text().strip().splitlines()
        try:
            res = json.loads(lines[-1])
        except (IndexError, json.JSONDecodeError):
            res = None
        row = {"run": spec, "rc": rc, "wall_s": round(wall, 2)}
        if res is not None:
            row.update(correct=res["correct"], attempted=res["attempted"], failed=res["failed"],
                       metrics={k: v["value"] for k, v in res["metrics"].items()},
                       checks={k: v["value"] for k, v in res["checks"].items()},
                       peak_gb=res["device"]["memory_peak_bytes"] / 1e9)
            if "busy_s" in res["device"]:
                row.update(busy_s=res["device"]["busy_s"], window_s=res["device"]["window_s"],
                           breakdown=res.get("breakdown"))
        else:
            row["err_tail"] = Path(f"{stem}.err").read_text()[-3000:]
        worst = max(worst, rc)
        print(json.dumps(row), flush=True)
        with open(out / "summary.jsonl", "a") as f:
            f.write(json.dumps(row) + "\n")
    return worst


if __name__ == "__main__":
    sys.exit(main())
