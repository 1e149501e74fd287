"""The dsv3-long-ttft cell's checks on the card, beyond its runs.

    python3 cardbench/tools/dsv3_checks.py readings --out chiprun_out/dsv3 \
        --seeds 3400000001,3400000002 --seconds 15 --control-seeds 1
    python3 cardbench/tools/dsv3_checks.py decode --out chiprun_out/dsv3 --seed 7 \
        --prompt 300 --steps 6

``readings``: for each seed, in one process, the cell's set-up, a window of
``--seconds``, then the number the check compares (``logit_err``) for the
program and, on the first ``--control-seeds`` seeds, for the fp8 control
(the reference with e4m3 inputs in the program's place), each judged by
the cell's limit, with every checked position's gap, the check's own time
and each request's time by length; one JSON line a seed.  ``decode``: at
the published widths, a prefill of ``--prompt`` tokens, then ``--steps``
decode steps through the latent cache (the absorbed form), each step's
logits against the reference's full forward at that position, over the
RMS of the reference's logits.
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

CELL = "dsv3-long-ttft"


def _setup(seed: int, seconds: float):
    import torch

    run = harness.Run(CELL, seed, seconds, False)
    run.torch = torch
    run.trace = Trace(torch, False, 0.0)
    driver = harness.load_module("drivers", run.traffic["driver"])
    return run, driver, driver.setup(run)


def _emit(out_dir: Path, name: str, row: dict) -> None:
    print(json.dumps(row), flush=True)
    with open(out_dir / name, "a") as f:
        f.write(json.dumps(row) + "\n")


def readings(args, out_dir: Path) -> None:
    import torch

    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        torch.cuda.reset_peak_memory_stats()
        run, driver, state = _setup(seed, args.seconds)
        driver.window(run, state)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reqs = driver.sample(run, run.records["requests"])
        control = n < args.control_seeds
        t_check = time.time()
        got = driver.compare(run, state, reqs, "fp8" if control else "fp32")
        row = {"cell": CELL, "seed": seed, "attempted": run.records["attempted"],
               "failed": run.records["failed"], "checked": [r["n_text"] for r in reqs],
               "check_s": time.time() - t_check, "gaps": got["logit_err"],
               "peak_bytes": torch.cuda.max_memory_allocated()}
        ok, compared = harness.judge(run, driver.numbers(got))
        row.update(program_logit_err=compared["logit_err"]["value"], program_correct=ok)
        if control:
            ok, compared = harness.judge(run, driver.control_numbers(got))
            row.update(control_logit_err=compared["logit_err"]["value"], control_correct=ok,
                       control_gaps=got["control_logit_err"])
        by_len: dict = {}
        for r in run.records["requests"]:
            by_len.setdefault(r["n_text"], []).append(round(1e3 * r["ttft"], 2))
        row["ttft_ms"] = dict(sorted(by_len.items()))
        row["wall_s"] = time.time() - t0
        _emit(out_dir, "readings.jsonl", row)
        del state, run
        gc.collect()
        torch.cuda.empty_cache()


def decode(args, out_dir: Path) -> None:
    import torch

    from cardbench.reference import deepseek_v3
    from repro_torch.models import init_cache

    run, driver, state = _setup(args.seed, 0.0)
    model, V = state.model, run.config["vocab_size"]
    S = args.prompt
    tokens = driver.request_tokens(run, 1 << 41, S + args.steps)
    pos = list(range(S - 1, S + args.steps - 1))
    with torch.inference_mode():
        logits, pre = model.prefill(state.weights, tokens[None, :S])
        served = [logits[0, -1, :V].float()]
        del logits
        cache = init_cache(model, 1, S + args.steps, run.device)
        assert set(cache) == {"c_kv", "k_pe"}, "the latent is the only attention state"
        cache["c_kv"][:, :, :S], cache["k_pe"][:, :, :S] = pre["c_kv"], pre["k_pe"]
        del pre
        kv_len = torch.full((1,), S, dtype=torch.int32, device=run.device)
        for j in range(args.steps - 1):
            step, cache = model.decode_step(state.weights, tokens[S + j][None], cache, kv_len)
            served.append(step[0, :V].float())
            kv_len += 1
        want = deepseek_v3.logits_at(state.weights, driver.sizes(run.config), [tokens],
                                     [pos])[0][:, :V]
    errs = [float((g - w).abs().max() / w.square().mean().sqrt()) for g, w in zip(served, want)]
    _emit(out_dir, "decode.jsonl", {"seed": args.seed, "prompt": S, "positions": pos,
                                    "logit_err": errs, "cache": sorted(cache),
                                    "limit": run.cell["limits"]["logit_err"]})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=("readings", "decode"))
    ap.add_argument("--out", default="chiprun_out/dsv3")
    ap.add_argument("--seeds", default="3400000001")
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--prompt", type=int, default=300)
    ap.add_argument("--steps", type=int, default=6)
    args = ap.parse_args(argv)
    out_dir = Path(args.out) if Path(args.out).is_absolute() else ROOT / args.out
    out_dir.mkdir(parents=True, exist_ok=True)
    {"readings": readings, "decode": decode}[args.what](args, out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
