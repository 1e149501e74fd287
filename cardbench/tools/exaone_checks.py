"""The kexaone-long-ttft cell's checks on the card, beyond its runs.

    python3 cardbench/tools/exaone_checks.py readings --out chiprun_out/kx \
        --seeds 3100000001,3100000002 --seconds 15 --control-seeds 1
    python3 cardbench/tools/exaone_checks.py decode --out chiprun_out/kx --seed 7 --prompt 300
    python3 cardbench/tools/exaone_checks.py routing --out chiprun_out/kx --seed 7 \
        --requests 0,1,2,3,4,5,6,7
    python3 cardbench/tools/exaone_checks.py k4-bits [--src parent_tree/src]

``readings``: for each seed, in one process, the cell's set-up, a window of
``--seconds``, then the number the check compares (``logit_err``) for the
program and, on the first ``--control-seeds`` seeds, for the fp8 control
(the reference with e4m3 inputs in the program's place), each judged by
the cell's limit, with every checked position's gap; one JSON line a seed.  ``decode``: at the published
widths, a prefill of ``--prompt`` tokens, then ``--steps`` decode steps
through the window layers' rings and the global caches, each step's
logits against the reference's full forward at that position.  ``routing``:
the cause of the check's tail.  For requests ``--requests`` of a seed (their
lengths and tokens as the window sends them), at each of the cell's checked
positions, the logit gap beside the expert layers whose held experts the
program's router picked otherwise than the reference's, and the
reference's margin there (its k-th score less its (k+1)-th); ``decode``
reports the same for its steps.  ``k4-bits``:
a digest of K4's full causal outputs at the served shapes (no window), of
this tree's kernel or ``--src``'s, to compare two trees' kernels bit for bit.
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from cardbench import harness  # noqa: E402
from cardbench.tracing import Trace  # noqa: E402

CELL = "kexaone-long-ttft"


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
        run, driver, state = _setup(seed, args.seconds)
        driver.window(run, state)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reqs = driver.sample(run, run.records["requests"])
        control = n < args.control_seeds
        got = driver.compare(run, state, reqs, "fp8" if control else "fp32")
        row = {"cell": CELL, "seed": seed, "attempted": run.records["attempted"],
               "failed": run.records["failed"], "checked": [r["n_text"] for r in reqs],
               "gaps": got["logit_err"]}
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


def _program_routes(rows, sink: list):
    """Wrap the program's expert layer so that each call appends its router's
    top-k experts at ``rows(n_rows)`` to ``sink``, computed as the layer
    computes them (the same products on the same inputs); returns the original."""
    import torch

    from repro_torch.models import transformer

    layer = transformer._moe_dropless

    def routed(h, lp, cfg):
        x = h.reshape(-1, h.shape[-1])
        s = torch.sigmoid(torch.matmul(x.to(torch.float32), lp["router"].to(torch.float32)))
        sink.append(torch.topk(s, cfg.top_k, dim=-1)[1][rows(x.shape[0])].cpu())
        return layer(h, lp, cfg)

    transformer._moe_dropless = routed
    return layer


def _reference_routes(positions: list, sink: list):
    """Wrap the reference's expert layer (one sequence a call) so that each
    call appends (top-k experts, k-th score less the (k+1)-th) at
    ``positions`` to ``sink``; returns the original."""
    import torch

    from cardbench.reference import exaone_moe

    layer = exaone_moe._experts

    def routed(x, lw, cfg, precision):
        s = torch.sigmoid(exaone_moe.matmul(x, lw["router"], precision))
        top = torch.topk(s[positions], cfg["num_experts_per_tok"] + 1, dim=-1)
        sink.append((top.indices[:, :-1].cpu(), (top.values[:, -2] - top.values[:, -1]).cpu()))
        return layer(x, lw, cfg, precision)

    exaone_moe._experts = routed
    return layer


def _swaps(program: list, reference: list, held: int) -> list[dict]:
    """Per position: the expert layers (counted from the first) where the held
    experts picked differ, the reference's smallest margin among them, and
    the layers where any picked expert differs."""
    out = []
    for p in range(len(reference[0][0])):
        layers, margins, any_diff = [], [], 0
        for j, (got, (want, margin)) in enumerate(zip(program, reference)):
            a, b = set(got[p].tolist()), set(want[p].tolist())
            any_diff += a != b
            if {e for e in a if e < held} != {e for e in b if e < held}:
                layers.append(j)
                margins.append(float(margin[p]))
        out.append({"held_swap_layers": layers, "min_margin": min(margins, default=None),
                    "any_swap_layers": any_diff})
    return out


def _split(rows: list[dict]) -> dict:
    """The gaps of the positions with a held swap and of those without."""
    import numpy as np

    out = {}
    for name, keep in (("no_swap", False), ("held_swap", True)):
        g = [r["gap"] for r in rows if bool(r["held_swap_layers"]) == keep]
        out[name] = {"positions": len(g)} | ({
            "min": min(g), "median": float(np.median(g)), "p90": float(np.percentile(g, 90)),
            "max": max(g)} if g else {})
    return out


def routing(args, out_dir: Path) -> None:
    import torch

    from cardbench.reference import exaone_moe
    from repro_torch.models import transformer

    run, driver, state = _setup(args.seed, 0.0)
    V, P, H = run.config["vocab_size"], run.cell["check_positions"], run.config["experts_held"]
    cfg = driver.sizes(run.config)
    rows = []
    for i in (int(r) for r in args.requests.split(",")):
        n = state.lengths[i]
        tokens = driver.request_tokens(run, i, n)
        got, want = [], []
        layer = _program_routes(lambda m: list(range(m - P, m)), got)
        try:
            with torch.inference_mode():
                logits, _ = state.model.prefill(state.weights, tokens[None])
                tail = logits[0, -P:].float()
                del logits
        finally:
            transformer._moe_dropless = layer
        torch.cuda.empty_cache()
        pos = list(range(n - P, n))
        layer = _reference_routes(pos, want)
        try:
            with torch.inference_mode():
                ref = exaone_moe.logits_at(state.weights, cfg, [tokens], [pos])[0]
        finally:
            exaone_moe._experts = layer
        gaps = driver._gaps(tail, ref, V)
        for p, (g, sw) in enumerate(zip(gaps, _swaps(got, want, H))):
            rows.append({"request": i, "n_text": n, "position": pos[p], "gap": g, **sw})
        del tail, ref
        torch.cuda.empty_cache()
    _emit(out_dir, "routing.jsonl", {"seed": args.seed, "positions": rows,
                                     "by_swap": _split(rows),
                                     "limit": run.cell["limits"]["logit_err"]})


def decode(args, out_dir: Path) -> None:
    import torch

    from cardbench.reference import exaone_moe
    from repro_torch.models import init_cache

    from repro_torch.models import transformer

    run, driver, state = _setup(args.seed, 0.0)
    model, V = state.model, run.config["vocab_size"]
    S = args.prompt
    tokens = driver.request_tokens(run, 1 << 41, S + args.steps)
    pos = list(range(S - 1, S + args.steps - 1))
    routes, ref_routes = [], []
    layer = _program_routes(lambda m: [m - 1], routes)  # a prefill's last row; a step's one
    try:
        with torch.inference_mode():
            logits, pre = model.prefill(state.weights, tokens[None, :S])
            served = [logits[0, -1, :V].float()]
            del logits
            cache = init_cache(model, 1, S + args.steps, run.device)
            cache["k"][:, :, :S], cache["v"][:, :, :S] = pre["k"], pre["v"]
            cache["k_win"].copy_(pre["k_win"])
            cache["v_win"].copy_(pre["v_win"])
            del pre
            kv_len = torch.full((1,), S, dtype=torch.int32, device=run.device)
            for j in range(args.steps - 1):
                step, cache = model.decode_step(state.weights, tokens[S + j][None], cache,
                                                kv_len)
                served.append(step[0, :V].float())
                kv_len += 1
    finally:
        transformer._moe_dropless = layer
    layer = _reference_routes(pos, ref_routes)
    try:
        with torch.inference_mode():
            want = exaone_moe.logits_at(state.weights, driver.sizes(run.config), [tokens],
                                        [pos])[0][:, :V]
    finally:
        exaone_moe._experts = layer
    errs = [float((g - w).abs().max() / w.square().mean().sqrt()) for g, w in zip(served, want)]
    # the program's routes a layer: the prefill's, then each step's, one position each
    n_moe = len(ref_routes)
    program = [torch.cat([routes[t * n_moe + j] for t in range(len(pos))]) for j in range(n_moe)]
    swaps = _swaps(program, ref_routes, run.config["experts_held"])
    _emit(out_dir, "decode.jsonl", {"seed": args.seed, "prompt": S, "positions": pos,
                                    "logit_err": errs, "routes": swaps,
                                    "limit": run.cell["limits"]["logit_err"]})


def k4_bits(args, out_dir: Path) -> None:
    import torch

    if args.src:
        sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels.flash_attn import ops

    digest = hashlib.sha256()
    for S, Hq, Hkv in ((4096, 32, 4), (4352, 48, 8), (4096, 64, 8), (1000, 64, 8)):
        g = torch.Generator(device="cuda").manual_seed(S + Hq)
        q = torch.randn(1, S, Hq, 128, generator=g, device="cuda").bfloat16()
        k = torch.randn(1, S, Hkv, 128, generator=g, device="cuda").bfloat16()
        v = torch.randn(1, S, Hkv, 128, generator=g, device="cuda").bfloat16()
        out = ops.flash_attention(q, k, v, True)
        digest.update(out.view(torch.int16).cpu().numpy().tobytes())
    _emit(out_dir, "k4_bits.jsonl", {"src": str(Path(ops.__file__).parents[3]),
                                     "sha256": digest.hexdigest(), "launches": dict(ops.LAUNCHES)})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=("readings", "decode", "routing", "k4-bits"))
    ap.add_argument("--out", default="chiprun_out/kexaone")
    ap.add_argument("--seeds", default="3100000001")
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--prompt", type=int, default=300)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--requests", default="0,1,2,3", help="routing: the window's requests")
    ap.add_argument("--src", default=None, help="k4-bits: the src/ of another tree")
    args = ap.parse_args(argv)
    out_dir = Path(args.out) if Path(args.out).is_absolute() else ROOT / args.out
    out_dir.mkdir(parents=True, exist_ok=True)
    {"readings": readings, "decode": decode, "routing": routing,
     "k4-bits": k4_bits}[args.what](args, out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
