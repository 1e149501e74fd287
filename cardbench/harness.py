"""The benchmark's harness: one cell, one run, one result line.

Everything specific to a cell sits in files the harness finds by name:

* ``cells/<cell>.json``: its configuration, traffic, end-to-end and
  per-layer metrics, the length of its traced part and the limits of its
  output check;
  a cell file whose name starts with ``_`` is parked: it runs by its
  name, but ``BENCHMARK.json`` does not list it;
* ``configs/<config>.json``: the configuration's sizes and source;
* ``traffic/<traffic>.json``: the traffic's parameters and the driver
  that generates it (``drivers/<driver>.py``);
* ``end_to_end/<metric>.json`` and ``metrics/<metric>.py``: a metric's
  unit and direction, and for a per-layer metric the reader that takes
  it from the run's records, spans and device trace.

A driver module has ``setup(run) -> state``, ``window(run, state) ->
{end-to-end metric: value}`` and ``check(run, state) -> [(name, value,
limit)]``.  ``run`` (:class:`Run`) carries the cell, the seed, the
device, the spans, the trace and the records the window leaves.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
import traceback
from pathlib import Path

from cardbench.tracing import Spans, Trace

__all__ = ["BENCH", "load_json", "load_module", "names", "Run", "judge", "run_cell", "main"]

BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(kind: str, name: str, root: Path = BENCH) -> dict:
    path = root / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"no {kind} file named {name!r} ({path} is missing)")
    return json.loads(path.read_text())


def load_module(kind: str, name: str, root: Path = BENCH):
    """``<root>/<kind>/<name>.py`` as a module (a name may hold '.' and '-')."""
    path = root / kind / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"no {kind} module named {name!r} ({path} is missing)")
    mod_name = f"cardbench_{kind}_" + "".join(c if c.isalnum() else "_" for c in name)
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def names(kind: str, suffix: str, root: Path = BENCH) -> list[str]:
    """The names of every ``<kind>/<name><suffix>`` file, sorted."""
    return sorted(p.name[: -len(suffix)] for p in (root / kind).glob(f"*{suffix}")
                  if not p.name.startswith("_"))


class Run:
    """What one run of a cell knows: inputs, device, spans, trace, records."""

    def __init__(self, cell_name: str, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", root: Path = BENCH, overrides: dict | None = None):
        self.root = root
        self.cell_name = cell_name
        self.cell = load_json("cells", cell_name, root)
        self.config = load_json("configs", self.cell["config"], root)
        self.traffic = load_json("traffic", self.cell["traffic"], root)
        for key, value in (overrides or {}).items():
            getattr(self, key).update(value)
        self.seed, self.seconds, self.device = int(seed), float(seconds), device
        self.spans = Spans()
        self.records: dict = {}
        self.torch = None
        self.trace = None
        self.trace_on = trace

    def derived_seed(self, *keys: int) -> int:
        """A 31-bit seed of (--seed, *keys): the same inputs for the same seed."""
        import numpy as np

        seq = np.random.SeedSequence([self.seed % (1 << 64), *keys])
        return int(seq.generate_state(1)[0] & 0x7FFFFFFF)


def _process_start() -> float:
    """This process's start on ``time.time``'s clock (Linux), else now."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        boot = next(float(line.split()[1]) for line in Path("/proc/stat").read_text().splitlines()
                    if line.startswith("btime"))
        return boot + start / ticks
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def _forbidden_modules() -> list[str]:
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def judge(run: Run, checks) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})`` of the numbers ``checks``
    (``[(name, value)]``) against the cell's limits: every number at or
    under its limit, and no failed request.  A number the cell gives no
    limit is refused."""
    limits = run.cell.get("limits", {})
    compared = {}
    correct = run.records.get("failed", 0) == 0
    for name, value in checks:
        limit = limits.get(name)
        if limit is None:
            raise SystemExit(f"cell {run.cell_name} has no limit for the check {name!r}")
        ok = value is not None and value == value and value <= limit
        correct = correct and ok
        compared[name] = {"value": None if value is None else float(value), "limit": limit}
    return correct, compared


def run_cell(run: Run, t_start: float) -> dict:
    """Set up, measure, check: the result object of the run."""
    import torch

    run.torch = torch
    driver = load_module("drivers", run.traffic["driver"], run.root)
    run.trace = Trace(torch, run.trace_on and run.device == "cuda",
                      float(run.cell.get("trace_seconds", run.seconds)))
    if run.device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    state = driver.setup(run)
    if run.device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.time() - t_start
    run.trace.start()
    e2e = driver.window(run, state)
    if run.device == "cuda":
        torch.cuda.synchronize()
    run.trace.stop()
    peak = torch.cuda.max_memory_allocated() if run.device == "cuda" else 0
    bad = _forbidden_modules()
    if bad:
        raise SystemExit(f"modules of JAX or of the JAX package are loaded: {bad}")

    metrics = {}
    if run.trace_on:
        for name in run.cell["per_layer"]:
            reader = load_module("metrics", name, run.root)
            value = reader.read(run)
            if value is not None:
                metrics[name] = {"value": float(value), "unit": reader.UNIT}
    else:
        units = {n: load_json("end_to_end", n, run.root)["unit"]
                 for n in ["setup_s", *run.cell["end_to_end"]]}
        e2e = dict(e2e, setup_s=setup_s)
        for name in ["setup_s", *run.cell["end_to_end"]]:
            metrics[name] = {"value": float(e2e[name]), "unit": units[name]}

    correct, compared = judge(run, driver.check(run, state))
    device = {"platform": "gpu" if run.device == "cuda" else "cpu",
              "kind": torch.cuda.get_device_name(0) if run.device == "cuda" else "cpu",
              "count": int(run.cell.get("chips", 1)), "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": int(run.records.get("attempted", 0)),
           "failed": int(run.records.get("failed", 0)), "metrics": metrics, "device": device}
    if run.trace_on and run.trace.t0 is not None:
        device["busy_s"] = run.trace.busy_s()
        device["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown(run.spans)
    out["checks"] = compared
    return out


def main(argv=None, t_start: float | None = None) -> int:
    t_start = _process_start() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    run = Run(args.workload, args.seed, args.seconds, bool(args.trace))

    import torch

    chips = int(run.cell.get("chips", 1))
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < chips:
        print(f"cell {args.workload} needs {chips} cards, {torch.cuda.device_count()} seen",
              file=sys.stderr)
        return 3
    try:
        out = run_cell(run, t_start)
    except SystemExit:
        raise
    except Exception:
        traceback.print_exc()
        return 1
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
