"""Multi-pod dry run: trace every (arch x shape x mesh) cell on a fake mesh
and count its per-device work (port of ``repro.launch.dryrun``).

    python -m repro_torch.launch.dryrun [--arch A] [--shape S]
        [--mesh single|multi|both] [--skip-existing] [--out-dir DIR]
        [--reduced --mesh-shape 2x2]

One process on PyTorch's ``fake`` process-group backend at world 256
(``pod16x16``) or 512 (``pod2x16x16``): parameters, optimizer state, caches
and inputs are DTensors of fake tensors laid out by ``steps.build_plan``'s
placements, and the step is traced under ``launch.op_cost`` and
``CommDebugMode``.  Like the reference's, it touches no device: it is a
host count of the plain versions' work, not a device metric.

Per cell it records per-device ``flops``, ``hbm_bytes``, collective bytes
by kind, the argument bytes a device holds, ``n_params`` and
``n_active_params``, and writes ``results/dryrun_torch/<arch>__<shape>__<mesh>.json``.
A cell whose step hits an op with no DTensor sharding strategy records
``ok: false`` with that op's error; nothing replicates in its place.
``--reduced`` traces the reduced configs (``registry.reduced``) at the same
shapes, and ``--mesh-shape`` a fake mesh of another shape (``2x2``:
``fake2x2``), as the CPU tests do.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from repro_torch.configs import registry
from repro_torch.launch import shapes as shp
from repro_torch.launch import steps as steps_mod
from repro_torch.models.api import exact_n_active_params, exact_n_params

__all__ = ["RESULTS_DIR", "MESHES", "fake_mesh", "run_cell", "main"]

RESULTS_DIR = os.path.join("results", "dryrun_torch")
MESHES = {"pod16x16": (16, 16), "pod2x16x16": (2, 16, 16)}


def fake_mesh(shape: tuple[int, ...]):
    """A ``DeviceMesh`` of ``shape`` on the ``fake`` backend (this process is
    rank 0 of ``prod(shape)``), replacing any process group it had."""
    import math

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import mesh_axis_names

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", rank=0, world_size=math.prod(shape), store=FakeStore())
    return init_device_mesh("cpu", shape, mesh_dim_names=mesh_axis_names(len(shape)))


def run_cell(arch: str, shape_name: str, mesh_name: str, mesh, cfg=None,
             save: bool = True, out_dir: str = RESULTS_DIR) -> dict:
    """Trace one cell on ``mesh`` (a fake mesh of ``MESHES[mesh_name]``)."""
    cfg = cfg or registry.get(arch)
    n_chips = mesh.size()
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "n_chips": n_chips,
                 "status": "run"}
    cells = {c.shape: c for c in shp.cell_plan(cfg)}
    if cells[shape_name].status == shp.SKIP:
        rec.update(status=shp.SKIP, reason=cells[shape_name].reason)
        if save:
            _save(rec, out_dir)
        return rec
    from torch.distributed.tensor.debug import CommDebugMode

    t0 = time.time()
    try:
        plan = steps_mod.build_plan(cfg, shape_name, mesh)
        with CommDebugMode() as comm:
            costs = steps_mod.lower_plan(plan, mesh)
        sp = shp.SHAPES[shape_name]
        rec.update({
            "ok": True,
            "trace_s": time.time() - t0,
            "flops_per_device": costs.flops,
            "hbm_bytes_per_device": costs.hbm_bytes,
            "collective_bytes_per_device": costs.collectives,
            "collective_total": costs.collective_total,
            "collective_calls": {str(k): v for k, v in comm.get_comm_counts().items()},
            "argument_bytes_per_device": costs.argument_bytes,
            "n_params": exact_n_params(cfg),
            "n_active_params": exact_n_active_params(cfg),
            "seq_len": sp.seq_len,
            "global_batch": sp.global_batch,
            "kind": sp.kind,
            "counted_by": "host trace of the plain versions (launch/op_cost.py), "
                          "not a device metric",
        })
    except Exception as e:  # a cell that fails is recorded, and the run goes on
        frames = [f"{f.filename.split('src/')[-1]}:{f.lineno} {f.name}"
                  for f in traceback.extract_tb(e.__traceback__) if "repro_torch" in f.filename]
        rec.update({"ok": False, "error": f"{type(e).__name__}: {_first_line(e)}",
                    "where": frames[-4:], "traceback": traceback.format_exc()[-2000:]})
    if save:
        _save(rec, out_dir)
    return rec


def _first_line(e: Exception) -> str:
    lines = [ln for ln in str(e).splitlines() if ln.strip()]
    return " | ".join(lines[:3])[:600]


def _save(rec: dict, out_dir: str):
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def _line(rec: dict) -> str:
    if rec["status"] == shp.SKIP:
        return f"SKIPPED {rec['arch']} {rec['shape']} {rec['mesh']}: {rec['reason']}"
    if rec.get("ok"):
        coll = " ".join(f"{k}={v:.3e}" for k, v in rec["collective_bytes_per_device"].items() if v)
        return (f"OK {rec['arch']} {rec['shape']} {rec['mesh']}: "
                f"flops/dev={rec['flops_per_device']:.4e} "
                f"hbm/dev={rec['hbm_bytes_per_device']:.4e}B "
                f"args/dev={rec['argument_bytes_per_device']:.4e}B "
                f"coll/dev={rec['collective_total']:.4e}B [{coll}] "
                f"trace={rec['trace_s']:.1f}s")
    return f"FAIL {rec['arch']} {rec['shape']} {rec['mesh']}: {rec['error']}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="single arch (default: all)")
    ap.add_argument("--shape", default=None, help="single shape (default: all)")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out-dir", default=RESULTS_DIR)
    ap.add_argument("--reduced", action="store_true", help="the reduced configs")
    ap.add_argument("--mesh-shape", default=None, help="a fake mesh of this shape, e.g. 2x2")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else sorted(registry.ARCHS)
    shapes = [args.shape] if args.shape else list(shp.SHAPES)
    meshes = dict(MESHES)
    if args.mesh_shape:
        dims = tuple(int(d) for d in args.mesh_shape.split("x"))
        names = [f"fake{args.mesh_shape}"]
        meshes[names[0]] = dims
    else:
        names = {"single": ["pod16x16"], "multi": ["pod2x16x16"],
                 "both": ["pod16x16", "pod2x16x16"]}[args.mesh]

    import torch.distributed as dist

    failures = 0
    try:
        for mesh_name in names:
            mesh = fake_mesh(meshes[mesh_name])
            for arch in archs:
                cfg = registry.get(arch)
                cfg = registry.reduced(cfg) if args.reduced else cfg
                for shape_name in shapes:
                    path = os.path.join(args.out_dir, f"{arch}__{shape_name}__{mesh_name}.json")
                    if args.skip_existing and os.path.exists(path):
                        with open(path) as f:
                            old = json.load(f)
                        if old.get("ok") or old.get("status") == shp.SKIP:
                            print(f"SKIP-EXISTING {arch} {shape_name} {mesh_name}", flush=True)
                            continue
                    rec = run_cell(arch, shape_name, mesh_name, mesh, cfg=cfg,
                                   out_dir=args.out_dir)
                    failures += rec["status"] != shp.SKIP and not rec.get("ok")
                    print(_line(rec), flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
