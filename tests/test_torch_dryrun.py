"""The port's per-device op counts (``repro_torch.launch.op_cost``) and its
dry run (``repro_torch.launch.dryrun``).

* FLOPs against the reference's ``hlo_cost.analyze`` of the same cell: the
  reference's step lowered on one device (outside a mesh, so its
  ``act_constrain`` stays a no-op under JAX 0.9.0) and compiled to HLO, the
  port's traced on fake tensors; reduced yi-9b, whisper and zamba2, train
  (remat on), prefill and decode at plain-attention lengths.  The counts
  agree within ``FLOP_TOL`` (measured: exact for yi-9b and whisper, 1.2e-3
  low for zamba2's train step); bytes are printed, not held: the two count
  different fusions.
* Per device means local shards: a data-parallel matmul on a fake 8-rank
  mesh counts the global FLOPs / 8, and an FSDP weight gather counts one
  all-gather of the whole weight.
* The CLI on reduced configs on a fake 2x2 mesh writes one record a cell.
"""

import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from _torch_dist import last_json, run_py  # noqa: E402

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.launch import hlo_cost  # noqa: E402
from repro.launch import shapes as jshapes  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import op_cost, shapes, steps  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402

FLOP_TOL = 2e-3  # relative; zamba2's train step measured 1.2e-3 below the HLO's
CELLS = {
    "train_4k": shapes.ShapeSpec("train_4k", "train", 32, 2),
    "prefill_32k": shapes.ShapeSpec("prefill_32k", "prefill", 32, 2),
    "decode_32k": shapes.ShapeSpec("decode_32k", "decode", 32, 2),
}


@pytest.mark.parametrize("shape", list(CELLS))
@pytest.mark.parametrize("arch", ["yi-9b", "whisper-medium", "zamba2-2.7b"])
def test_flops_match_the_reference_hlo(arch, shape, monkeypatch):
    sp = CELLS[shape]
    monkeypatch.setitem(jshapes.SHAPES, shape, jshapes.ShapeSpec(*dataclasses.astuple(sp)))
    jplan = jsteps.build_plan(jregistry.reduced(jregistry.get(arch)), shape,
                              AbstractMesh((1, 1), ("data", "model")))
    ref = hlo_cost.analyze(jax.jit(jplan.step_fn).lower(*jplan.args).compile().as_text())
    grid = shd.DeviceGrid((torch.device("cpu"),), ("data", "model"), (1, 1))
    plan = steps.build_plan(registry.reduced(registry.get(arch)), shape, grid, shape=sp)
    got = steps.lower_plan(plan, grid)
    print(f"{arch} {shape}: flops port {got.flops:.6e} hlo {ref.flops:.6e}; "
          f"hbm bytes port {got.hbm_bytes:.4e} hlo {ref.hbm_bytes:.4e}")
    assert ref.flops > 0
    assert abs(got.flops - ref.flops) <= FLOP_TOL * ref.flops
    assert got.collective_total == 0 and got.argument_bytes > 0


def test_matmul_family_flops_and_bytes_on_plain_fake_tensors():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        a, b = torch.empty(64, 32), torch.empty(32, 16)
        x, y = torch.empty(4, 8, 32), torch.empty(4, 32, 5)
        costs, _ = op_cost.trace(lambda a, b, x, y: (torch.relu(a @ b), torch.einsum(
            "bij,bjk->bik", x, y), torch.addmm(torch.empty(16), a, b)), a, b, x, y)
    assert costs.flops == 2 * (2 * 64 * 16 * 32) + 2 * 4 * 8 * 5 * 32
    # the relu is pointwise: not charged; every product writes once, read once
    assert costs.hbm_bytes == costs.argument_bytes + 2 * 4 * (2 * 64 * 16 + 4 * 8 * 5)


_LOCAL = """
import json
import torch, torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch import op_cost

dist.init_process_group("fake", rank=0, world_size=8, store=FakeStore())
mesh = init_device_mesh("cpu", (8,), mesh_dim_names=("data",))
out = {}
with FakeTensorMode():
    x = DTensor.from_local(torch.empty(32, 256), mesh, [Shard(0)], run_check=False)
    w = DTensor.from_local(torch.empty(256, 512), mesh, [Replicate()], run_check=False)
    dp, _ = op_cost.trace(torch.matmul, x, w)
    # FSDP: the weight's rows sharded over data; the product gathers the
    # weight, the cheaper side to move (rows of x: 1024 x 256, w: 256 x 64)
    xf = DTensor.from_local(torch.empty(128, 256), mesh, [Shard(0)], run_check=False)
    wf = DTensor.from_local(torch.empty(32, 64), mesh, [Shard(0)], run_check=False)
    fsdp, y = op_cost.trace(torch.matmul, xf, wf)
    out = {"dp_flops": dp.flops, "dp_coll": dp.collective_total,
           "dp_args": dp.argument_bytes, "fsdp": fsdp.collectives, "fsdp_flops": fsdp.flops,
           "out_rows_split": tuple(y.placements) == (Shard(0),)}
dist.destroy_process_group()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def local_counts():
    return last_json(run_py(_LOCAL, timeout=120))


def test_data_parallel_matmul_counts_its_shard(local_counts):
    glob = 2 * 256 * 256 * 512  # (256 rows x 256) @ (256 x 512)
    assert local_counts["dp_flops"] == glob / 8
    assert local_counts["dp_coll"] == 0
    # each device holds its 32 rows of x and the whole weight
    assert local_counts["dp_args"] == 4 * (32 * 256 + 256 * 512)


def test_fsdp_gather_counts_one_all_gather_of_the_weight(local_counts):
    coll = local_counts["fsdp"]
    assert coll["all-gather"] == 4 * 256 * 64
    assert all(v == 0 for k, v in coll.items() if k != "all-gather")
    assert local_counts["fsdp_flops"] == 2 * 128 * 256 * 64
    assert local_counts["out_rows_split"]


def test_cli_on_reduced_configs_on_a_fake_2x2_mesh(tmp_path):
    out = run_py(f"""
    from repro_torch.launch import dryrun
    raise SystemExit(dryrun.main(["--reduced", "--mesh-shape", "2x2", "--arch", "yi-9b",
                                  "--out-dir", {str(tmp_path)!r}]))
    """, timeout=120)
    recs = {p.name: json.loads(p.read_text()) for p in tmp_path.glob("*.json")}
    assert sorted(recs) == sorted(f"yi-9b__{s}__fake2x2.json" for s in shapes.SHAPES)
    for name, rec in recs.items():
        if rec["shape"] == "long_500k":
            assert rec["status"] == shapes.SKIP
            continue
        assert rec["ok"], rec.get("error")
        assert rec["n_chips"] == 4 and rec["flops_per_device"] > 0
        assert rec["hbm_bytes_per_device"] > rec["argument_bytes_per_device"] > 0
        assert rec["collective_total"] > 0 and rec["n_params"] > 0
        assert set(rec["collective_bytes_per_device"]) >= set(op_cost.KINDS)
    assert out.count("OK yi-9b") == 3 and "SKIPPED yi-9b long_500k" in out
