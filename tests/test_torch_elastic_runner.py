"""The port's ``ElasticRunner`` and ``CheckpointManager.restore(shardings=)``
(the counterpart of the reference's ``test_elastic_remesh_drill``).

On PyTorch's ``fake`` backend (one process standing for 8 ranks): a drill
saves the state, "loses" half the devices, and recovers from ``(4, 2)`` onto
``(2, 2)``: the recorded step, every parameter a DTensor of its global shape
with the placements of its logical axes on the new mesh, and a step function
built for that mesh.  On a 2-rank gloo group, where collectives move real
data: ``recover`` restores a checkpoint written by one process onto a
``(1, 2)`` mesh, every leaf's ``full_tensor`` is the saved value, and the
loss on the restored DTensor parameters is the one-process loss within
``LOSS_TOL``.  ``restore`` without shardings, and with a 1-rank mesh, gives
plain tensors.
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_dist import last_json, run_py, run_ranks  # noqa: E402

LOSS_TOL = 1e-5

_FAKE_DRILL = """
import json, math, tempfile
import torch, torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import registry
from repro_torch.launch import train
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.runtime.elastic import ElasticRunner

def fake_mesh(shape):
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", rank=0, world_size=math.prod(shape), store=FakeStore())
    return make_mesh(shape, "cpu")

cfg = registry.reduced(registry.get("yi-9b"))
params = build_model(cfg).init_params(torch.Generator().manual_seed(0))
mesh8 = fake_mesh((4, 2))
built = []
runner = ElasticRunner(
    ckpt=CheckpointManager(tempfile.mkdtemp()),
    model_parallel=2,
    make_mesh=fake_mesh,
    make_shardings=lambda mesh: {"params": train.param_shardings(cfg, mesh)},
    build_step=lambda mesh: built.append(tuple(mesh.shape)) or (lambda *a: None),
)
mesh, state, step, step_fn = runner.drill({"params": params}, 10, kill_fraction=0.5)
want = train.param_shardings(cfg, mesh)
rec = {
    "mesh": list(mesh.shape), "names": list(mesh.mesh_dim_names), "step": step,
    "built": [list(b) for b in built], "callable": callable(step_fn),
    "all_dtensor": all(isinstance(v, DTensor) for v in state["params"].values()),
    "shapes": all(tuple(v.shape) == tuple(params[k].shape) for k, v in state["params"].items()),
    "placements": all(tuple(v.placements) == want[k].placements
                      for k, v in state["params"].items()),
    "sharded": sum(any(p.is_shard() for p in v.placements) for v in state["params"].values()),
}
runner.ckpt.close()
dist.destroy_process_group()
print(json.dumps(rec))
"""


def test_drill_on_the_fake_backend_recovers_4x2_onto_2x2():
    rec = last_json(run_py(_FAKE_DRILL, timeout=120))
    assert rec["mesh"] == [2, 2] and rec["names"] == ["data", "model"]
    assert rec["step"] == 10 and rec["built"] == [[2, 2]] and rec["callable"]
    assert rec["all_dtensor"] and rec["shapes"] and rec["placements"]
    assert rec["sharded"] > 0


_GLOO_RESTORE = """
import json, os
import numpy as np
import torch, torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import registry
from repro_torch.launch import train
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from repro_torch.parallel import sharding as shd
from repro_torch.runtime.elastic import ElasticRunner

torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(STORE, WORLD), rank=RANK, world_size=WORLD)
cfg = registry.reduced(registry.get("yi-9b"))
model = build_model(cfg)
params = model.init_params(torch.Generator().manual_seed(0))
ckdir = os.path.join(os.path.dirname(STORE), "ckpt")
if RANK == 0:  # one process writes, as a run on another mesh did
    mgr = CheckpointManager(ckdir)
    mgr.save(10, {"params": params}, block=True)
    mgr.close()
dist.barrier()
runner = ElasticRunner(
    ckpt=CheckpointManager(ckdir), model_parallel=2,
    make_mesh=lambda shape: make_mesh(shape, "cpu"),
    make_shardings=lambda mesh: {"params": train.param_shardings(cfg, mesh)},
    build_step=lambda mesh: model.loss_fn,
)
mesh, tree, step, loss_fn = runner.recover(WORLD)
got = tree["params"]
same = all(torch.equal(got[k].full_tensor(), params[k]) for k in params)
rng = np.random.default_rng(0)
tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16))).long()
labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16))).long()
sh = shd.logical_sharding((4, 16), ("batch", None), mesh)
from torch.distributed.tensor import distribute_tensor
batch = {"tokens": distribute_tensor(tokens, mesh, list(sh.placements)),
         "labels": distribute_tensor(labels, mesh, list(sh.placements))}
with shd.activation_mesh(mesh), implicit_replication(), torch.no_grad():
    loss = float(loss_fn(got, batch).full_tensor())
with torch.no_grad():
    want = float(model.loss_fn(params, {"tokens": tokens, "labels": labels}))
runner.ckpt.close()
print(json.dumps({"mesh": list(mesh.shape), "step": step, "same": same, "loss": loss,
                  "want": want, "dtensor": all(isinstance(v, DTensor) for v in got.values()),
                  "sharded": sum(any(p.is_shard() for p in v.placements) for v in got.values())}))
dist.destroy_process_group()
"""


def test_restore_onto_a_2_rank_gloo_mesh():
    recs = [last_json(o) for o in run_ranks(_GLOO_RESTORE, 2, timeout=120)]
    for rec in recs:
        assert rec["mesh"] == [1, 2] and rec["step"] == 10
        assert rec["same"] and rec["dtensor"] and rec["sharded"] > 0
        assert abs(rec["loss"] - rec["want"]) <= LOSS_TOL, rec


def test_restore_on_a_one_rank_mesh_gives_plain_tensors(tmp_path):
    rec = last_json(run_py(f"""
    import json
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import registry
    from repro_torch.launch import train
    from repro_torch.launch.mesh import init_single_card_group, make_mesh
    from repro_torch.models import build_model
    from repro_torch.runtime.elastic import ElasticRunner

    init_single_card_group("gloo")
    cfg = registry.reduced(registry.get("yi-9b"))
    params = build_model(cfg).init_params(torch.Generator().manual_seed(0))
    runner = ElasticRunner(
        ckpt=CheckpointManager({str(tmp_path)!r}), model_parallel=1,
        make_mesh=lambda shape: make_mesh(shape, "cpu"),
        make_shardings=lambda mesh: {{"params": train.param_shardings(cfg, mesh)}},
        build_step=lambda mesh: None)
    mesh, state, step, _ = runner.drill({{"params": params}}, 3)
    plain, _ = runner.ckpt.restore()
    runner.ckpt.close()
    print(json.dumps({{"mesh": list(mesh.shape), "step": step,
        "plain": all(type(v) is torch.Tensor for v in state["params"].values()),
        "same": all(torch.equal(state["params"][k], params[k]) for k in params),
        "host": all(not isinstance(v, torch.Tensor) or v.dtype == torch.bfloat16
                    for v in plain["params"].values())}}))
    """, timeout=120))
    assert rec == {"mesh": [1, 1], "step": 3, "plain": True, "same": True, "host": True}
