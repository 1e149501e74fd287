"""The port's GPipe schedule (``repro_torch.parallel.pipeline``) in 4 gloo
processes, against the sequential composition of the stages and against the
reference's ``pipeline_apply`` (``shard_map`` + ``ppermute``) on the same
numpy inputs, run in a subprocess with 4 forced host devices (the shapes of
``tests/test_distributed.py:33-55``).  Every rank must hold the last stage's
output; the port equals the sequential composition bit for bit (a stage
runs the same ops on the same microbatch) and the reference within
``REF_TOL``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_dist import last_json, run_py, run_ranks  # noqa: E402

N_STAGES, N_MICRO, MB, D = 4, 4, 2, 16
REF_TOL = 1e-6  # fp32 tanh(h @ W) through 4 stages, two libraries


def _inputs():
    rng = np.random.default_rng(0)
    Ws = (rng.normal(size=(N_STAGES, D, D)) / np.sqrt(D)).astype(np.float32)
    x = rng.normal(size=(N_MICRO * MB, D)).astype(np.float32)
    return Ws, x


_PORT = """
import json
import numpy as np
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.parallel.pipeline import pipeline_apply

torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(STORE, WORLD), rank=RANK, world_size=WORLD)
mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("stage",))
rng = np.random.default_rng(0)
Ws = torch.from_numpy((rng.normal(size=(4, 16, 16)) / np.sqrt(16)).astype(np.float32))
x = torch.from_numpy(rng.normal(size=(8, 16)).astype(np.float32))

def stage_fn(params, h):
    return torch.tanh(h @ params["w"])

out = pipeline_apply(stage_fn, {"w": Ws}, x, mesh=mesh, n_micro=4)
print(json.dumps(out.tolist()))
dist.destroy_process_group()
"""

_REF = """
import json
import jax, jax.numpy as jnp, numpy as np
from repro.parallel.pipeline import pipeline_apply

mesh = jax.make_mesh((4,), ("stage",))
rng = np.random.default_rng(0)
Ws = jnp.asarray((rng.normal(size=(4, 16, 16)) / np.sqrt(16)).astype(np.float32))
x = jnp.asarray(rng.normal(size=(8, 16)).astype(np.float32))

def stage_fn(params, h):
    return jnp.tanh(h @ params["w"])

out = pipeline_apply(stage_fn, {"w": Ws}, x, mesh=mesh, n_micro=4)
print(json.dumps(np.asarray(out).tolist()))
"""


@pytest.fixture(scope="module")
def port_outputs():
    return [np.asarray(last_json(o), np.float32) for o in run_ranks(_PORT, 4, timeout=120)]


def test_every_stage_rank_holds_the_sequential_composition(port_outputs):
    Ws, x = _inputs()
    ref = torch.from_numpy(x)
    for s in range(N_STAGES):
        ref = torch.tanh(ref @ torch.from_numpy(Ws[s]))
    for out in port_outputs:
        assert out.shape == (N_MICRO * MB, D)
        np.testing.assert_array_equal(out, ref.numpy())


def test_pipeline_matches_the_reference(port_outputs):
    jax_out = np.asarray(last_json(run_py(
        _REF, timeout=120,
        env={"XLA_FLAGS": "--xla_force_host_platform_device_count=4", "JAX_PLATFORMS": "cpu"},
    )), np.float32)
    np.testing.assert_allclose(port_outputs[0], jax_out, rtol=0, atol=REF_TOL)


def test_one_stage_group_is_the_stage_itself():
    out = last_json(run_py("""
    import json
    import torch, torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.parallel.pipeline import pipeline_apply
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("stage",))
    g = torch.Generator().manual_seed(1)
    W = torch.randn(1, 16, 16, generator=g)
    x = torch.randn(8, 16, generator=g)
    fn = lambda p, h: torch.tanh(h @ p["w"])
    out = pipeline_apply(fn, {"w": W}, x, mesh=mesh, n_micro=2)
    try:
        pipeline_apply(fn, {"w": W}, x, mesh=mesh, n_micro=3)
        refused = False
    except ValueError:
        refused = True
    print(json.dumps({"equal": bool(torch.equal(out, fn({"w": W[0]}, x))), "refused": refused}))
    dist.destroy_process_group()
    """))
    assert out == {"equal": True, "refused": True}
