"""Which attention a DTensor step's local shards take (``parallel.local``).

On the card the shards take the kernels as plain tensors do: K4 for the
attention outside training, K5 for a decode step; a layout split over the
sequence, which neither kernel takes, raises there instead of running the
plain version.  On the CPU the plain versions run.  The card's side is
checked here on fake CUDA tensors (``FakeTensorMode``, the ``fake``
process-group backend, a (2, 2) ``DeviceMesh`` on "cuda"), with the two
wrappers replaced by stubs that record their local shapes: a fake tensor
cannot launch a kernel.  The launches themselves are ``chip_smoke.py``'s
(``plan_serve``, its DTensor run).
"""

import pytest

torch = pytest.importorskip("torch")

from _torch_dist import last_json, run_py  # noqa: E402

ROUTES = r"""
import json
import torch, torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.models import layers as L, transformer
from repro_torch.parallel import local

dist.init_process_group("fake", rank=0, world_size=4, store=FakeStore())
calls = []

def k4(q, k, v, causal=True):
    calls.append(("K4", list(q.shape), list(k.shape), str(q.device), causal))
    return torch.empty_like(q)

def k5(q, kc, vc, kv_len=None):
    calls.append(("K5", list(q.shape), list(kc.shape), str(q.device), str(kv_len.dtype)))
    return torch.empty_like(q)

def plain(q, k, v, causal=True, q_offset=0):
    calls.append(("plain", list(q.shape), list(k.shape), str(q.device), causal))
    return torch.empty_like(q)

local.flash_ops.flash_attention = k4
local.decode_ops.decode_attention = k5
B, S, Hq, Hkv, d = 4, 16, 8, 4, 8
out = {}

def run(name, fn):
    calls.clear()
    try:
        fn()
        out[name] = {"calls": [list(c) for c in calls]}
    except RuntimeError as e:
        out[name] = {"calls": [list(c) for c in calls], "raised": str(e)}

for kind in ("cuda", "cpu"):
    mesh = DeviceMesh(kind, torch.arange(4).reshape(2, 2), mesh_dim_names=("data", "model"))
    with FakeTensorMode(), torch.no_grad():
        def dt(shape, placements, dtype=torch.bfloat16):
            local_shape = list(shape)
            for i, p in enumerate(placements):
                if isinstance(p, Shard):
                    local_shape[p.dim] //= mesh.size(i)
            t = torch.empty(local_shape, dtype=dtype, device=kind)
            return DTensor.from_local(t, mesh, placements, run_check=False)

        heads = [Shard(0), Shard(2)]
        q, k, v = dt((B, S, Hq, d), heads), dt((B, S, Hkv, d), heads), dt((B, S, Hkv, d), heads)
        qs = dt((B, S, Hq, d), [Shard(0), Shard(1)])
        kv_whole = [Shard(0), Replicate()]
        kr, vr = dt((B, S, Hkv, d), kv_whole), dt((B, S, Hkv, d), kv_whole)
        run(f"{kind}/heads", lambda: transformer.attend(q, k, v, True))
        run(f"{kind}/heads_train", lambda: transformer.attend(q, k, v, True, plain, train=True))
        run(f"{kind}/kv_gathered", lambda: local.attention(L.plain_attention, q, kr, vr, True))
        run(f"{kind}/seq_split", lambda: local.attention(L.plain_attention, qs, kr, vr, True))
        qd = dt((B, Hq, d), [Shard(0), Replicate()])
        cache = [Shard(0), Shard(2)]
        kc, vc = dt((B, S, Hkv, d), cache), dt((B, S, Hkv, d), cache)
        seqc = [Shard(0), Shard(1)]
        kcs, vcs = dt((B, S, Hkv, d), seqc), dt((B, S, Hkv, d), seqc)
        n = torch.full((B,), S, dtype=torch.int32, device=kind)
        run(f"{kind}/decode_heads", lambda: transformer.decode_attend(qd, kc, vc, n))
        run(f"{kind}/decode_seq_split", lambda: local.decode_attention(qd, kcs, vcs, n))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def routes():
    return last_json(run_py(ROUTES, timeout=120))


def test_cuda_shards_take_k4_outside_training(routes):
    # batch over data (2), heads over model (2): each device's 2 rows, 4 of
    # the 8 query heads and their 2 KV heads
    assert routes["cuda/heads"] == {"calls": [["K4", [2, 16, 4, 8], [2, 16, 2, 8], "cuda:0",
                                               True]]}
    # training takes the plain version the model passes, on the same shards
    assert routes["cuda/heads_train"] == {"calls": [["plain", [2, 16, 4, 8], [2, 16, 2, 8],
                                                     "cuda:0", True]]}


def test_cuda_shards_with_gathered_kv_take_k4_on_their_heads(routes):
    # k/v whole over model: each device picks the KV heads its 4 query heads read
    assert routes["cuda/kv_gathered"] == {"calls": [["K4", [2, 16, 4, 8], [2, 16, 4, 8],
                                                     "cuda:0", True]]}


def test_cuda_sequence_split_query_raises(routes):
    got = routes["cuda/seq_split"]
    assert got["calls"] == [] and "K4" in got["raised"] and "sequence" in got["raised"]


def test_cuda_decode_shards_take_k5(routes):
    assert routes["cuda/decode_heads"] == {"calls": [["K5", [2, 4, 8], [2, 16, 2, 8], "cuda:0",
                                                      "torch.int32"]]}
    got = routes["cuda/decode_seq_split"]
    assert got["calls"] == [] and "K5" in got["raised"] and "sequence" in got["raised"]


@pytest.mark.parametrize("case", ["heads", "kv_gathered", "seq_split", "decode_heads",
                                  "decode_seq_split"])
def test_cpu_shards_take_the_plain_versions(routes, case):
    assert routes[f"cpu/{case}"] == {"calls": []}


def test_cpu_training_takes_the_plain_version_passed(routes):
    assert routes["cpu/heads_train"] == {"calls": [["plain", [2, 16, 4, 8], [2, 16, 2, 8],
                                                    "cpu", True]]}
