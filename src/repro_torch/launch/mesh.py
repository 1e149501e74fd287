"""Production mesh construction (port of ``repro.launch.mesh``).

Functions, not module-level constants: importing this module touches no
device and no process group.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with dims ``("data",
"model")`` or ``("pod", "data", "model")``; it needs a process group whose
world size is the product of its shape.  :func:`init_single_card_group`
makes the one-card case explicit (a 1-rank group on an in-memory store, no
environment variables): a silent ``init_process_group`` inside
:func:`make_mesh` would hide global state.  Several ranks come from the
caller's own ``init_process_group`` (gloo processes in the tests, the
``fake`` backend in ``launch.dryrun``).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

__all__ = ["init_single_card_group", "make_production_mesh", "make_mesh", "mesh_axis_names"]


def init_single_card_group(backend: str = "nccl") -> None:
    """A 1-rank process group on a ``HashStore`` for a mesh of one card
    (``backend="gloo"`` for one CPU rank); a no-op if this process already
    has a 1-rank group."""
    if dist.is_initialized():
        if dist.get_world_size() != 1:
            raise RuntimeError(f"a {dist.get_world_size()}-rank group is already initialized")
        return
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def mesh_axis_names(ndim: int) -> tuple[str, ...]:
    return ("pod", "data", "model") if ndim == 3 else ("data", "model")


def make_mesh(shape: tuple[int, ...], device_type: str = "cuda"):
    """Elastic-runtime entry: an arbitrary (pod?, data, model) mesh over the
    ranks of the initialized process group."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = tuple(int(s) for s in shape)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call init_single_card_group() "
                           "for one card, or torch.distributed.init_process_group")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, the group has "
                         f"{dist.get_world_size()}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device_type='cpu' for a CPU mesh")
    return init_device_mesh(device_type, shape, mesh_dim_names=mesh_axis_names(len(shape)))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """16x16 = 256 devices a pod; 2 pods on the multi-pod mesh (512)."""
    return make_mesh((2, 16, 16) if multi_pod else (16, 16), device_type)
