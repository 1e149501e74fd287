"""GPipe-style pipeline parallelism over a ``stage`` mesh axis (port of
``repro.parallel.pipeline``).

Each rank of the ``stage`` dim of a ``DeviceMesh`` holds one stage's slice
of the parameters; microbatches flow stage to stage on the GPipe tick
schedule (``n_micro + n_stages - 1`` ticks: fill, then drain).  The
reference moves a tick's activations with ``lax.ppermute``; here each tick
is one ``batch_isend_irecv`` over the stage group (send to the next stage,
receive from the previous).  The last stage's outputs then reach every
rank by a broadcast over the group, as the reference's ``psum`` of the
masked outputs gives them (a broadcast keeps their bits).  A stage runs
only on the ticks that carry one of its microbatches; the reference runs
every tick and masks the idle ones to zero.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["pipeline_apply"]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def pipeline_apply(stage_fn, stage_params, x: torch.Tensor, *, mesh, n_micro: int,
                   axis: str = "stage") -> torch.Tensor:
    """Run ``x`` through the ``n_stages`` stages of ``mesh``'s ``axis``.

    Args:
      stage_fn: ``(params_slice, activations) -> activations`` for ONE stage
        (activations keep their shape).
      stage_params: tree whose leaves have a leading ``n_stages`` axis (each
        rank reads its own stage's slice).
      x: (batch, ...) global input, the same on every rank; batch must
        divide by ``n_micro``.
      mesh: a ``DeviceMesh`` with a dim named ``axis``.
    Returns: (batch, ...) output of the final stage, on every rank.
    """
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    batch = x.shape[0]
    if batch % n_micro:
        raise ValueError(f"batch {batch} does not divide into {n_micro} microbatches")
    xs = x.reshape((n_micro, batch // n_micro) + tuple(x.shape[1:]))
    sid = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    params = _tree_map(lambda p: p[sid], stage_params)
    last = n_stages - 1
    peer = {s: dist.get_global_rank(group, s) for s in range(n_stages)} if n_stages > 1 else {}

    state = torch.zeros_like(xs[0])
    outputs = torch.zeros_like(xs)
    for t in range(n_micro + n_stages - 1):
        mb = t - sid
        active = 0 <= mb < n_micro
        out = torch.zeros_like(xs[0])
        if active:
            out = stage_fn(params, xs[mb] if sid == 0 else state)
            if sid == last:
                outputs[mb] = out
        if n_stages > 1:
            ops = []
            if sid < last:
                ops.append(dist.P2POp(dist.isend, out.contiguous(), peer[sid + 1], group))
            if sid > 0:
                state = torch.empty_like(xs[0])
                ops.append(dist.P2POp(dist.irecv, state, peer[sid - 1], group))
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    if n_stages > 1:
        dist.broadcast(outputs, peer[last], group=group)
    return outputs.reshape((batch,) + tuple(outputs.shape[2:]))
