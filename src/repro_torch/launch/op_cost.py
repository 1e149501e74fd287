"""Per-device op counts of a traced step (the counterpart of
``repro/launch/hlo_cost.py``).

The reference counts a cell's work from the post-SPMD HLO text of its
compiled program: FLOPs of every ``dot``, HBM bytes of every materialising
instruction, collective bytes by kind, each scaled by loop trip counts.
The port compiles no program, so that walker has no input here.  It counts
instead the aten ops a step dispatches, with a ``TorchDispatchMode``, while
the step runs on fake tensors (``FakeTensorMode``: shapes only, nothing
allocated or computed).

**Per device, on local shards.**  On a mesh the step's tensors are DTensors.
``FlopCounterMode`` over a DTensor program counts the *global* product (a
(256, 4096, 4096) x (4096, 11008) product sharded 16 x 16 counts 9.456e13
FLOPs, where one device computes 3.69e11).  :class:`OpCounter` steps aside
for every op that has a DTensor operand (it returns ``NotImplemented``, so
DTensor runs first), and counts the ops DTensor then issues on each
device's local shards: its redistributions as ``_c10d_functional``
collectives and its local compute.  The ops DTensor's sharding propagation
runs on global fake tensors to find output shapes are not counted.  Every
rank of a fake mesh runs the same local shapes, so rank 0's count is every
device's.

The three quantities of the reference's ``Costs``:

* ``flops``: 2·M·N·K for each matmul-family op (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, which is what ``einsum`` and ``matmul`` decompose to), and
  the same rule for ``convolution``; elementwise FLOPs are not counted.
  Remat's recompute is counted (it runs in the backward pass).
* ``hbm_bytes``: the reference's rule: 2x the result bytes of each
  materialising op (one write, one read downstream) and each entry argument
  once; pointwise ops (``torch.Tag.pointwise``), dtype conversions, views
  and factories are not charged, as XLA fuses them into their consumers.
  An in-place write (a KV cache's ``index_put_``) is charged the values it
  writes, not the tensor it returns.
* ``collectives``: bytes by kind (the larger of operand and result, as the
  reference reads the op line), all-reduce charged 2x; each also charges
  2x its bytes to ``hbm_bytes``.

**A kernel's work is its plain version's arithmetic.**  The trace runs on
fake CPU tensors, where every kernel wrapper takes its plain ``ref`` path,
so the count does not depend on what implements a kernel.  K4's count is
the plain attention's full S x S scores (causal or not), where the kernel
skips the masked half.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["KINDS", "Costs", "OpCounter", "trace", "trace_plan"]

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")

aten = torch.ops.aten

_COLLECTIVE_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
_NOT_CHARGED = {
    aten._to_copy.default,  # dtype conversion: XLA's elementwise convert
    aten.detach.default,
    aten.alias.default,
    aten.lift_fresh.default,
}


@dataclasses.dataclass
class Costs:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collectives: dict = dataclasses.field(default_factory=lambda: {k: 0.0 for k in KINDS})
    argument_bytes: float = 0.0

    @property
    def collective_total(self) -> float:
        return sum(self.collectives.values())

    def as_dict(self) -> dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collectives": dict(self.collectives),
            "collective_total": self.collective_total,
            "argument_bytes": self.argument_bytes,
        }


def _bytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _matmul_flops(func, args) -> float:
    if func in (aten.mm.default, aten.bmm.default):
        a, b = args[0], args[1]
    elif func in (aten.addmm.default, aten.baddbmm.default):
        a, b = args[1], args[2]
    else:
        return 0.0
    return 2.0 * math.prod(a.shape) * b.shape[-1]


def _conv_flops(args, out) -> float:
    w = args[1]  # (C_out, C_in / groups, *kernel)
    return 2.0 * out.numel() * math.prod(w.shape[1:])


def _is_view(func) -> bool:
    if func.is_view:
        return True
    rets = func._schema.returns
    return bool(rets) and rets[0].alias_info is not None and not rets[0].alias_info.is_write


def _writes_in_place(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and rets[0].alias_info is not None and rets[0].alias_info.is_write


class OpCounter(TorchDispatchMode):
    """Counts the local ops of a step (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.costs = Costs()
        self._paused = 0
        self._saved = None

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        orig = ShardingPropagator._propagate_tensor_meta_non_cached
        counter = self

        def propagate(prop, op_schema):
            # the global fake ops that find an output's shape are not work
            counter._paused += 1
            try:
                return orig(prop, op_schema)
            finally:
                counter._paused -= 1

        self._saved = (ShardingPropagator, orig)
        ShardingPropagator._propagate_tensor_meta_non_cached = propagate
        return super().__enter__()

    def __exit__(self, *exc):
        cls, orig = self._saved
        cls._propagate_tensor_meta_non_cached = orig
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor desugars into local ops first
        out = func(*args, **(kwargs or {}))
        if not self._paused:
            self._count(func, args, out)
        return out

    def _count(self, func, args, out) -> None:
        c = self.costs
        ns = func.namespace
        name = func._overloadpacket.__name__
        if ns in ("_c10d_functional", "_dtensor", "c10d_functional"):
            if name in ("wait_tensor",):
                return
            kind = _COLLECTIVE_KIND.get(name, name)
            nb = max([_bytes(t) for t in _tensors(args)] + [_bytes(t) for t in _tensors(out)])
            weight = 2 if kind == "all-reduce" else 1
            c.collectives[kind] = c.collectives.get(kind, 0.0) + nb * weight
            c.hbm_bytes += 2.0 * nb
            return
        if func in (aten.mm.default, aten.bmm.default, aten.addmm.default, aten.baddbmm.default):
            c.flops += _matmul_flops(func, args)
        elif func is aten.convolution.default:
            c.flops += _conv_flops(args, out)
        if (torch.Tag.pointwise in func.tags or func in _NOT_CHARGED or _is_view(func)
                or not _tensors(args)):
            return
        written = sum(_bytes(t) for t in _tensors(out))
        if _writes_in_place(func):
            # an in-place write (index_put_, copy_, scatter_) moves the values
            # it writes, not the whole tensor it returns
            written = min(written, sum(_bytes(t) for t in _tensors(args[1:])
                                       if t.is_floating_point()))
        c.hbm_bytes += 2.0 * written


def trace(fn, *args, **kwargs) -> tuple[Costs, object]:
    """Run ``fn(*args)`` (on fake or real tensors) under :class:`OpCounter`."""
    counter = OpCounter()
    with counter:
        out = fn(*args, **kwargs)
    counter.costs.argument_bytes = float(sum(_bytes(_local(t)) for t in _tensors(args)))
    counter.costs.hbm_bytes += counter.costs.argument_bytes
    return counter.costs, out


def _local(t):
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _materialize(tree, shardings, mesh, distributed: bool):
    """Fake tensors of the meta ``tree``'s shapes; DTensors laid out by
    ``shardings`` when ``distributed``."""
    if isinstance(tree, torch.Tensor):
        local = list(tree.shape)
        if distributed:
            from torch.distributed.tensor import DTensor, Shard

            sizes = list(mesh.shape)
            for i, p in enumerate(shardings.placements):
                if isinstance(p, Shard):
                    local[p.dim] //= sizes[i]
            t = torch.empty(local, dtype=tree.dtype)
            return DTensor.from_local(t, mesh, shardings.placements, run_check=False,
                                      shape=tree.shape, stride=tree.stride())
        return torch.empty(local, dtype=tree.dtype)
    if isinstance(tree, dict):
        return {k: _materialize(v, shardings[k], mesh, distributed) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_materialize(v, s, mesh, distributed)
                            for v, s in zip(tree, shardings)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_materialize(v, s, mesh, distributed)
                          for v, s in zip(tree, shardings))
    return tree


def trace_plan(plan, mesh, rules=None) -> Costs:
    """The per-device counts of ``plan``'s step on ``mesh`` (a ``DeviceMesh``;
    one of a single rank traces plain fake tensors)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.parallel import sharding as shd

    distributed = math.prod(shd.mesh_axes(mesh).values()) > 1
    with FakeTensorMode():
        args = _materialize(plan.args, plan.in_shardings, mesh, distributed)
        with shd.activation_mesh(mesh, rules), _replicate_constants(distributed):
            costs, _ = trace(plan.step_fn, *args)
    return costs


def _replicate_constants(distributed: bool):
    """Plain tensors a step makes for itself (positions, masks, RoPE tables)
    are the same on every rank: DTensor ops take them as replicated."""
    if not distributed:
        import contextlib

        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()
