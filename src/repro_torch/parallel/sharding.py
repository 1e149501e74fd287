"""Logical-axis sharding rules (DP / TP / EP / SP) on ``DeviceMesh`` and DTensor
(port of ``repro.parallel.sharding``).

Params and activations are annotated with *logical* axis names; the rule
table maps them to mesh axes.  The table, its divisibility fallback (a
tensor dim the mapped mesh axes do not divide degrades to the largest
prefix of those axes that does, else to replicated) and the rule that a
mesh axis shards at most one dim of a tensor are the reference's, so
:func:`logical_spec` gives, entry for entry, the reference's
``PartitionSpec`` as a tuple (``str``, a ``tuple`` of axis names, or
``None`` per tensor dim).  It reads only the mesh's axis names and sizes,
so it takes a ``torch.distributed.device_mesh.DeviceMesh``, a
:class:`DeviceGrid`, or any object with ``axis_names`` and a ``shape``
mapping.

What differs, and why:

* **A sharding is DTensor placements.** :func:`to_placements` turns a spec
  into one placement per mesh dim: ``Shard(d)`` on every mesh dim that
  tensor dim ``d`` is split over (a dim over composed axes, such as
  ``("pod", "data")``, is ``Shard(d)`` on each), ``Replicate()`` on the
  rest.  :func:`logical_sharding` returns a :class:`Sharding` (mesh,
  placements, spec); :func:`constrain` is a DTensor ``redistribute``.
* **``act_constrain`` redistributes a DTensor and leaves anything else
  alone.**  Outside :func:`activation_mesh` and on a plain tensor it
  returns its input, so the models on one card, whose parameters are plain
  tensors, run exactly as without it.
* **The co-design grid is not a ``DeviceMesh``.**  The reference's single
  controller drives every device of the host with no collective; the
  port's evaluator does the same from one process, a row program per
  device.  :func:`population_mesh` and :func:`island_mesh` keep the
  reference's factoring, its warning naming the dropped devices and its
  ``(1, n)`` fallback, and return a :class:`DeviceGrid`: a named grid of
  ``torch.device``.  Their default devices are the process's CUDA devices;
  without a card they raise unless the caller passes devices.

GA population sharding (:func:`population_rules`): the ``"population"``
logical axis maps a generation's row axis onto the flat ``data`` axis and
unbinds ``"batch"``/``"embed"``, so nothing inside a chromosome's training
is partitioned and a generation needs no collective.  Row padding to
bucket sizes (multiples of the device count) lives in ``core.trainer``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import warnings
from collections.abc import Mapping
from typing import NamedTuple

import torch

__all__ = [
    "LOGICAL_RULES",
    "DeviceGrid",
    "Sharding",
    "population_rules",
    "population_mesh",
    "island_rules",
    "island_mesh",
    "mesh_axes",
    "logical_spec",
    "to_placements",
    "from_placements",
    "logical_sharding",
    "shard_tree",
    "constrain",
    "redistribute",
    "activation_mesh",
    "act_constrain",
    "act_reshape",
    "is_dtensor",
    "moe_stationary",
    "lm_act_axes",
    "attn_q_axes",
]

# logical axis -> mesh axes (tuple = composed axes, None = replicated)
LOGICAL_RULES: dict[str, tuple[str, ...] | None] = {
    "batch": ("pod", "data"),     # DP; "pod" silently dropped on 1-pod meshes
    "seq": None,                  # sequence kept local (SP variant: ("model",))
    "embed": ("data",),           # FSDP: weight d_model dims sharded over DP
    "embed_out": None,
    "heads": ("model",),          # Megatron TP: attention heads
    "kv_heads": ("model",),       # falls back to replicated when H_kv < TP
    "head_dim": ("model",),       # cache fallback when H_kv < TP (hd divides)
    "ffn": ("model",),            # Megatron TP: MLP hidden
    "vocab": ("model",),          # embedding + logits sharded over vocab
    "experts": ("model",),        # MoE expert parallelism
    "expert_embed": ("data",),    # expert-weight d_model dim (FSDP default)
    "expert_ffn": None,           # intra-expert hidden stays local under EP
    "ssm_heads": ("model",),      # RWKV/Mamba channel TP
    "ssm_state": None,
    "conv_kernel": None,
    "population": ("data",),      # GA population sharding
    "island": ("island",),        # island-model sub-population groups
    "stage": ("stage",),          # pipeline parallelism (opt-in meshes)
    "seq_tp": ("model",),         # context-parallel fallback (heads % TP != 0)
}

Spec = tuple  # per tensor dim: str | tuple[str, ...] | None


@dataclasses.dataclass(frozen=True)
class DeviceGrid:
    """A named grid of ``torch.device``: ``devices`` in row-major order over
    ``dims`` (one size per name of ``axis_names``).  ``shape`` is the
    reference's mesh mapping ``{axis: size}``."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...]
    dims: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.dims) or math.prod(self.dims) != len(self.devices):
            raise ValueError(f"grid {self.dims} over {self.axis_names} does not hold "
                             f"{len(self.devices)} devices")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return len(self.devices)


class Sharding(NamedTuple):
    """A tensor's layout on a mesh: its spec and the DTensor placements."""

    mesh: object
    spec: Spec
    placements: tuple


def population_rules() -> dict[str, tuple[str, ...] | None]:
    """Rule overrides for GA population evaluation: rows over ``data``,
    nothing inside a chromosome's training partitioned."""
    return {"population": ("data",), "batch": None, "embed": None}


def island_rules() -> dict[str, tuple[str, ...] | None]:
    """:func:`population_rules` plus the ``island`` axis: (K, P, ...) stacks
    put island groups on ``island`` and rows on ``data`` within a group."""
    return {**population_rules(), "island": ("island",)}


def _visible_devices(n_devices: int | None, devices) -> list[torch.device]:
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the co-design grid defaults to the process's "
                "CUDA devices; pass devices=[...] (e.g. torch.device('cpu') "
                "stand-ins) to build one without a card"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if n_devices is not None:
            devices = devices[:n_devices]
    return [torch.device(d) for d in devices]


def population_mesh(n_devices: int | None = None, devices=None) -> DeviceGrid:
    """Flat 1-D ``data`` grid over the devices (the population axis).

    ``n_devices`` keeps the first n CUDA devices; ``devices`` pins an
    explicit list (the elastic path hands the survivors here)."""
    devices = _visible_devices(n_devices, devices)
    return DeviceGrid(tuple(devices), ("data",), (len(devices),))


def island_mesh(num_islands: int, n_devices: int | None = None, devices=None) -> DeviceGrid:
    """2-D ``(island, data)`` grid: one device group per island.

    The devices are factored into ``num_islands`` equal groups; a count that
    does not divide uses the largest subset that does (8 devices, 3 islands:
    ``(3, 2)`` over the first 6) with a warning naming the dropped devices.
    With fewer devices than islands the grid is ``(1, n)``."""
    devices = _visible_devices(n_devices, devices)
    n = len(devices)
    if num_islands < 1:
        raise ValueError(f"num_islands must be >= 1, got {num_islands}")
    group = n // num_islands
    if group < 1:
        return DeviceGrid(tuple(devices), ("island", "data"), (1, n))
    used = group * num_islands
    if used != n:
        dropped = ", ".join(str(d) for d in devices[used:])
        warnings.warn(
            f"island_mesh: {n} devices do not factor into {num_islands} "
            f"islands; using the first {used} as a ({num_islands}, {group}) "
            f"mesh and dropping [{dropped}]",
            stacklevel=2,
        )
    return DeviceGrid(tuple(devices[:used]), ("island", "data"), (num_islands, group))


def mesh_axes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh``, a :class:`DeviceGrid`, a
    mapping, or any mesh with ``axis_names`` and a ``shape`` mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:  # DeviceMesh: shape is a tuple over its dims
        return dict(zip(names, tuple(mesh.shape)))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def logical_spec(shape, logical_axes, mesh, rules: dict | None = None) -> Spec:
    """The spec of ``shape`` under the rules, with the divisibility fallback."""
    rules = {**LOGICAL_RULES, **(rules or {})}
    if len(shape) != len(logical_axes):
        raise ValueError(f"shape {tuple(shape)} and axes {tuple(logical_axes)} differ in rank")
    sizes = mesh_axes(mesh)
    spec: list = []
    used: set[str] = set()
    for dim, name in zip(shape, logical_axes):
        entry = rules.get(name) if name else None
        axes = tuple(a for a in (entry or ()) if a in sizes and a not in used)
        placed = None
        # the whole tuple first, then its largest prefix that divides
        for k in range(len(axes), 0, -1):
            if dim % math.prod(sizes[a] for a in axes[:k]) == 0:
                placed = axes[:k]
                break
        if placed:
            spec.append(placed if len(placed) > 1 else placed[0])
            used.update(placed)
        else:
            spec.append(None)
    return tuple(spec)


def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def to_placements(spec: Spec, mesh) -> tuple:
    """One DTensor placement per mesh dim for ``spec``: ``Shard(d)`` on each
    mesh dim tensor dim ``d`` is split over, ``Replicate()`` elsewhere.  A dim
    over composed axes names them in mesh order, as the rules do."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_axes(mesh))
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"axes {axes} of dim {d} are not in the mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def from_placements(placements, ndim: int, mesh) -> Spec:
    """The spec that :func:`to_placements` maps to ``placements``."""
    from torch.distributed.tensor import Shard

    names = list(mesh_axes(mesh))
    per_dim: list[list[str]] = [[] for _ in range(ndim)]
    for name, p in zip(names, placements):
        if isinstance(p, Shard):
            per_dim[p.dim % ndim].append(name)
    return tuple(None if not a else (a[0] if len(a) == 1 else tuple(a)) for a in per_dim)


def logical_sharding(shape, logical_axes, mesh, rules: dict | None = None) -> Sharding:
    spec = logical_spec(shape, logical_axes, mesh, rules)
    return Sharding(mesh, spec, to_placements(spec, mesh))


def _is_axes(x) -> bool:
    return isinstance(x, (tuple, list)) and all(isinstance(e, (int, str, type(None))) for e in x)


def shard_tree(tree_shapes, tree_logical, mesh, rules: dict | None = None):
    """Map matching trees (dicts, lists, tuples) of shapes and logical-axis
    tuples to :class:`Sharding`\\ s."""
    if _is_axes(tree_shapes) and _is_axes(tree_logical):
        return logical_sharding(tuple(tree_shapes), tuple(tree_logical), mesh, rules)
    if isinstance(tree_shapes, dict):
        return {k: shard_tree(tree_shapes[k], tree_logical[k], mesh, rules) for k in tree_shapes}
    return type(tree_shapes)(
        shard_tree(s, a, mesh, rules) for s, a in zip(tree_shapes, tree_logical)
    )


class _Redistribute(torch.autograd.Function):
    """``redistribute`` whose gradient takes the same layout, as the transpose
    of JAX's ``with_sharding_constraint`` constrains the cotangent: a partial
    sum arriving in the backward pass is reduced here, not carried into the
    next product (where DTensor would compute it unsharded)."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.placements), None


def redistribute(x, placements):
    """DTensor ``x`` in ``placements``, forward and backward."""
    return _Redistribute.apply(x, tuple(placements))


def constrain(x, logical_axes, mesh, rules: dict | None = None):
    """Redistribute the DTensor ``x`` (and its gradient) to the layout of its
    logical axes."""
    sh = logical_sharding(tuple(x.shape), tuple(logical_axes), mesh, rules)
    return redistribute(x, sh.placements)


# ---------------------------------------------------------------------------
# activation-constraint context: model code calls ``act_constrain``, which
# is a no-op outside a mesh context and on a plain tensor, and a DTensor
# redistribute inside one.  Without these hints the DTensor strategies follow
# the FSDP parameter layout and replicate the batch.
# ---------------------------------------------------------------------------

_TLS = threading.local()


@contextlib.contextmanager
def activation_mesh(mesh, rules: dict | None = None):
    prev = getattr(_TLS, "ctx", None)
    _TLS.ctx = (mesh, rules)
    try:
        yield
    finally:
        _TLS.ctx = prev


def act_constrain(x, logical_axes):
    ctx = getattr(_TLS, "ctx", None)
    if ctx is None or not is_dtensor(x):
        return x
    mesh, rules = ctx
    return constrain(x, logical_axes, mesh, rules)


def act_reshape(x, shape, logical_axes):
    """``x.reshape(shape)`` that splits x's last dim (heads x head_dim), then
    ``act_constrain(., logical_axes)``.  A DTensor cannot split a dim whose
    shards do not fall on the new outer dim (4 KV heads of a 512-wide
    projection sharded 16 ways), so inside a mesh it is first redistributed
    to the split layout: the last dim sharded as the new outer dim is."""
    shape = tuple(shape)
    ctx = getattr(_TLS, "ctx", None)
    if ctx is None or not is_dtensor(x):
        return x.reshape(shape)
    mesh, rules = ctx
    spec = logical_spec(shape, logical_axes, mesh, rules)
    k = x.dim() - 1
    if any(e is not None for e in spec[k + 1:]):
        raise ValueError(f"act_reshape shards only the outer split dim: {spec}")
    flat = spec[:k] + (spec[k],)
    x = redistribute(x, to_placements(flat, mesh)).reshape(shape)
    return redistribute(x, to_placements(spec, mesh))


def is_dtensor(x) -> bool:
    """True for a DTensor (imports the DTensor module only for a subclass)."""
    if not isinstance(x, torch.Tensor) or type(x) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def moe_stationary() -> bool:
    """True when the active rules shard ``expert_ffn`` (weights-stationary
    MoE): expert weights never move, the token batch is gathered into the
    expert compute and the down-projection's partial sums are reduced."""
    ctx = getattr(_TLS, "ctx", None)
    if ctx is None:
        return False
    rules = {**LOGICAL_RULES, **(ctx[1] or {})}
    return rules.get("expert_ffn") is not None


def _needs_seq_tp(n_heads: int) -> bool:
    ctx = getattr(_TLS, "ctx", None)
    if ctx is None:
        return False
    tp = mesh_axes(ctx[0]).get("model", 1)
    return n_heads % tp != 0


def lm_act_axes(n_heads: int) -> tuple[str | None, ...]:
    """(B, S, d) activation axes: the sequence stays local when the head
    count divides TP (Megatron TP), else the layer runs context-parallel."""
    return ("batch", "seq_tp", None) if _needs_seq_tp(n_heads) else ("batch", None, None)


def attn_q_axes(n_heads: int) -> tuple[str | None, ...]:
    """(B, S, H, d) q axes: head-TP when H divides the model axis, else
    context-parallel over the query sequence."""
    if _needs_seq_tp(n_heads):
        return ("batch", "seq_tp", None, None)
    return ("batch", None, "heads", None)
