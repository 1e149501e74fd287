"""The parts of a DTensor step that run on each device's shards.

DTensor has a sharding strategy for each aten op, and some of the models'
computations have none: the plain attention's einsums decompose into
reshapes that merge a batch dim sharded over ``data`` with a head dim
sharded over ``model`` (``bmm`` has no strategy for the strided layout
that merge gives), and the MoE dispatch scatters token indices into a
plain tensor.  Both are local per batch row (attention per head too), and
the reference's XLA partitions them so.  These wrappers say so to DTensor
with ``local_map``: they pick the placements under which the plain code
runs on local shards unchanged, let DTensor redistribute the inputs to
them (the collectives are counted as any other), and run it on each
device's shards; an input every device reads whole while using only its
own part gets a partial-sum gradient (``Partial``).

* :func:`attention`: q (B, Sq, Hq, d) as ``act_constrain`` left it: batch
  over ``data`` (and ``pod``), heads over ``model`` or, for a head count
  TP does not divide, the query sequence (``seq_tp``).  k/v follow q's
  batch and, where their own heads are split over the same mesh dim, its
  heads; otherwise they are gathered there, and each device picks the KV
  heads its query heads read (``index_select``); their gradient there is a
  partial sum (``Partial``).  A sequence-split q is causal from its shard's
  offset.
* :func:`decode_attention`: one token against a cache split over batch and
  either KV heads or the cached sequence (``launch.steps.fix_cache_axes``).
  A sequence-split cache runs flash-decode: each device scores its slice of
  the cache, and the softmax's max and sum and the output are all-reduced
  over that mesh dim, as the reference's partitioned softmax does.

On the card the local shards take the kernels, as plain tensors do
(``models.transformer.attend``/``decode_attend``): K4 for the attention
outside training, K5 for a decode step.  Neither takes a layout split over
the sequence (K4 has no query offset, K5 returns no softmax max and sum to
all-reduce), so a sequence-split q or cache on the card raises; the plain
versions above run those layouts on the CPU and in the dry run's trace.
* :func:`embedding`: a vocab-parallel lookup, as the reference's XLA
  partitions ``jnp.take`` of a vocab-split table: the table's rows stay
  split over the mesh dims that split the vocabulary (the rest of it is
  gathered), each device looks up the ids that fall in its rows, and the
  masked partial rows are summed (an all-reduce over those mesh dims).
  DTensor's own vocab-parallel lookup fails to reduce its masked partial
  sums for batch-split ids, and the backward of an indexed DTensor (an
  accumulating ``index_put``) has no strategy in some torch releases.
* :func:`project`: ``x @ w`` for an activation split over its sequence
  (context parallel, ``seq_tp``): DTensor cannot flatten a batch split over
  ``data`` with a sequence split over ``model``, so each device multiplies
  its tokens by the whole weight (gathered; its gradient a partial sum).
* :func:`heads`: a computation local per (batch row, head) on (B, ..., H *
  hd) inputs split over batch and whole heads, such as RWKV-6's chunked
  WKV and its recurrent step: each device runs it on its heads, with its
  share of a per-channel parameter (``u``, whose gradient is a partial sum
  over the batch shards).
* :func:`moe_dispatch` and :func:`moe_combine`: the MoE block's routing and
  index dispatch, and its combine, per batch row: the tokens whole on each
  device of a batch shard, the router gathered (its gradient a partial sum
  over the batch shards); the expert products between them are DTensor
  ops on the experts split over ``model`` (``act_constrain``), and the
  combine gathers the experts' outputs back.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.decode_attn import ops as decode_ops
from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.models import layers as L

__all__ = ["attention", "decode_attention", "embedding", "project", "splits_sequence",
           "heads", "moe_dispatch", "moe_combine"]


def _local_map(fn, out_placements, in_placements, mesh, in_grad_placements=None):
    from torch.distributed.tensor.experimental import local_map

    return local_map(fn, out_placements=out_placements, in_placements=in_placements,
                     in_grad_placements=in_grad_placements, device_mesh=mesh,
                     redistribute_inputs=True)


def _dims(placements, dim):
    """Mesh dims on which ``placements`` shard tensor dim ``dim``."""
    from torch.distributed.tensor import Shard

    return [i for i, p in enumerate(placements) if isinstance(p, Shard) and p.dim == dim]


def _no_kernel(kernel: str, what: str):
    return RuntimeError(f"{kernel} takes no {what} split over the sequence; this layout has "
                        "no kernel on the card (its plain version runs on the CPU)")


def attention(plain, q, k, v, causal: bool, train: bool = False):
    """``plain(q, k, v, causal=..., q_offset=...)`` on local shards; K4 on
    CUDA shards unless ``train``."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = q.device_mesh
    pq = tuple(q.placements)
    head_dims = _dims(pq, 2)
    seq_dims = _dims(pq, 1)
    kv_split = bool(head_dims) and all(
        isinstance(k.placements[i], Shard) and k.placements[i].dim == 2 for i in head_dims)
    pkv = tuple(
        Shard(0) if p == Shard(0) else (Shard(2) if i in head_dims and kv_split else Replicate())
        for i, p in enumerate(pq)
    )
    Hq, Hkv = q.shape[2], k.shape[2]

    def local(ql, kl, vl):
        coord = mesh.get_coordinate()
        offset = 0
        for i in seq_dims:
            offset = offset * mesh.size(i) + coord[i]
        q_offset = offset * ql.shape[1]
        card = ql.is_cuda and not train
        if card and seq_dims:
            raise _no_kernel("K4 (flash_attn.ops.flash_attention)", "query")
        if head_dims and not kv_split:
            # each device's query heads read the KV heads of their groups
            first = 0
            for i in head_dims:
                first = first * mesh.size(i) + coord[i]
            heads = torch.arange(ql.shape[2], device=ql.device) + first * ql.shape[2]
            sel = heads // (Hq // Hkv)
            kl, vl = kl.index_select(2, sel), vl.index_select(2, sel)
        if card:
            return flash_ops.flash_attention(ql.contiguous(), kl.contiguous(), vl.contiguous(),
                                             causal=causal)
        if q_offset:
            return plain(ql, kl, vl, causal=causal, q_offset=q_offset)
        return plain(ql, kl, vl, causal=causal)

    # k/v gathered where q is split: each device's gradient is a partial sum
    gkv = tuple(Partial() if p == Replicate() and (i in head_dims or i in seq_dims) else p
                for i, p in enumerate(pkv))
    return _local_map(local, (pq,), (pq, pkv, pkv), mesh, (pq, gkv, gkv))(q, k, v)


def decode_attention(q, k_cache, v_cache, kv_len):
    """``layers.decode_attention_plain`` on local shards (flash-decode over a
    sequence-split cache); K5 on CUDA shards."""
    from torch.distributed._functional_collectives import all_reduce
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = k_cache.device_mesh
    pc = tuple(k_cache.placements)
    seq_dims = _dims(pc, 1)
    head_dims = _dims(pc, 2)
    batch_dims = _dims(pc, 0)
    pq = tuple(Shard(0) if i in batch_dims else (Shard(1) if i in head_dims else Replicate())
               for i in range(mesh.ndim))
    plen = tuple(Shard(0) if i in batch_dims else Replicate() for i in range(mesh.ndim))

    def local(ql, kl, vl, nl):
        if ql.is_cuda:
            if seq_dims:
                raise _no_kernel("K5 (decode_attn.ops.decode_attention)", "cache")
            return decode_ops.decode_attention(ql.contiguous(), kl, vl, nl)
        if not seq_dims:
            return L.decode_attention_plain(ql, kl, vl, nl)
        coord = mesh.get_coordinate()
        part = 0
        for i in seq_dims:
            part = part * mesh.size(i) + coord[i]
        B, Hq, d = ql.shape
        S_l, Hkv = kl.shape[1], kl.shape[2]
        G = Hq // Hkv
        s = torch.einsum("bhgd,bshd->bhgs", ql.reshape(B, Hkv, G, d).to(torch.float32),
                         kl.to(torch.float32)) * (1.0 / (d ** 0.5))
        pos = torch.arange(S_l, device=ql.device) + part * S_l
        s = s.masked_fill(~(pos[None, None, None, :] < nl[:, None, None, None]), L.NEG_INF)
        groups = [(mesh, i) for i in seq_dims]
        m = s.amax(-1, keepdim=True)
        for g in groups:
            m = all_reduce(m, "max", g)
        p = torch.exp(s - m)
        den = p.sum(-1, keepdim=True)
        o = torch.einsum("bhgs,bshd->bhgd", p, vl.to(torch.float32))
        for g in groups:
            den = all_reduce(den, "sum", g)
            o = all_reduce(o, "sum", g)
        return (o / den).reshape(B, Hq, d).to(ql.dtype)

    if not isinstance(kv_len, DTensor):  # a constant the step made: the same on every rank
        kv_len = DTensor.from_local(kv_len, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return _local_map(local, (pq,), (pq, pc, pc, plen), mesh)(q, k_cache, v_cache, kv_len)


def _batch_placements(x, dim: int, batch_dims):
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(dim) if i in batch_dims else Replicate() for i in range(x.device_mesh.ndim))


def moe_dispatch(dispatch, h, router, cfg):
    """``dispatch(h, {"router": router}, cfg) -> (xe (E, B, C, d), slot (B,
    S*K), topv (B, S, K))`` on each batch shard."""
    from torch.distributed.tensor import Partial, Replicate

    mesh = h.device_mesh
    batch = _dims(tuple(h.placements), 0)
    ph = _batch_placements(h, 0, batch)
    repl = (Replicate(),) * mesh.ndim
    grad_router = tuple(Partial() if i in batch else Replicate() for i in range(mesh.ndim))
    outs = (_batch_placements(h, 1, batch), ph, ph)

    def local(hl, rl):
        return dispatch(hl, {"router": rl}, cfg)

    return _local_map(local, outs, (ph, repl), mesh, (ph, grad_router))(h, router)


def moe_combine(combine, y, slot, topv):
    """``combine(y (E, B, C, d), slot, topv) -> (B, S, d)`` on each batch
    shard, every expert's output gathered."""
    mesh = slot.device_mesh
    batch = _dims(tuple(slot.placements), 0)
    py = _batch_placements(y, 1, batch)
    pb = _batch_placements(slot, 0, batch)
    return _local_map(combine, (pb,), (py, pb, pb), mesh, (py, pb, pb))(y, slot, topv)


def embedding(table, ids):
    """Rows ``ids`` of the DTensor ``table`` (V, d), vocab-parallel."""
    import torch.nn.functional as F
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = table.device_mesh
    if not isinstance(ids, DTensor):  # a constant the step made: the same on every rank
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim, run_check=False)
    vocab = _dims(tuple(table.placements), 0)
    batch = _dims(tuple(ids.placements), 0)
    pt = tuple(Shard(0) if i in vocab else Replicate() for i in range(mesh.ndim))
    pi = tuple(Shard(0) if i in batch and i not in vocab else Replicate()
               for i in range(mesh.ndim))
    out = tuple(Shard(0) if p == Shard(0) else (Partial() if i in vocab else Replicate())
                for i, p in enumerate(pi))
    gt = tuple(Shard(0) if i in vocab else (Partial() if pi[i] == Shard(0) else Replicate())
               for i in range(mesh.ndim))

    def local(tl, il):
        if not vocab:
            return F.embedding(il, tl)
        coord = mesh.get_coordinate()
        part = 0
        for i in vocab:
            part = part * mesh.size(i) + coord[i]
        rows = tl.shape[0]
        j = il - part * rows
        miss = (j < 0) | (j >= rows)
        got = F.embedding(j.clamp(0, rows - 1), tl)
        return got.masked_fill(miss[..., None], 0.0)

    rows = _local_map(local, (out,), (pt, pi), mesh, (gt, pi))(table, ids)
    return rows.redistribute(mesh, pi)  # the masked partial rows summed


def heads(fn, xs, params, n_heads: int, outs):
    """``fn(*local_xs, *local_params, local_n_heads)`` on each device's batch
    rows and heads.

    ``xs``: ``(DTensor, head dim)`` pairs, each with the batch first; a head
    dim of None marks an input every head reads (whole on each device of a
    batch shard, its gradient a partial sum over the head groups).
    ``params``: ``(DTensor, head dim)`` pairs without a batch dim (their
    gradient a partial sum over the batch shards).  ``outs``: the head dim
    of each output (its dim 0 the batch).  The heads split as the rules
    split ``ssm_heads`` (over ``model``, where it divides ``n_heads``)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.parallel.sharding import logical_spec, mesh_axes

    first = xs[0][0]
    mesh = first.device_mesh
    names = list(mesh_axes(mesh))
    batch = _dims(tuple(first.placements), 0)
    entry = logical_spec((n_heads,), ("ssm_heads",), mesh)[0]
    split = [names.index(a) for a in ((entry,) if isinstance(entry, str) else entry or ())
             if names.index(a) not in batch]
    parts = 1
    for i in split:
        parts *= mesh.size(i)

    def place(lead, dim, whole):
        return tuple(Shard(lead) if lead is not None and i in batch
                     else (Shard(dim) if dim is not None and i in split
                           else (whole if i in split or i in batch else Replicate()))
                     for i in range(mesh.ndim))

    pin = tuple(place(0, d, Replicate()) for _, d in xs)
    gin = tuple(place(0, d, Partial()) for _, d in xs)
    pp = tuple(place(None, d, Replicate()) for _, d in params)
    gp = tuple(place(None, d, Partial()) for _, d in params)
    pout = tuple(place(0, d, Replicate()) for d in outs)

    def local(*args):
        return fn(*args, n_heads // parts)

    mapped = _local_map(local, pout if len(outs) > 1 else (pout[0],), pin + pp, mesh, gin + gp)
    return mapped(*(t for t, _ in xs), *(t for t, _ in params))


def splits_sequence(x) -> bool:
    """A (B, S, d) DTensor whose sequence is split over a mesh dim."""
    return x.dim() == 3 and bool(_dims(tuple(x.placements), 1))


def project(x, w):
    """``x @ w`` on each device's tokens, the weight gathered whole."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = x.device_mesh
    px = tuple(p if p in (Shard(0), Shard(1)) else Replicate() for p in x.placements)
    whole = (Replicate(),) * mesh.ndim
    gw = tuple(Partial() if p != Replicate() else Replicate() for p in px)
    return _local_map(torch.matmul, (px,), (px, whole), mesh, (px, gw))(x, w)
