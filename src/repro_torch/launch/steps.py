"""Step builders and sharding assembly shared by the dry run, training and
serving (port of ``repro.launch.steps``).

For each (arch, shape kind) this module gives the step function and its
in/out shardings, derived from the model's logical axes through
``parallel.sharding``:

  * train:   ``(params, opt_state, batch) -> (params, opt_state, loss)``
  * prefill: ``(params, inputs) -> (logits, cache)``
  * decode:  ``(params, token, cache, kv_len) -> (logits, cache, kv_len+1)``

A sharding is a ``parallel.sharding.Sharding``: the spec, entry for entry
the reference's ``PartitionSpec``, and its DTensor placements.  The plan's
``args`` are meta tensors (no allocation).  The reference's ``lower_plan``
lowers the step with ``jax.jit``; here :func:`lower_plan` traces it, on
fake tensors laid out by the plan's placements (DTensors on a mesh of more
than one rank), under ``activation_mesh`` and ``launch.op_cost``, and
returns the per-device counts.  It compiles nothing.  The step functions
run as well on real tensors: on one card, with plain tensors for
parameters, the plan's ``prefill_step`` and ``serve_step`` are the model's
``prefill`` and ``decode_step`` and launch K4 and K5.

Optimizer selection is a deployment policy: AdamW below 100B parameters,
Adafactor (factored second moments, bf16 momentum) above, which is what
lets arctic-480b's optimizer state fit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch import optim
from repro_torch.launch import shapes as shp
from repro_torch.models import build_model
from repro_torch.models.api import exact_n_params
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import DTYPES
from repro_torch.parallel import sharding as shd

__all__ = [
    "ADAFACTOR_THRESHOLD",
    "choose_optimizer",
    "specs_to_shardings",
    "specs_to_structs",
    "opt_state_shardings",
    "fix_cache_axes",
    "LoweringPlan",
    "build_plan",
    "lower_plan",
]

ADAFACTOR_THRESHOLD = 100_000_000_000


def choose_optimizer(cfg: ModelConfig):
    if exact_n_params(cfg) >= ADAFACTOR_THRESHOLD:
        return optim.adafactor(lr=optim.cosine_warmup(1e-4, 200, 10_000))
    return optim.adamw(lr=optim.cosine_warmup(3e-4, 200, 10_000))


# ---------------------------------------------------------------------------
# sharding assembly
# ---------------------------------------------------------------------------

def specs_to_shardings(specs: dict, mesh, rules=None) -> dict:
    return {
        k: shd.logical_sharding(tuple(shape), tuple(axes), mesh, rules)
        for k, (shape, axes, _) in specs.items()
    }


def specs_to_structs(specs: dict) -> dict:
    """{name: meta tensor of the spec's shape and dtype}."""
    return {
        k: torch.empty(tuple(shape), dtype=DTYPES[dtype], device="meta")
        for k, (shape, _, dtype) in specs.items()
    }


def _sharding(mesh, spec) -> shd.Sharding:
    return shd.Sharding(mesh, tuple(spec), shd.to_placements(tuple(spec), mesh))


def opt_state_shardings(opt, param_structs: dict, param_shardings: dict, mesh):
    """Shardings for the optimizer state tree.

    mu/nu mirror the param sharding; adafactor's row/col drop the param's
    last / second-to-last dim; scalars are replicated."""
    state_shape = opt.init(param_structs)
    repl = _sharding(mesh, ())

    def build(field, tree):
        def leaf(name, t):
            psh = param_shardings.get(name)
            if psh is None or t.dim() == 0:
                return repl
            pspec = psh.spec
            if tuple(t.shape) == tuple(param_structs[name].shape):
                return psh
            if field == "row":  # param (..., n, m) -> (..., n)
                return _sharding(mesh, pspec[:-1])
            if field == "col":  # param (..., n, m) -> (..., m)
                return _sharding(mesh, pspec[:-2] + pspec[-1:] if len(pspec) >= 2 else ())
            return repl

        return {k: leaf(k, v) for k, v in tree.items()}

    out = []
    for field, tree in zip(state_shape._fields, state_shape):
        out.append(build(field, tree) if isinstance(tree, dict) else repl)
    return type(state_shape)(*out)


def fix_cache_axes(cache_specs: dict, cfg: ModelConfig, mesh) -> dict:
    """KV-cache TP placement: heads when H_kv divides TP, else the cached
    SEQUENCE axis (flash-decode style): head_dim sharding would split the QK
    contraction and reduce every score tensor; sequence sharding reduces
    only the softmax statistics and the output."""
    tp = shd.mesh_axes(mesh).get("model", 1)
    out = {}
    for k, (shape, axes, dtype) in cache_specs.items():
        axes = tuple(axes)
        if len(shape) == 5 and "kv_heads" in axes:
            h_idx = axes.index("kv_heads")
            if shape[h_idx] % tp != 0:
                # (L, B, S, H, hd) -> shard S instead of H/hd
                axes = tuple(
                    "seq_tp" if i == 2 else (a if a != "head_dim" else None)
                    for i, a in enumerate(axes)
                )
        out[k] = (shape, axes, dtype)
    return out


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------

def _placed(fn, out_shardings):
    """``fn`` whose DTensor outputs take ``out_shardings``' placements, as
    ``jax.jit(..., out_shardings=...)`` lays out its results (the updated
    parameters and optimizer state keep their layout step after step)."""

    def place(t, sh):
        if shd.is_dtensor(t) and tuple(t.placements) != tuple(sh.placements):
            return t.redistribute(t.device_mesh, sh.placements)
        return t

    def walk(tree, sh):
        if isinstance(sh, shd.Sharding):
            return place(tree, sh)
        if isinstance(tree, dict):
            return {k: walk(v, sh[k]) for k, v in tree.items()}
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*(walk(v, s) for v, s in zip(tree, sh)))
        if isinstance(tree, (tuple, list)):
            return type(tree)(walk(v, s) for v, s in zip(tree, sh))
        return tree

    def step(*args):
        return walk(fn(*args), out_shardings)

    step.__name__ = getattr(fn, "__name__", "step")
    return step


@dataclasses.dataclass
class LoweringPlan:
    """Everything needed to trace (or run) one (arch x shape) cell on one mesh."""

    step_fn: Callable
    args: tuple            # meta tensors (or real tensors for running)
    in_shardings: tuple
    out_shardings: Any
    donate_argnums: tuple = ()
    kind: str = ""


def _train_step_fn(model, opt):
    """The reference's ``train_step``: loss and gradients, clip to 1.0, update."""

    def train_step(params, opt_state, batch):
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        loss = model.loss_fn(leaves, batch)
        found = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(leaves.items(), found)}
        grads, _ = optim.clip_by_global_norm(grads, 1.0)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss.detach()

    return train_step


def _input_structs(inputs: dict) -> dict:
    return {k: torch.empty(s, dtype=getattr(torch, dt), device="meta")
            for k, (s, dt) in inputs.items()}


def build_plan(cfg: ModelConfig, shape_name: str, mesh, rules=None, *,
               shape: shp.ShapeSpec | None = None, opt=None) -> LoweringPlan:
    """The plan of ``shape_name``'s cell (``shape`` overrides its sizes, as
    the card's one-card cut does; ``opt`` the train step's optimizer, by
    default ``choose_optimizer``'s)."""
    model = build_model(cfg)
    sp = shape or shp.SHAPES[shape_name]
    kind, inputs, input_axes = shp.input_specs(cfg, shape_name, sp)
    pspecs = model.param_specs()
    param_structs = specs_to_structs(pspecs)
    param_sh = specs_to_shardings(pspecs, mesh, rules)
    in_structs = _input_structs(inputs)
    input_sh = {
        k: shd.logical_sharding(tuple(v.shape), input_axes[k], mesh, rules)
        for k, v in in_structs.items()
    }
    repl = _sharding(mesh, ())

    if kind == "train":
        opt = opt or choose_optimizer(cfg)
        opt_structs = opt.init(param_structs)
        opt_sh = opt_state_shardings(opt, param_structs, param_sh, mesh)
        out_sh = (param_sh, opt_sh, repl)
        return LoweringPlan(
            step_fn=_placed(_train_step_fn(model, opt), out_sh),
            args=(param_structs, opt_structs, in_structs),
            in_shardings=(param_sh, opt_sh, input_sh),
            out_shardings=out_sh,
            donate_argnums=(0, 1),
            kind=kind,
        )

    if kind == "prefill":
        def prefill_step(params, batch):
            if cfg.family == "audio":
                from repro_torch.models import whisper

                enc = whisper.encode(params, batch["frames"], cfg)
                ck, cv = whisper.build_cross_cache(params, enc, cfg)
                return enc, {"cross_k": ck, "cross_v": cv}
            if cfg.family == "vlm":
                return model.prefill(params, batch["tokens"], batch["patch_embeds"])
            return model.prefill(params, batch["tokens"])

        out_sh = _infer_output_shardings(_prefill_shapes(model, cfg, in_structs), cfg, mesh,
                                         rules)
        return LoweringPlan(
            step_fn=_placed(prefill_step, out_sh),
            args=(param_structs, in_structs),
            in_shardings=(param_sh, input_sh),
            out_shardings=out_sh,
            kind=kind,
        )

    # decode
    cache_specs = model.cache_specs(sp.global_batch, sp.seq_len)
    cache_specs = fix_cache_axes(cache_specs, cfg, mesh)
    cache_structs = specs_to_structs(cache_specs)
    cache_sh = specs_to_shardings(cache_specs, mesh, rules)

    def serve_step(params, token, cache, kv_len):
        logits, new_cache = model.decode_step(params, token, cache, kv_len)
        return logits, new_cache, kv_len + 1

    out_sh = (
        shd.logical_sharding((sp.global_batch, cfg.padded_vocab), ("batch", "vocab"), mesh,
                             rules),
        cache_sh,
        input_sh["kv_len"],
    )
    return LoweringPlan(
        step_fn=_placed(serve_step, out_sh),
        args=(param_structs, in_structs["token"], cache_structs, in_structs["kv_len"]),
        in_shardings=(param_sh, input_sh["token"], cache_sh, input_sh["kv_len"]),
        out_shardings=out_sh,
        donate_argnums=(2,),
        kind=kind,
    )


def _prefill_shapes(model, cfg: ModelConfig, inputs: dict):
    """Meta tensors of the prefill step's outputs, from the model's own
    ``cache_specs`` (the reference evaluates the step abstractly; running
    the port's step on meta tensors takes seconds a cell at full depth).
    ``tests/test_torch_plans.py`` holds them to the step's real outputs."""
    B = next(iter(inputs.values())).shape[0]
    if cfg.family == "audio":
        T = inputs["frames"].shape[1]
        specs = model.cache_specs(B, T)
        enc = torch.empty((B, T, cfg.d_model), dtype=DTYPES[cfg.dtype], device="meta")
        return enc, specs_to_structs({k: specs[k] for k in ("cross_k", "cross_v")})
    S = inputs["tokens"].shape[1]
    if cfg.family == "vlm" and "patch_embeds" in inputs:
        S += inputs["patch_embeds"].shape[1]
    logits = torch.empty((B, S, cfg.padded_vocab), dtype=DTYPES[cfg.dtype], device="meta")
    return logits, specs_to_structs(model.cache_specs(B, S))


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return fn(tree)


def _infer_output_shardings(out_shape, cfg: ModelConfig, mesh, rules=None):
    """Batch-sharded leading axis, vocab-sharded logits, else replicated."""

    def leaf(t):
        nd = t.dim()
        if nd >= 2 and t.shape[-1] == cfg.padded_vocab:
            axes = ("batch",) + (None,) * (nd - 2) + ("vocab",)
        elif nd == 5:  # KV caches: (L, B, S, H, hd)
            axes = (None, "batch", None, "kv_heads", "head_dim")
        elif nd == 3:
            axes = ("batch", None, None)
        else:
            axes = (None,) * nd
        return shd.logical_sharding(tuple(t.shape), axes, mesh, rules)

    return _map_tree(leaf, out_shape)


def lower_plan(plan: LoweringPlan, mesh, rules=None):
    """Trace the plan's step on fake tensors laid out by its in-shardings,
    under the activation mesh; returns ``launch.op_cost.Costs`` per device
    (with ``argument_bytes``).  Nothing is compiled or allocated."""
    from repro_torch.launch import op_cost

    return op_cost.trace_plan(plan, mesh, rules)
