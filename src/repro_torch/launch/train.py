"""End-to-end LM training driver (port of ``repro.launch.train``).

Wires the pieces together as the reference does: model zoo + train step +
token pipeline + async checkpointing + auto-resume + straggler watchdog +
failure injection + optional int8 gradient compression.  ``run`` builds the
mesh as the reference does, ``make_mesh(choose_mesh_shape(n, ...))`` over
the process group's ranks (on one card a 1-rank group it makes and tears
down, ``(1, 1)``), computes the parameters' placements
(:func:`param_shardings`) and runs the loop inside ``activation_mesh``.
Like the reference, which computes them and never hands them to ``jit``, it
does not redistribute the parameters: on one card they stay plain tensors,
``act_constrain`` leaves them alone, and a step is the same as without the
mesh.

The step is the reference's ``train_step``: the loss and its gradients
(``torch.autograd.grad`` of ``model.loss_fn``, which takes the plain
attention on every device), ``clip_by_global_norm(grads, 1.0)``, with
``int8_ef`` compress then decompress, then ``opt.update`` (the optimizer of
``steps.choose_optimizer``).  ``run`` keeps the reference's loop: the VLM's
patch embeddings and the audio family's frames drawn per step from
``default_rng(step)``, a micro-checkpoint once per straggler episode, and
its resume semantics, quirks included: the checkpoint labelled ``step``
holds the state after that step's update, a resume starts at that label
(so it runs that step again), and the int8_ef error buffer is not
checkpointed.  Parameters are drawn and trained outside
``torch.inference_mode()`` (inference tensors cannot be saved for backward).

CLI:
  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --steps 50 \
      --ckpt-dir DIR [--resume] [--grad-compression int8_ef] \
      [--crash-at 30] [--device cpu] [--full --layers 8]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import optim
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import registry
from repro_torch.data.tokens import TokenConfig, TokenStream
from repro_torch.device import resolve_device
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import init_single_card_group, make_mesh
from repro_torch.models import build_model
from repro_torch.optim import compress
from repro_torch.runtime import FailureInjector, StragglerWatchdog
from repro_torch.parallel import sharding as shd
from repro_torch.runtime.elastic import choose_mesh_shape

__all__ = ["TrainConfig", "build_train_state", "param_shardings", "model_config",
           "step_batch", "run", "main"]


@dataclasses.dataclass
class TrainConfig:
    arch: str = "yi-9b"
    reduced: bool = True
    steps: int = 50
    global_batch: int = 8
    seq_len: int = 128
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_every: int = 20
    resume: bool = False
    grad_compression: str = "none"  # none | int8_ef
    crash_at: int | None = None
    log_every: int = 10
    seed: int = 0
    device: str | None = None  # None = "cuda"
    # depth cut of the config (None = its own): yi-9b's 48 layers and their
    # AdamW state (106 GB) do not fit one 80 GB card, 8 do
    n_layers: int | None = None


def build_train_state(cfg_model, grad_compression: str = "none"):
    """(model, optimizer, init_fn(gen) -> (params, opt_state) on ``gen``'s
    device, train_step).

    ``train_step(params, opt_state, comp_state, batch)`` returns (params,
    opt_state, comp_state, loss, gnorm), the batch's tensors on the
    parameters' device."""
    model = build_model(cfg_model)
    opt = steps_mod.choose_optimizer(cfg_model)
    use_comp = grad_compression == "int8_ef"

    def init_fn(gen: torch.Generator):
        params = model.init_params(gen)
        return params, opt.init(params)

    def train_step(params, opt_state, comp_state, batch):
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        loss = model.loss_fn(leaves, batch)
        found = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        # a parameter the loss does not reach gets a zero gradient, as in JAX
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(leaves.items(), found)}
        grads, gnorm = optim.clip_by_global_norm(grads, 1.0)
        if use_comp:
            codes, scales, comp_state = compress.compress_gradients(grads, comp_state)
            grads = compress.decompress_gradients(codes, scales)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, comp_state, loss.detach(), gnorm

    return model, opt, init_fn, train_step


def param_shardings(cfg_model, mesh) -> dict:
    """{name: ``parallel.sharding.Sharding``} of the model's parameters on
    ``mesh`` (``steps.specs_to_shardings`` of its logical axes)."""
    return steps_mod.specs_to_shardings(build_model(cfg_model).param_specs(), mesh)


@contextlib.contextmanager
def _train_mesh(dev: torch.device):
    """The training mesh over this process group's ranks; without a group, a
    1-rank one (NCCL on the card, gloo on the CPU) made for the run and torn
    down after it."""
    import torch.distributed as dist

    own = not dist.is_initialized()
    if own:
        init_single_card_group("nccl" if dev.type == "cuda" else "gloo")
    try:
        n = dist.get_world_size()
        shape = choose_mesh_shape(n, model_parallel=min(n, 2) if n > 1 else 1)
        yield make_mesh(shape, dev.type)
    finally:
        if own:
            dist.destroy_process_group()


def model_config(cfg: TrainConfig):
    """The model configuration ``cfg`` trains: reduced and depth-cut as asked."""
    model_cfg = registry.get(cfg.arch)
    if cfg.reduced:
        model_cfg = registry.reduced(model_cfg)
    if cfg.n_layers is not None:
        model_cfg = dataclasses.replace(model_cfg, n_layers=cfg.n_layers)
    return model_cfg


def step_batch(stream: TokenStream, step: int, model_cfg, cfg: TrainConfig, dev) -> dict:
    """Step ``step``'s batch on ``dev``: tokens and labels, with the
    reference's synthetic patch embeddings (VLM) or frames (audio, whose
    tokens are cut to ``max_target_len``), drawn from ``default_rng(step)``."""
    batch = stream.batch_at(step)
    if model_cfg.family == "vlm":
        rng = np.random.default_rng(step)
        batch["patch_embeds"] = rng.uniform(
            0, 1, (cfg.global_batch, model_cfg.frontend_len, model_cfg.d_model)
        ).astype(np.float32)
    if model_cfg.family == "audio":
        rng = np.random.default_rng(step)
        batch = {
            "frames": rng.uniform(
                0, 1, (cfg.global_batch, cfg.seq_len, model_cfg.d_model)
            ).astype(np.float32),
            "tokens": batch["tokens"][:, : model_cfg.max_target_len],
            "labels": batch["labels"][:, : model_cfg.max_target_len],
        }
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev) for k, v in batch.items()}


def run(cfg: TrainConfig) -> dict:
    """Train ``cfg.steps`` steps (from the newest checkpoint with ``resume``).

    Returns {"losses", "gnorms", "final_loss", "start_step", "mesh_shape",
    "straggler_events", "params"}: the losses and gradient norms of the steps
    this call ran."""
    dev = resolve_device(cfg.device)
    with _train_mesh(dev) as mesh:
        return _run(cfg, dev, mesh)


def _run(cfg: TrainConfig, dev, mesh) -> dict:
    model_cfg = model_config(cfg)
    mesh_shape = tuple(mesh.shape)
    param_sh = param_shardings(model_cfg, mesh)
    model, opt, init_fn, train_step = build_train_state(model_cfg, cfg.grad_compression)

    stream = TokenStream(
        TokenConfig(model_cfg.vocab_size, cfg.seq_len, cfg.global_batch, cfg.seed)
    )
    mgr = CheckpointManager(cfg.ckpt_dir, keep_n=3)
    watchdog = StragglerWatchdog()
    injector = FailureInjector(crash_at_step=cfg.crash_at)

    start_step = 0
    if cfg.resume and mgr.latest_step() is not None:
        tree, manifest = mgr.restore()
        params = {k: torch.as_tensor(v).to(dev) for k, v in tree["params"].items()}
        opt_state = _restore_opt(opt, params, tree, dev)
        start_step = manifest["step"]
        print(f"resumed from step {start_step}")
    else:
        params, opt_state = init_fn(torch.Generator(device=dev).manual_seed(cfg.seed))
    comp_state = compress.init_state(params)

    losses, gnorms = [], []
    try:
        with shd.activation_mesh(mesh):
            for step in range(start_step, cfg.steps):
                injector.maybe_fail(step)
                t0 = time.perf_counter()
                batch = step_batch(stream, step, model_cfg, cfg, dev)
                params, opt_state, comp_state, loss, gnorm = train_step(
                    params, opt_state, comp_state, batch
                )
                losses.append(float(loss))  # waits for the step
                gnorms.append(float(gnorm))
                dt = time.perf_counter() - t0
                ev = watchdog.observe(step, dt)
                if ev and ev["checkpoint_now"] and ev["consecutive"] == 1:
                    # micro-checkpoint once per straggler episode; checkpointing
                    # every flagged step would itself slow the next step and spiral
                    mgr.save(step, _state_tree(params, opt_state))
                if step % cfg.log_every == 0:
                    print(f"step {step}: loss={losses[-1]:.4f} gnorm={gnorms[-1]:.3f} "
                          f"{dt*1e3:.0f}ms")
                if step > 0 and step % cfg.ckpt_every == 0:
                    mgr.save(step, _state_tree(params, opt_state))
            mgr.save(cfg.steps, _state_tree(params, opt_state), block=True)
    finally:
        # drain the async writer even on a crash: an enqueued checkpoint left
        # in .tmp is invisible to ``latest_step`` and a resume would restart
        # from step 0
        mgr.close()
    return {"losses": losses, "gnorms": gnorms,
            "final_loss": losses[-1] if losses else None, "start_step": start_step,
            "mesh_shape": mesh_shape, "param_shardings": param_sh,
            "straggler_events": watchdog.events, "params": params}


def _state_tree(params, opt_state) -> dict:
    tree = {"params": params}
    for field in opt_state._fields:
        tree[f"opt_{field}"] = getattr(opt_state, field)
    return tree


def _restore_opt(opt, params, tree, dev):
    template = opt.init(params)
    vals = []
    for field in template._fields:
        saved = tree.get(f"opt_{field}")
        if saved is None:
            vals.append(getattr(template, field))
        elif isinstance(getattr(template, field), dict):
            vals.append({k: torch.as_tensor(v).to(dev) for k, v in saved.items()})
        else:
            vals.append(torch.as_tensor(saved).to(dev))
    return type(template)(*vals)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=TrainConfig.ckpt_dir)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--grad-compression", default="none", choices=["none", "int8_ef"])
    ap.add_argument("--crash-at", type=int, default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (e.g. 8 for yi-9b --full)")
    args = ap.parse_args()
    out = run(
        TrainConfig(
            arch=args.arch,
            reduced=args.reduced,
            steps=args.steps,
            global_batch=args.global_batch,
            seq_len=args.seq_len,
            ckpt_dir=args.ckpt_dir,
            resume=args.resume,
            grad_compression=args.grad_compression,
            crash_at=args.crash_at,
            device=args.device,
            n_layers=args.layers,
        )
    )
    print(f"done: final loss {out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
