"""End-to-end driver: train a ~100M-param transformer, with a failure drill
(the port's twin of the reference's ``examples/train_lm.py``).

Exercises the whole training path: the train step, the synthetic token
pipeline, async checkpointing with auto-resume, the straggler watchdog, and
a mid-run failure drill (a crash at half the steps, then a restart from the
newest checkpoint).

    PYTHONPATH=src python -m repro_torch.launch.train_lm [--steps 200] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import shutil
import tempfile

from repro_torch.configs import registry
from repro_torch.launch import train as train_mod
from repro_torch.models.api import exact_n_params
from repro_torch.models.config import ModelConfig

__all__ = ["hundred_m_config", "main"]


def hundred_m_config() -> ModelConfig:
    """~100M-param llama-style config (yi-9b's family at d_model 512, 8 layers)."""
    return dataclasses.replace(
        registry.get("yi-9b"),
        name="yi-100m",
        n_layers=8,
        d_model=512,
        n_heads=8,
        n_kv_heads=4,
        d_ff=1536,
        vocab_size=65536,
        dtype="float32",
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--crash-drill", action="store_true", default=True)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = hundred_m_config()
    print(f"model: {cfg.name} ({exact_n_params(cfg)/1e6:.0f}M params)")
    registry.ARCHS[cfg.name] = cfg  # register for the driver

    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_train_lm_")
    half = args.steps // 2
    common = dict(arch=cfg.name, reduced=False, steps=args.steps, global_batch=4,
                  seq_len=128, ckpt_dir=ckpt_dir, ckpt_every=25, device=args.device)
    try:
        if args.crash_drill:
            print(f"\n-- phase 1: train with injected crash at step {half} --")
            try:
                train_mod.run(train_mod.TrainConfig(**common, crash_at=half))
            except RuntimeError as e:
                print(f"CRASH (injected): {e}")
            print("\n-- phase 2: auto-resume from newest checkpoint --")
        out = train_mod.run(train_mod.TrainConfig(**common, resume=True))
        first, last = out["losses"][0], out["final_loss"]
        print(f"\nloss: {first:.3f} -> {last:.3f} over {len(out['losses'])} resumed steps")
        if not last < first:
            raise RuntimeError(f"training must reduce loss: {first:.4f} -> {last:.4f}")
        print("OK: loss decreased; checkpoint/restart drill passed")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
