"""Checkpoints of the port: the reference's on-disk format, NumPy only."""

from repro_torch.checkpoint.ckpt import load_pytree, save_pytree  # noqa: F401
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
