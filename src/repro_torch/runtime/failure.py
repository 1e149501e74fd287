"""Failure injection for recovery drills (port of ``repro.runtime.failure``).

Simulates the fleet's failure modes against the in-process runtime:
``crash_at_step``/``crash_rate`` raise mid-training (tests auto-resume),
``corrupt_ckpt`` truncates a checkpoint payload (tests integrity skip),
``slow_step`` sleeps to trip the straggler watchdog.  Crashes come in two
flavours: ``DeviceLossError`` (a device group vanished — the elastic layer
re-meshes in-process) and ``HostFailure`` (the whole host died — recovery
is a fresh process restoring from the checkpoint directory).
"""

from __future__ import annotations

import dataclasses
import os
import random
import time

from repro_torch.checkpoint import ckpt


class DeviceLossError(RuntimeError):
    """A device group was lost mid-step; survivors can re-mesh in-process."""


class HostFailure(RuntimeError):
    """The host process died; recovery means restore-from-checkpoint."""


_CRASH_EXC = {"device": DeviceLossError, "host": HostFailure}


@dataclasses.dataclass
class FailureInjector:
    seed: int = 0
    crash_at_step: int | None = None
    crash_rate: float = 0.0
    crash_mode: str = "device"
    slow_at_step: int | None = None
    slow_seconds: float = 0.2

    def __post_init__(self):
        if self.crash_mode not in _CRASH_EXC:
            raise ValueError(
                f"crash_mode must be one of {sorted(_CRASH_EXC)}, got {self.crash_mode!r}"
            )
        if not 0.0 <= self.crash_rate <= 1.0:
            raise ValueError(f"crash_rate must be in [0, 1], got {self.crash_rate}")
        self._rng = random.Random(self.seed)

    def maybe_fail(self, step: int):
        exc = _CRASH_EXC[self.crash_mode]
        if self.crash_at_step is not None and step == self.crash_at_step:
            raise exc(f"injected {self.crash_mode} failure at step {step}")
        if self.crash_rate > 0.0 and self._rng.random() < self.crash_rate:
            raise exc(f"injected probabilistic {self.crash_mode} failure at step {step}")

    def maybe_slow(self, step: int):
        if self.slow_at_step is not None and step == self.slow_at_step:
            time.sleep(self.slow_seconds)

    @staticmethod
    def corrupt_checkpoint(path: str):
        """Flip bytes in a checkpoint payload (integrity-check drill)."""
        payload = os.path.join(path, ckpt.PAYLOAD)
        if not os.path.exists(payload):
            raise FileNotFoundError(
                f"corrupt_checkpoint: no checkpoint payload at {payload} — "
                f"{path!r} is not a checkpoint directory written by "
                "ckpt.save_pytree (expected it to contain "
                f"{ckpt.PAYLOAD!r} and {ckpt.MANIFEST!r})"
            )
        with open(payload, "r+b") as f:
            f.seek(max(os.path.getsize(payload) // 2, 0))
            f.write(b"\x00" * 64)
