"""Elastic scaling: re-mesh and resume when the device pool changes, and
elastic GA campaigns with boundary snapshots, rollback and recovery (port of
``repro.runtime.elastic``).

:func:`choose_mesh_shape` is the reference's arithmetic: the largest
(pod?, data, model) mesh that fits a device count.  On one card it gives
``(1, 1)``; ``launch/train`` asks it as the reference's ``train.run`` does.

:class:`ElasticGARunner` wraps an NSGA-II driver (``core.nsga2.NSGA2`` /
``IslandNSGA2``) whose run loop fires a ``checkpoint_hook`` at every
generation boundary.  The runner snapshots the driver there
(``state_dict``), feeds generation wall-times to a
:class:`~repro_torch.runtime.straggler.StragglerWatchdog`, and on a device
loss rolls the driver back to the last boundary — keeping the shared
evaluation memo, whose entries are pure functions of the genome — then
rebuilds the evaluators (``probe`` -> ``rebuild``; on one card a fresh
evaluator with an empty graph cache) and re-enters the run loop.
Everything committed before the crash replays as a memo hit, so recovery
trains zero duplicate rows.  :class:`DrillConfig` carries the chaos-drill
knobs and the row telemetry.

:class:`ElasticRunner` re-meshes and restores an LM run: checkpoints hold
plain arrays and every model names its parameters' logical axes
(``parallel/sharding``), so recovery is (1) count the healthy devices, (2)
pick the largest mesh for them (:func:`choose_mesh_shape`), (3) rebuild the
shardings on a ``DeviceMesh`` of that shape, (4) restore the newest
checkpoint onto it (``CheckpointManager.restore(shardings=...)``), (5) go on
from the recorded step (the token stream is random-access).  ``drill`` runs
the loop in-process; on one card it recovers onto ``(1, 1)``.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Callable

import torch

from repro_torch.runtime.failure import DeviceLossError, FailureInjector
from repro_torch.runtime.straggler import StragglerWatchdog

__all__ = ["choose_mesh_shape", "ElasticRunner", "DrillConfig", "ElasticGARunner"]


def choose_mesh_shape(
    n_devices: int, model_parallel: int, devices_per_pod: int | None = None
) -> tuple[int, ...]:
    """Largest (pod?, data, model) mesh that fits ``n_devices``.

    Keeps the model axis fixed (TP degree is a property of the model fit —
    it must stay inside a pod's interconnect domain), shrinks data
    parallelism to the largest divisor.  A ``pod`` axis is only emitted when
    >= 2 *whole* pods survive AND the pod factoring uses at least as many
    devices as the flat one (20 devices, 8/pod, TP=2: (2, 4, 2) = 16 loses
    to flat (10, 2) = 20), as does a ``devices_per_pod`` not divisible by
    ``model_parallel``.  Whenever the chosen shape uses fewer than
    ``n_devices``, the dropped device indices are named in a warning.
    Raises if even one model-parallel group does not fit.
    """
    if n_devices < model_parallel:
        raise ValueError(
            f"need >= {model_parallel} devices for TP={model_parallel}, have {n_devices}"
        )
    shape: tuple[int, ...] = (n_devices // model_parallel, model_parallel)
    if devices_per_pod and n_devices >= 2 * devices_per_pod:
        pods = n_devices // devices_per_pod
        data_per_pod = devices_per_pod // model_parallel
        if data_per_pod >= 1:
            pod_shape = (pods, data_per_pod, model_parallel)
            if math.prod(pod_shape) >= math.prod(shape):
                shape = pod_shape
    used = math.prod(shape)
    if used != n_devices:
        warnings.warn(
            f"choose_mesh_shape: {n_devices} devices do not factor into "
            f"shape {shape}; using the first {used} and dropping devices "
            f"[{used}..{n_devices - 1}]",
            stacklevel=2,
        )
    return shape


def device_count() -> int:
    """The device pool: the ranks of this process's group, else the CUDA
    devices (one card: 1)."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size()
    return max(torch.cuda.device_count(), 1)


@dataclasses.dataclass
class ElasticRunner:
    """Wires mesh choice + checkpoint restore + step rebuild together.

    ``make_mesh(shape)`` builds the ``DeviceMesh`` (``launch.mesh.make_mesh``);
    ``make_shardings(mesh)`` gives the tree of ``Sharding`` the checkpoint is
    restored onto; ``build_step(mesh)`` the step function.  The device pool
    is :func:`device_count`."""

    ckpt: object  # checkpoint.CheckpointManager
    model_parallel: int
    make_mesh: Callable[[tuple[int, ...]], object]
    make_shardings: Callable[[object], dict]
    build_step: Callable[[object], Callable]
    devices_per_pod: int | None = None

    def recover(self, healthy_devices: int):
        shape = choose_mesh_shape(healthy_devices, self.model_parallel, self.devices_per_pod)
        mesh = self.make_mesh(shape)
        shardings = self.make_shardings(mesh)
        state, manifest = self.ckpt.restore(shardings=shardings)
        step_fn = self.build_step(mesh)
        return mesh, state, manifest["step"], step_fn

    def drill(self, state, step: int, kill_fraction: float = 0.5):
        """Failure drill: checkpoint, 'lose' devices, recover on the rest."""
        self.ckpt.save(step, state, block=True)
        healthy = max(int(device_count() * (1.0 - kill_fraction)), 1)
        return self.recover(healthy)


@dataclasses.dataclass
class DrillConfig:
    """Chaos-drill knobs + row telemetry for an elastic GA campaign.

    ``injector`` fires at evaluator-dispatch boundaries (``maybe_slow`` /
    ``maybe_fail`` keyed on the running batch ordinal); ``watchdog``
    overrides the campaign's straggler watchdog; ``lose_devices`` shrinks
    the device pool the recovery probe reports (simulating a lost device
    group in a single-process drill).  ``rows_dispatched`` counts every
    row actually sent to the evaluator across the whole campaign,
    *including* replays after a rollback — the number the chaos tests
    compare against the uninterrupted run's ``n_evaluations`` to prove
    recovery re-trains exactly the interrupted generation's unseen rows
    for the lost island and nothing else.
    """

    injector: FailureInjector | None = None
    watchdog: StragglerWatchdog | None = None
    lose_devices: int = 0
    rows_dispatched: int = 0


@dataclasses.dataclass
class ElasticGARunner:
    """Run an NSGA-II driver with boundary snapshots + device-loss recovery.

    ``driver`` is anything with the ``state_dict`` / ``set_state`` /
    ``gens_done`` protocol (``core.nsga2.NSGA2`` or ``IslandNSGA2``);
    ``run_fn(checkpoint_hook)`` enters its run loop — the indirection
    lets the caller pick ``run`` vs ``run_async`` and close over its own
    dispatch callback.  At every generation boundary the runner feeds the
    latest generation wall-time to the watchdog (a straggler event makes
    the next checkpoint urgent, an eviction re-meshes without rollback),
    snapshots the driver in memory, and invokes ``checkpoint_cb(driver,
    gens_done, urgent)`` for durable persistence.  When ``run_fn`` raises
    one of ``recover_on``, the driver rolls back to the in-memory
    boundary snapshot with ``keep_memo=True`` — objectives committed
    after the boundary are pure functions of the genome, so the replayed
    generation hits the memo for everything already trained — the
    evaluators are rebuilt on the surviving devices (``probe`` →
    ``rebuild``), and the run loop re-enters, resuming the interrupted
    generation.
    """

    driver: object
    run_fn: Callable[[Callable], dict]
    rebuild: Callable[[int | None], None] | None = None
    probe: Callable[[], int] | None = None
    watchdog: StragglerWatchdog | None = None
    checkpoint_cb: Callable[[object, int, bool], None] | None = None
    recover_on: tuple = (DeviceLossError,)
    max_recoveries: int = 8

    def __post_init__(self):
        self.recoveries: list[dict] = []
        # pre-setup boundary: a crash during generation 0 rolls back to a
        # blank engine and replays setup (committed rows hit the memo)
        self._boundary = self.driver.state_dict(include_memo=False)

    def _gen_seconds(self) -> float | None:
        hist = getattr(self.driver, "agg_history", None)
        if hist is None:
            hist = getattr(self.driver, "history", None)
        if not hist:
            return None
        return hist[-1].get("gen_s")

    def _remesh(self, reason: str, gens_done: int, error: str | None = None):
        n = self.probe() if self.probe is not None else None
        if self.rebuild is not None:
            self.rebuild(n)
        rec = {"reason": reason, "gens_done": int(gens_done), "n_devices": n}
        if error is not None:
            rec["error"] = error
        self.recoveries.append(rec)
        return rec

    def _on_boundary(self, driver, gens_done: int):
        urgent = False
        if self.watchdog is not None and gens_done > 0:
            gen_s = self._gen_seconds()
            if gen_s is not None:
                ev = self.watchdog.observe(gens_done, float(gen_s))
                if ev is not None:
                    # straggler: make the next checkpoint urgent so a
                    # subsequent eviction loses zero generations
                    urgent = True
                    if ev["evict"]:
                        self._remesh("straggler-evict", gens_done)
        self._boundary = driver.state_dict(include_memo=False)
        if self.checkpoint_cb is not None:
            self.checkpoint_cb(driver, gens_done, urgent)

    def run(self) -> dict:
        while True:
            try:
                return self.run_fn(self._on_boundary)
            except self.recover_on as e:
                losses = sum(
                    1 for r in self.recoveries if r["reason"] == "device-loss"
                )
                if losses >= self.max_recoveries:
                    raise
                self.driver.set_state(self._boundary, keep_memo=True)
                self._remesh(
                    "device-loss", self.driver.gens_done, error=str(e)
                )
