"""Elastic GA campaigns: boundary snapshots, rollback and recovery (port of the GA half
of ``repro.runtime.elastic``).

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

The LM half of the reference's module (``ElasticRunner``,
``choose_mesh_shape``) waits for ROADMAP Queue 1 item 14.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.runtime.failure import DeviceLossError, FailureInjector
from repro_torch.runtime.straggler import StragglerWatchdog

__all__ = ["DrillConfig", "ElasticGARunner"]


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
