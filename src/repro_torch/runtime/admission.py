"""Per-request admission control and deadlines for the evaluation service
(port of ``repro.runtime.admission``).

The co-design service (``core.eval_service``) runs one search per client
thread, all feeding one wave scheduler.  Two runtime policies live here,
apart from the service so that a fake clock can test them and other
long-running drivers can reuse them:

* :class:`AdmissionController`: a FIFO gate bounding how many searches
  run at once (``max_active``) and how many may wait (``max_queue``).
  More concurrent searches than device wave slots only deepen each wave's
  queue without adding throughput, so the service admits about a wave's
  worth and queues the rest; beyond ``max_queue`` it sheds load loudly
  (:class:`AdmissionError`) instead of accepting work it cannot finish.
* :class:`RequestWatchdog`: per-request wall-clock deadlines.  The
  service cannot preempt a client thread mid-search (and must not: a
  killed request's engine state is garbage), so the watchdog marks
  overdue requests for the caller to observe: ``EvalService.result``
  reports a deadline error instead of blocking forever on a wedged search.

Telemetry (admitted/rejected counters, live and peak occupancy, queued
wait) feeds the service's ``stats()``.  Pure host Python, as in the
reference.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time
from typing import Callable

__all__ = [
    "AdmissionConfig",
    "AdmissionController",
    "AdmissionError",
    "RequestWatchdog",
]


class AdmissionError(RuntimeError):
    """Raised at submit time when the wait queue is already full."""


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    # how many searches may drive the wave scheduler concurrently; the
    # useful ceiling is the scheduler's wave_slots (more just queues
    # inside the coalescing window instead of here, with less telemetry)
    max_active: int = 8
    # how many submitted searches may wait for a slot before load-shedding
    max_queue: int = 64
    # per-request wall-clock deadline (None = no deadline)
    deadline_s: float | None = None


class AdmissionController:
    """FIFO admission gate with occupancy telemetry.

    :meth:`admit` blocks the calling request thread until it holds one of
    ``max_active`` slots (strict submission order — a later request can
    never overtake an earlier one just because a slot freed at a lucky
    moment); :meth:`release` frees the slot.  Rejection happens at submit
    time only, and only on queue overflow.
    """

    def __init__(
        self,
        cfg: AdmissionConfig = AdmissionConfig(),
        clock: Callable[[], float] = time.monotonic,
    ):
        if cfg.max_active < 1:
            raise ValueError(f"max_active must be >= 1, got {cfg.max_active}")
        if cfg.max_queue < 0:
            raise ValueError(f"max_queue must be >= 0, got {cfg.max_queue}")
        self.cfg = cfg
        self._clock = clock
        self._cond = threading.Condition()
        self._waiting: collections.deque[int] = collections.deque()
        self._tickets = itertools.count()
        self.active = 0
        self.n_admitted = 0
        self.n_rejected = 0
        self.peak_active = 0
        self.peak_queued = 0
        self.total_wait_s = 0.0

    def admit(self, request_id: str = "") -> float:
        """Block until admitted (FIFO); returns seconds spent queued."""
        t0 = self._clock()
        with self._cond:
            if len(self._waiting) >= self.cfg.max_queue and (
                self._waiting or self.active >= self.cfg.max_active
            ):
                self.n_rejected += 1
                raise AdmissionError(
                    f"request {request_id!r} rejected: {self.active} active, "
                    f"{len(self._waiting)} queued (max_queue="
                    f"{self.cfg.max_queue})"
                )
            ticket = next(self._tickets)
            self._waiting.append(ticket)
            self.peak_queued = max(self.peak_queued, len(self._waiting))
            while not (
                self._waiting[0] == ticket and self.active < self.cfg.max_active
            ):
                self._cond.wait()
            self._waiting.popleft()
            self.active += 1
            self.n_admitted += 1
            self.peak_active = max(self.peak_active, self.active)
            waited = self._clock() - t0
            self.total_wait_s += waited
            self._cond.notify_all()
        return waited

    def release(self) -> None:
        """Free one admitted slot and wake the queue head."""
        with self._cond:
            if self.active <= 0:
                raise RuntimeError("release() without a matching admit()")
            self.active -= 1
            self._cond.notify_all()

    @property
    def queued(self) -> int:
        with self._cond:
            return len(self._waiting)

    def stats(self) -> dict:
        with self._cond:
            return {
                "active": self.active,
                "queued": len(self._waiting),
                "n_admitted": self.n_admitted,
                "n_rejected": self.n_rejected,
                "peak_active": self.peak_active,
                "peak_queued": self.peak_queued,
                "total_wait_s": round(self.total_wait_s, 6),
            }


class RequestWatchdog:
    """Per-request wall-clock deadlines, observed (not enforced) here.

    ``start``/``finish`` bracket a request's lifetime; :meth:`expired`
    lists live requests past ``deadline_s``.  A fake ``clock`` makes the
    policy testable without sleeping.
    """

    def __init__(
        self,
        deadline_s: float | None = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.deadline_s = deadline_s
        self._clock = clock
        self._lock = threading.Lock()
        self._started: dict[str, float] = {}
        self.n_expired = 0

    def start(self, request_id: str) -> None:
        with self._lock:
            self._started[request_id] = self._clock()

    def finish(self, request_id: str) -> float:
        """Stop tracking; returns the request's elapsed seconds."""
        with self._lock:
            t0 = self._started.pop(request_id, None)
        return 0.0 if t0 is None else self._clock() - t0

    def elapsed(self, request_id: str) -> float | None:
        with self._lock:
            t0 = self._started.get(request_id)
        return None if t0 is None else self._clock() - t0

    def remaining(self, request_id: str) -> float | None:
        """Seconds until this request's deadline (None = no deadline)."""
        if self.deadline_s is None:
            return None
        elapsed = self.elapsed(request_id)
        return None if elapsed is None else self.deadline_s - elapsed

    def expired(self) -> list[str]:
        """Live requests past their deadline (start order preserved)."""
        if self.deadline_s is None:
            return []
        now = self._clock()
        with self._lock:
            out = [
                rid
                for rid, t0 in self._started.items()
                if now - t0 > self.deadline_s
            ]
        self.n_expired = max(self.n_expired, len(out))
        return out
