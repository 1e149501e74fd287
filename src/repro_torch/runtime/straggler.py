"""Straggler mitigation: per-step deadline watchdog + slow-host report (port of
``repro.runtime.straggler``).

The watchdog tracks a robust (median + MAD) envelope of step (here:
generation) times; a time breaching ``deadline_sigmas`` flags its host.
``runtime.elastic.ElasticGARunner`` feeds it each generation's wall time
and acts on its events:

* **micro-checkpoint** — a flagged generation makes the next checkpoint
  urgent, so a subsequent eviction loses no generation;
* **evict** — after ``evict_after`` consecutive flags the runner rebuilds
  the evaluators (on one card: a fresh evaluator and graph cache).
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict, deque


@dataclasses.dataclass
class StragglerWatchdog:
    window: int = 50
    deadline_sigmas: float = 5.0
    evict_after: int = 3
    readmit_after: int = 8

    def __post_init__(self):
        self._times: deque[float] = deque(maxlen=self.window)
        self._flags: dict[int, int] = defaultdict(int)
        self._suspects: dict[int, list[float]] = defaultdict(list)
        self.events: list[dict] = []

    def observe(self, step: int, seconds: float, host: int = 0) -> dict | None:
        """Record a step time; returns an event dict if the step straggled."""
        if len(self._times) >= 8:
            med = _median(self._times)
            mad = _median([abs(t - med) for t in self._times]) + 1e-9
            if seconds > med + self.deadline_sigmas * 1.4826 * mad and seconds > 1.5 * med:
                self._flags[host] += 1
                self._suspects[host].append(seconds)
                readmitted = False
                if len(self._suspects[host]) >= self.readmit_after:
                    # A long run of "slow" steps is a regime change (larger
                    # population, slower interconnect), not a straggler.
                    # Flagged times previously never entered the envelope, so
                    # the stale median flagged every step forever and evicted
                    # the host.  Re-admit the suspect window into ``_times``
                    # (the maxlen deque decays the old regime) and reset.
                    self._times.extend(self._suspects[host])
                    self._suspects[host].clear()
                    self._flags[host] = 0
                    readmitted = True
                ev = {
                    "step": step,
                    "host": host,
                    "seconds": seconds,
                    "median": med,
                    "consecutive": self._flags[host],
                    "evict": self._flags[host] >= self.evict_after,
                    "checkpoint_now": True,
                    "readmitted": readmitted,
                }
                self.events.append(ev)
                return ev
        self._flags[host] = 0
        self._suspects[host].clear()
        self._times.append(seconds)
        return None

    def healthy(self, host: int = 0) -> bool:
        return self._flags[host] < self.evict_after


def _median(xs) -> float:
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])
