"""Co-design as a service: concurrent searches, one memo, one device wave
(port of ``repro.core.eval_service``).

A long-running evaluation service: many clients submit co-design searches
at once, every search reads and feeds the SAME fingerprint-keyed
persistent memo (``core.memo_store``), and the unseen genomes of
*different requests* are coalesced into one stacked device wave.
Concurrent requests are islands that never migrate, so
``core.trainer.make_island_evaluator`` already trains them as one
population call (on the card, replays of each bucket's CUDA graphs).

Three layers, composed by :class:`EvalService`:

* :class:`SharedMemo`: the cross-request cache.  A thread-safe
  genome-bytes -> objective table, optionally loaded from and periodically
  saved to a ``core.memo_store`` checkpoint
  (:class:`~repro_torch.core.memo_store.MemoAutosaver`).  Only *settled*
  rows live here: objectives are pure functions of the genome, so an
  entry is valid for every request with the same fingerprint, forever.
* :class:`WaveScheduler`: the coalescing device loop.  Client threads
  :meth:`~WaveScheduler.submit` their unseen-genome batches and block on
  the returned resolve; a single scheduler thread collects up to
  ``wave_slots`` batches within a ``coalesce_s`` window, dedupes the rows
  against the shared table AND across the wave (a genome born in two
  requests trains exactly once), runs the survivors as one stacked
  program, commits the results to the shared table, and answers every
  batch in full.  One wave in flight at a time: the device is the serial
  resource, and a wave's static buffers are not touched again before its
  results are read.  The scheduler thread is the only thread that trains,
  so it alone captures and replays graphs and launches K2/K3.
* :class:`EvalService`: request lifecycle.  Each submitted
  :class:`SearchRequest` runs a private ``NSGA2`` engine on its own
  thread (``run_async``, with :meth:`WaveScheduler.submit` as its
  dispatch callback), gated by ``runtime.admission`` (FIFO ``max_active``
  slots, a bounded queue, a per-request deadline watchdog).  A request's
  surrogate screen (``screen_factory``) fits on the card from its own
  thread, while the scheduler may be capturing a graph: see
  ``core.trainer`` for why the two coexist.

Bit-for-bit coalescing argument.  Each request's engine plans and commits
against an engine-LOCAL memo seeded from a snapshot of the shared table
at admission (or an explicit ``SearchRequest.memo``), never against the
live shared dict.  The engine therefore consumes its RNG stream, plans
its unseen rows, writes its memo (in plan order), and settles its
``n_evaluations``/``n_memo_hits`` counters exactly as a solo run against
that same starting memo would: nothing another request does can change
*which* rows this engine considers unseen, and the objectives themselves
are pure functions of the genome (its training seed is derived from the
genome bytes, and a row's result does not depend on the rows beside it),
so it does not matter *where* a row's number came from: this request's
wave slot, another request's, or the shared table.  Cross-request sharing
lives entirely below the engine, in the scheduler: rows answered from the
shared table or deduped within a wave save device time (service-level
telemetry) without perturbing any request's search.  This is also why a
request dying mid-wave cannot corrupt anyone else: its engine memo is
private, and the shared table only ever receives settled rows, never
partial engine state.  ``tests/test_torch_eval_service.py`` holds all of
this against the reference's service.
"""

from __future__ import annotations

import dataclasses
import itertools
import queue as queue_mod
import threading
import time
from typing import Callable, Sequence

import numpy as np

from repro_torch.core import evalpipe, memo_store, nsga2
from repro_torch.runtime import admission as admission_rt
from repro_torch.runtime import failure as failure_rt

__all__ = [
    "ServiceConfig",
    "SearchRequest",
    "SearchResult",
    "SharedMemo",
    "WaveScheduler",
    "EvalService",
]


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    # device wave shape: how many request batches one stacked program
    # carries (the num_islands of the underlying island evaluator)
    wave_slots: int = 4
    # how long the scheduler holds an under-full wave open for more
    # requests to coalesce into it; latency floor vs. wave occupancy
    coalesce_s: float = 0.005
    admission: admission_rt.AdmissionConfig = admission_rt.AdmissionConfig()
    # persistent shared memo: loaded (fingerprint-verified) at startup
    # when present, saved at most every persist_every_s seconds as waves
    # commit, and flushed on close.  None = in-memory only.
    memo_path: str | None = None
    persist_every_s: float = 30.0
    # ceiling on how long a client blocks on one wave before erroring out
    # (None = forever; the deadline watchdog is the coarser guard)
    resolve_timeout_s: float | None = None


@dataclasses.dataclass
class SearchRequest:
    """One client's co-design search."""

    request_id: str
    ga: nsga2.NSGA2Config
    # explicit starting memo for the engine-local cache; None snapshots
    # the shared table at admission time (the normal service path)
    memo: dict[bytes, np.ndarray] | None = None
    # chaos tap: fires at every dispatch boundary of THIS request's
    # engine, exactly like CodesignConfig.drill taps campaign dispatches
    injector: "failure_rt.FailureInjector | None" = None


@dataclasses.dataclass
class SearchResult:
    request_id: str
    result: dict | None = None  # NSGA2.result() payload
    n_evaluations: int = 0
    n_memo_hits: int = 0
    n_deferred: int = 0  # rows answered by the request's screen stage
    # engine-local memo insertion order — the bit-for-bit witness the
    # concurrency tests compare against a solo run's
    memo_keys: list[bytes] | None = None
    latency_s: float = 0.0  # admit -> result, queue wait excluded
    queue_wait_s: float = 0.0
    error: BaseException | None = None

    @property
    def ok(self) -> bool:
        return self.error is None


class SharedMemo:
    """Thread-safe cross-request genome->objective table with persistence.

    The service-level twin of the engine-local memo dict: one lock guards
    the table and its counters, entries are only ever *added* (pure
    function of the genome — there is nothing to invalidate), and every
    read path (:meth:`snapshot`, :meth:`plan`) sees a consistent state.
    ``n_hits`` and ``n_coalesced`` count rows of device time saved across
    requests — distinct from the per-engine counters, which are a
    property of each search alone.
    """

    def __init__(
        self,
        fingerprint: dict | None = None,
        path: str | None = None,
        persist_every_s: float = 30.0,
    ):
        self.fingerprint = fingerprint
        self.lock = threading.RLock()
        self._table: dict[bytes, np.ndarray] = {}
        self.n_rows_requested = 0  # rows reaching the scheduler
        self.n_hits = 0  # rows answered from the table
        self.n_coalesced = 0  # rows deduped within a wave
        self.n_trained = 0  # rows actually sent to the device
        self._autosaver: memo_store.MemoAutosaver | None = None
        if path is not None:
            if memo_store.memo_path_exists(path):
                self._table.update(memo_store.load_memo(path, fingerprint))
            self._autosaver = memo_store.MemoAutosaver(
                path, fingerprint, every_s=persist_every_s
            )

    def __len__(self) -> int:
        with self.lock:
            return len(self._table)

    def snapshot(self) -> dict[bytes, np.ndarray]:
        """A consistent copy of the table (request-admission seeding)."""
        with self.lock:
            return dict(self._table)

    def plan(
        self, keys_per_batch: list[list[bytes]]
    ) -> tuple[dict[bytes, np.ndarray], dict[bytes, tuple[int, int]]]:
        """Split one wave's rows into table hits and first-seen rows.

        Walks the wave's batches in arrival order under ONE lock hold and
        returns ``(hits, owned)``: objective vectors for every key already
        in the table, and ``key -> (batch_index, row_index)`` for the
        first occurrence of each unseen key — the rows the wave trains.
        Later occurrences of an owned key (a genome born in two requests
        this wave) are counted as coalesced and train nothing.

        The dedupe walk itself is ``core.evalpipe.plan_rows`` — the
        wave-level plan is the island drivers' claimed-set schedule with
        ``owned`` as the claimed set, batch index attached.
        """
        hits: dict[bytes, np.ndarray] = {}
        owned: dict[bytes, tuple[int, int]] = {}
        with self.lock:
            for bi, keys in enumerate(keys_per_batch):
                self.n_rows_requested += len(keys)
                unseen = evalpipe.plan_rows(self._table, keys, claimed=owned)
                for k, ri in unseen.items():
                    owned[k] = (bi, ri)
                n_hit = 0
                for k in keys:
                    if k in self._table:
                        hits[k] = self._table[k]
                        n_hit += 1
                self.n_hits += n_hit
                # everything neither answered from the table nor owned
                # first-seen is a duplicate deduped within the wave
                self.n_coalesced += len(keys) - n_hit - len(unseen)
        return hits, owned

    def commit(self, results: dict[bytes, np.ndarray]) -> None:
        """Add one wave's settled rows; periodically persist."""
        with self.lock:
            self._table.update(results)
            self.n_trained += len(results)
        if self._autosaver is not None and results:
            self._autosaver.poke(self._table, self.lock)

    def flush(self) -> str | None:
        """Persist unconditionally (service shutdown)."""
        if self._autosaver is None:
            return None
        return self._autosaver.flush(self._table, self.lock)

    def hit_rate(self) -> float:
        """Fraction of requested rows that cost no device time."""
        with self.lock:
            saved = self.n_hits + self.n_coalesced
            return saved / self.n_rows_requested if self.n_rows_requested else 0.0

    def stats(self) -> dict:
        with self.lock:
            return {
                "entries": len(self._table),
                "rows_requested": self.n_rows_requested,
                "hits": self.n_hits,
                "coalesced": self.n_coalesced,
                "trained": self.n_trained,
                "n_saves": (
                    self._autosaver.n_saves if self._autosaver is not None else 0
                ),
            }


class _Pending:
    """One submitted batch: request thread blocks, scheduler answers."""

    __slots__ = ("masks", "cats", "keys", "event", "objs", "error")

    def __init__(self, masks: np.ndarray, cats: np.ndarray):
        self.masks = np.asarray(masks, bool)
        self.cats = np.asarray(cats, np.int64)
        self.keys = nsga2.genome_keys(self.masks, self.cats)
        self.event = threading.Event()
        self.objs: np.ndarray | None = None
        self.error: BaseException | None = None


class WaveScheduler:
    """Coalesce concurrent requests' batches into stacked device waves.

    ``stacked_evaluate`` is the island-evaluator contract
    (``core.trainer.make_island_evaluator``): a list of exactly
    ``wave_slots`` ``(masks, cats)`` batches, zero-row batches allowed,
    one ``(B_i, M)`` objective array (or falsy) back per slot.  One
    scheduler thread owns the whole plan -> train -> commit -> distribute
    cycle, so waves serialise and the shared table needs no cross-wave
    claim set: a wave's rows are committed before the next wave plans.
    """

    def __init__(
        self,
        stacked_evaluate: Callable[
            [list[tuple[np.ndarray, np.ndarray]]], list[np.ndarray | None]
        ],
        shared: SharedMemo,
        wave_slots: int = 4,
        coalesce_s: float = 0.005,
        resolve_timeout_s: float | None = None,
    ):
        if wave_slots < 1:
            raise ValueError(f"wave_slots must be >= 1, got {wave_slots}")
        self._stacked_evaluate = stacked_evaluate
        self._shared = shared
        self.wave_slots = wave_slots
        self.coalesce_s = float(coalesce_s)
        self.resolve_timeout_s = resolve_timeout_s
        self._queue: queue_mod.SimpleQueue[_Pending] = queue_mod.SimpleQueue()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.waves: list[dict] = []  # per-wave telemetry records

    # -- client side ---------------------------------------------------------

    def submit(
        self, masks: np.ndarray, cats: np.ndarray
    ) -> Callable[[], np.ndarray]:
        """Enqueue one batch; returns a blocking zero-arg resolve().

        Exactly the ``dispatch_evaluate`` contract of
        :meth:`NSGA2.dispatch_pool` / :meth:`NSGA2.run_async`: the batch
        is in the next wave's hands NOW, the caller blocks only when it
        resolves — which is what lets many request threads' batches pile
        into one wave while each engine sits at its own commit point.
        """
        if self._stop.is_set():
            raise RuntimeError("WaveScheduler is stopped")
        pending = _Pending(masks, cats)
        self._queue.put(pending)

        def resolve() -> np.ndarray:
            if not pending.event.wait(self.resolve_timeout_s):
                raise TimeoutError(
                    f"wave result not ready within {self.resolve_timeout_s}s"
                )
            if pending.error is not None:
                raise pending.error
            return pending.objs

        return resolve

    # -- scheduler thread ----------------------------------------------------

    def start(self) -> "WaveScheduler":
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="wave-scheduler", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        """Drain the queue, run the final waves, and join the thread."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def __enter__(self) -> "WaveScheduler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _loop(self) -> None:
        while not (self._stop.is_set() and self._queue.empty()):
            try:
                first = self._queue.get(timeout=0.02)
            except queue_mod.Empty:
                continue
            batch = [first]
            deadline = time.perf_counter() + self.coalesce_s
            while len(batch) < self.wave_slots:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._queue.get(timeout=remaining))
                except queue_mod.Empty:
                    break
            self._run_wave(batch)

    def _run_wave(self, pendings: list[_Pending]) -> None:
        t0 = time.perf_counter()
        try:
            hits, owned = self._shared.plan([p.keys for p in pendings])
            # assemble one slot batch per request (scheduler = islands
            # that never migrate); unused slots ship zero rows, which the
            # island evaluator pads with filler
            per_slot_rows: list[list[int]] = [[] for _ in pendings]
            for bi, ri in owned.values():
                per_slot_rows[bi].append(ri)
            n_mask_bits = pendings[0].masks.shape[1]
            n_cat = pendings[0].cats.shape[1]
            batches: list[tuple[np.ndarray, np.ndarray]] = []
            for p, rows in zip(pendings, per_slot_rows):
                idx = np.asarray(sorted(rows), dtype=np.int64)
                batches.append((p.masks[idx], p.cats[idx]))
            while len(batches) < self.wave_slots:
                batches.append(
                    (
                        np.zeros((0, n_mask_bits), bool),
                        np.zeros((0, n_cat), np.int64),
                    )
                )
            trained: dict[bytes, np.ndarray] = {}
            if owned:
                objs = self._stacked_evaluate(batches)
                for p, rows, o in zip(pendings, per_slot_rows, objs):
                    if not rows:
                        continue
                    o = np.asarray(o, np.float64)
                    for j, ri in enumerate(sorted(rows)):
                        trained[p.keys[ri]] = o[j]
                self._shared.commit(trained)
            # answer every batch in full, row order preserved (the
            # pipeline's commit-stage gather: table hits first, this
            # wave's freshly-trained rows as the fallback)
            for p in pendings:
                p.objs = (
                    evalpipe.gather_rows(p.keys, hits, trained)
                    if p.keys
                    else np.zeros((0, 0), np.float64)
                )
                p.event.set()
            self.waves.append(
                {
                    "n_requests": len(pendings),
                    "rows": sum(len(p.keys) for p in pendings),
                    "trained": len(trained),
                    "hits": len(hits),
                    "coalesced": sum(len(p.keys) for p in pendings)
                    - len(trained)
                    - len(hits),
                    "wave_s": round(time.perf_counter() - t0, 6),
                    "queue_depth": self._queue.qsize(),
                }
            )
        except BaseException as e:  # noqa: BLE001 — the wave must answer
            # a failed wave fails its own requests, never the service:
            # nothing was committed to the shared table unless the whole
            # stacked program finished, so other requests' views are clean
            for p in pendings:
                if not p.event.is_set():
                    p.error = e
                    p.event.set()

    def stats(self) -> dict:
        waves = list(self.waves)
        rows = sum(w["rows"] for w in waves)
        return {
            "n_waves": len(waves),
            "rows": rows,
            "trained": sum(w["trained"] for w in waves),
            "mean_occupancy": (
                sum(w["n_requests"] for w in waves) / len(waves) if waves else 0.0
            ),
            "peak_queue_depth": max((w["queue_depth"] for w in waves), default=0),
        }


class EvalService:
    """The long-running co-design evaluation service.

    ``stacked_evaluate`` + genome shape come from a backend builder —
    ``core.codesign.make_service_backend`` for the real QAT objective, or
    any analytic stand-in honouring the island-evaluator contract (the
    tests').  All requests served by one instance share the backend's
    fingerprint; a request built for a different search configuration
    must go to a different service (or the cached objectives would be
    silently wrong — same rule ``memo_store.load_memo`` enforces on
    disk).
    """

    def __init__(
        self,
        stacked_evaluate: Callable[
            [list[tuple[np.ndarray, np.ndarray]]], list[np.ndarray | None]
        ],
        n_mask_bits: int,
        cat_cardinalities: Sequence[int] = (),
        cfg: ServiceConfig = ServiceConfig(),
        fingerprint: dict | None = None,
        screen_factory: Callable[[], "evalpipe.ScreenStage"] | None = None,
    ):
        """``screen_factory`` (optional) builds a fresh surrogate screen
        stage per request — engine-LOCAL, like the memo snapshot, so one
        request's screen state never leaks into another's search
        (``core.codesign.make_service_backend`` supplies it when
        ``CodesignConfig.surrogate`` is on).
        """
        self.cfg = cfg
        self.n_mask_bits = int(n_mask_bits)
        self.cat_cardinalities = tuple(cat_cardinalities)
        self.screen_factory = screen_factory
        self.shared = SharedMemo(
            fingerprint, cfg.memo_path, cfg.persist_every_s
        )
        self.scheduler = WaveScheduler(
            stacked_evaluate,
            self.shared,
            wave_slots=cfg.wave_slots,
            coalesce_s=cfg.coalesce_s,
            resolve_timeout_s=cfg.resolve_timeout_s,
        )
        self.admission = admission_rt.AdmissionController(cfg.admission)
        self.watchdog = admission_rt.RequestWatchdog(cfg.admission.deadline_s)
        self._lock = threading.Lock()
        self._threads: dict[str, threading.Thread] = {}
        self._results: dict[str, SearchResult] = {}
        self._started = False

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "EvalService":
        self.scheduler.start()
        self._started = True
        return self

    def close(self) -> None:
        """Wait for in-flight requests, stop the scheduler, persist."""
        for t in list(self._threads.values()):
            t.join()
        self.scheduler.stop()
        self.shared.flush()
        self._started = False

    def __enter__(self) -> "EvalService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- request lifecycle ---------------------------------------------------

    def submit(self, req: SearchRequest) -> str:
        """Validate + launch one search on its own thread (non-blocking).

        Shape/config validation happens HERE, synchronously, so a
        malformed request fails loudly at the submission site; admission
        queueing happens on the request thread, so a full service delays
        rather than blocks the submitter.
        """
        if not self._started:
            raise RuntimeError("EvalService not started (use `with service:`)")
        if not req.ga.memoize:
            raise ValueError(
                f"request {req.request_id!r}: the service is a memo cache; "
                "memoize=False searches belong on a dedicated campaign"
            )
        with self._lock:
            if req.request_id in self._threads:
                raise ValueError(f"duplicate request_id {req.request_id!r}")
            t = threading.Thread(
                target=self._serve,
                args=(req,),
                name=f"request-{req.request_id}",
                daemon=True,
            )
            self._threads[req.request_id] = t
        t.start()
        return req.request_id

    def _serve(self, req: SearchRequest) -> None:
        res = SearchResult(request_id=req.request_id)
        admitted = False
        try:
            res.queue_wait_s = self.admission.admit(req.request_id)
            admitted = True
            self.watchdog.start(req.request_id)
            t0 = time.perf_counter()
            start_memo = (
                req.memo if req.memo is not None else self.shared.snapshot()
            )
            engine = nsga2.NSGA2(
                self.n_mask_bits,
                self.cat_cardinalities,
                evaluate=self._no_sync_evaluate,
                cfg=req.ga,
                memo=start_memo,
                screen=(
                    self.screen_factory()
                    if self.screen_factory is not None
                    else None
                ),
            )
            out = engine.run_async(self._make_dispatch(req))
            res.result = out
            res.n_evaluations = engine.n_evaluations
            res.n_memo_hits = engine.n_memo_hits
            res.n_deferred = engine.n_deferred
            res.memo_keys = list(engine.memo)
            res.latency_s = time.perf_counter() - t0
        except BaseException as e:  # noqa: BLE001 — errors belong to the result
            res.error = e
        finally:
            if admitted:
                self.watchdog.finish(req.request_id)
                self.admission.release()
            with self._lock:
                self._results[req.request_id] = res

    def _make_dispatch(self, req: SearchRequest):
        """The per-request client of the shared wave scheduler."""
        steps = itertools.count()

        def dispatch_evaluate(masks, cats):
            if req.injector is not None:
                step = next(steps)
                req.injector.maybe_slow(step)
                req.injector.maybe_fail(step)
            return self.scheduler.submit(masks, cats)

        return dispatch_evaluate

    @staticmethod
    def _no_sync_evaluate(masks, cats):
        raise RuntimeError(
            "service engines evaluate through the wave scheduler only; "
            "the synchronous callback must never fire"
        )

    def result(self, request_id: str, timeout: float | None = None) -> SearchResult:
        """Join one request and return its result (or error) record.

        A request past its admission deadline while still running is
        reported as a deadline error — the thread itself is left to
        finish in the background (client threads cannot be preempted; the
        watchdog observes, the caller decides).
        """
        with self._lock:
            t = self._threads.get(request_id)
        if t is None:
            raise KeyError(f"unknown request_id {request_id!r}")
        t.join(timeout)
        if t.is_alive():
            if request_id in self.watchdog.expired():
                return SearchResult(
                    request_id=request_id,
                    error=TimeoutError(
                        f"request {request_id!r} exceeded its "
                        f"{self.watchdog.deadline_s}s deadline"
                    ),
                )
            raise TimeoutError(
                f"request {request_id!r} still running after {timeout}s"
            )
        with self._lock:
            return self._results[request_id]

    def run_all(self, requests: list[SearchRequest]) -> list[SearchResult]:
        """Submit a batch of requests and collect every result, in order."""
        for req in requests:
            self.submit(req)
        return [self.result(req.request_id) for req in requests]

    # -- telemetry -----------------------------------------------------------

    def stats(self) -> dict:
        return {
            "shared_memo": self.shared.stats(),
            "hit_rate": round(self.shared.hit_rate(), 6),
            "admission": self.admission.stats(),
            "waves": self.scheduler.stats(),
        }
