"""The port's evaluation service against the reference's.

Admission, the shared memo, the wave scheduler and the service are host
Python in both packages, and the GA engines are NumPy, so under one
analytic objective (a pure NumPy function of the genome) the port's
service must equal the reference's bit for bit: every request's front,
memo insertion order and counters, the waves' coalescing, the admission
telemetry under a fake clock.  The bit-for-bit coalescing argument of
``core.eval_service`` is held too: concurrent searches equal their solo
runs against the same starting memo, a duplicate trains nothing, a
genome born twice trains once, a request or a wave that dies leaves the
others intact.

The QAT backend (``codesign.make_service_backend``) is held against the
reference's on the CPU from the reference's draws (the port's
``trainer.draw_rows`` patched to them, ``test_torch_genome_axes``'s
method), the reference's island evaluator replaced by its unsharded row
program (its sharded one fails under JAX 0.9.0): at 30 steps the two
trainers agree bit for bit (``test_torch_genome_axes`` holds them exact at
40), so the backends' objectives and the two services' results are
compared with ``np.array_equal``.  Memo files written by either service
load in the other package.
"""

import dataclasses
import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import codesign as jcodesign  # noqa: E402
from repro.core import eval_service as jeval_service  # noqa: E402
from repro.core import evalpipe as jevalpipe  # noqa: E402
from repro.core import memo_store as jmemo_store  # noqa: E402
from repro.core import nsga2 as jnsga2  # noqa: E402
from repro.core import qat as jqat  # noqa: E402
from repro.core import trainer as jtrainer  # noqa: E402
from repro.launch import codesign_serve as jcodesign_serve  # noqa: E402
from repro.runtime import admission as jadmission  # noqa: E402
from repro.runtime import failure as jfailure  # noqa: E402
from repro_torch.core import (  # noqa: E402
    codesign,
    eval_service,
    evalpipe,
    memo_store,
    nsga2,
    trainer,
)
from repro_torch.launch import codesign_serve  # noqa: E402
from repro_torch.runtime import admission, failure  # noqa: E402

N_BITS = 12
CATS = (3, 2)

# each package's modules, so one test body drives either service
PORT = dict(svc=eval_service, nsga2=nsga2, adm=admission, fail=failure, pipe=evalpipe)
REF = dict(svc=jeval_service, nsga2=jnsga2, adm=jadmission, fail=jfailure, pipe=jevalpipe)
PACKAGES = {"port": PORT, "ref": REF}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are tiny, and the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _objective(masks, cats):
    """Analytic two-objective stand-in: a pure function of the genome."""
    masks = np.asarray(masks, bool)
    bits = masks.sum(axis=1).astype(np.float64)
    cat0 = np.asarray(cats, np.int64)[:, 0].astype(np.float64)
    return np.stack([bits + cat0, masks.shape[1] - bits], axis=1)


def _stacked(batches):
    """The island-evaluator contract over the analytic objective."""
    return [_objective(m, c) if np.shape(m)[0] else None for m, c in batches]


def _slow_stacked(delay_s):
    """A stacked evaluate slow enough that request threads really overlap."""

    def f(batches):
        time.sleep(delay_s)
        return _stacked(batches)

    return f


def _ga(pkg, seed=0, pop=6, gens=4, **kw):
    return pkg["nsga2"].NSGA2Config(pop_size=pop, n_generations=gens, seed=seed, **kw)


def _service(pkg, stacked=_stacked, screen_factory=None, **cfg_kw):
    cfg_kw.setdefault("wave_slots", 3)
    cfg_kw.setdefault("coalesce_s", 0.02)
    return pkg["svc"].EvalService(stacked, N_BITS, CATS,
                                  cfg=pkg["svc"].ServiceConfig(**cfg_kw),
                                  screen_factory=screen_factory)


def _solo(pkg, seed, memo=None, pop=6, gens=4, screen=None):
    """The same search run alone against ``memo``."""
    eng = pkg["nsga2"].NSGA2(N_BITS, CATS, _objective, _ga(pkg, seed, pop, gens), memo=memo,
                             screen=screen)
    return eng, eng.run()


def _key_to_genome(key: bytes):
    masks = np.frombuffer(key[:N_BITS], np.uint8).astype(bool)[None]
    cats = np.frombuffer(key[N_BITS:], np.int64).reshape(1, len(CATS))
    return masks, cats


def _witness(res) -> dict:
    """What two runs of one request must agree on, times aside."""
    assert res.ok, res.error
    out = res.result
    return {"objs": out["objs"], "masks": out["masks"], "cats": out["cats"],
            "memo_keys": res.memo_keys, "n_evaluations": res.n_evaluations,
            "n_memo_hits": res.n_memo_hits, "n_deferred": res.n_deferred,
            "n_evals": [r["n_evals"] for r in out["history"]]}


def _assert_same(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert np.array_equal(got[k], want[k]), k
        else:
            assert got[k] == want[k], k


def _solo_witness(eng, out) -> dict:
    return {"objs": out["objs"], "masks": out["masks"], "cats": out["cats"],
            "memo_keys": list(eng.memo), "n_evaluations": out["n_evaluations"],
            "n_memo_hits": out["n_memo_hits"], "n_deferred": out["n_deferred"],
            "n_evals": [r["n_evals"] for r in out["history"]]}


# -- admission ---------------------------------------------------------------------


class _Clock:
    """A fake clock that advances by ``tick`` every time it is read."""

    def __init__(self, tick=0.25):
        self.t, self.tick = 0.0, tick

    def __call__(self):
        self.t += self.tick
        return self.t


def _admission_trace(adm, max_active, max_queue):
    """One single-threaded admit/release/reject sequence: waits, errors and stats."""
    ctrl = adm.AdmissionController(adm.AdmissionConfig(max_active=max_active,
                                                       max_queue=max_queue), clock=_Clock())
    trace = []
    for i in range(max_active + 2):
        if ctrl.active < max_active:
            trace.append(("admit", ctrl.admit(f"r{i}")))
        else:
            try:
                ctrl.admit(f"r{i}")
                trace.append(("admit-unexpected",))
            except adm.AdmissionError as e:
                trace.append(("rejected", str(e)))
        trace.append(("stats", ctrl.stats()))
    for _ in range(ctrl.active):
        ctrl.release()
        trace.append(("release", ctrl.stats(), ctrl.queued))
    try:
        ctrl.release()
    except RuntimeError as e:
        trace.append(("unmatched", str(e)))
    trace.append(("again", ctrl.admit("late"), ctrl.stats()))
    return trace


@pytest.mark.parametrize("max_active,max_queue", [(1, 0), (2, 0), (3, 0)])
def test_admission_sequence_equals_reference(max_active, max_queue):
    assert _admission_trace(admission, max_active, max_queue) == _admission_trace(
        jadmission, max_active, max_queue)


@pytest.mark.parametrize("cfg", [dict(max_active=0), dict(max_queue=-1)])
def test_admission_refuses_what_the_reference_refuses(cfg):
    msgs = []
    for adm in (admission, jadmission):
        with pytest.raises(ValueError) as e:
            adm.AdmissionController(adm.AdmissionConfig(**cfg))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _watchdog_trace(adm, deadline):
    now = {"t": 0.0}
    wd = adm.RequestWatchdog(deadline_s=deadline, clock=lambda: now["t"])
    trace = []
    for t, op, rid in [(0.0, "start", "a"), (5.0, "start", "b"), (6.0, "expired", None),
                       (6.0, "remaining", "a"), (11.0, "expired", None),
                       (11.0, "elapsed", "b"), (11.0, "finish", "a"), (12.0, "expired", None),
                       (16.0, "expired", None), (16.0, "finish", "b"), (16.0, "finish", "b"),
                       (20.0, "remaining", "zz")]:
        now["t"] = t
        trace.append((op, getattr(wd, op)(rid) if rid else getattr(wd, op)()))
    return trace + [("n_expired", wd.n_expired)]


@pytest.mark.parametrize("deadline", [None, 10.0])
def test_watchdog_with_fake_clock_equals_reference(deadline):
    got, want = _watchdog_trace(admission, deadline), _watchdog_trace(jadmission, deadline)
    assert got == want
    if deadline is not None:
        assert ("expired", ["a"]) in got and ("expired", ["b"]) in got


def test_admission_is_fifo_under_contention():
    """Waiters are admitted in strict submission order (the port's controller)."""
    ctrl = admission.AdmissionController(admission.AdmissionConfig(max_active=1, max_queue=8))
    order: list[int] = []
    ctrl.admit("holder")
    threads = []
    for i in range(4):
        t = threading.Thread(target=lambda i=i: (ctrl.admit(f"w{i}"), order.append(i),
                                                 ctrl.release()))
        threads.append(t)
        t.start()
        deadline = time.monotonic() + 10
        while ctrl.queued < i + 1 and time.monotonic() < deadline:
            time.sleep(0.001)
        assert ctrl.queued == i + 1
    ctrl.release()
    for t in threads:
        t.join(10)
        assert not t.is_alive()
    assert order == [0, 1, 2, 3]
    assert ctrl.stats()["peak_queued"] == 4 and ctrl.stats()["n_admitted"] == 5


# -- the shared memo ------------------------------------------------------------


def _key_batches(seed, n_batches=4):
    rng = np.random.default_rng(seed)
    pool = [rng.bytes(9) for _ in range(20)]
    return [[pool[i] for i in rng.integers(0, len(pool), rng.integers(0, 9))]
            for _ in range(n_batches)], pool


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_shared_memo_plan_commit_equals_reference(seed):
    batches, pool = _key_batches(seed)
    out = {}
    for name, pkg in PACKAGES.items():
        shared = pkg["svc"].SharedMemo()
        shared.commit({k: np.asarray([float(i), 1.0]) for i, k in enumerate(pool[:5])})
        trace = []
        for wave in (batches, batches[::-1], batches):
            hits, owned = shared.plan(wave)
            trace.append((sorted(hits), {k: v for k, v in owned.items()}))
            shared.commit({k: np.asarray([float(len(k)), 2.0]) for k in owned})
        trace.append((shared.stats(), shared.hit_rate(), len(shared)))
        out[name] = trace
    assert out["port"] == out["ref"]
    stats = out["port"][-1][0]
    # every requested row is a hit, a duplicate within its wave, or trained once
    assert stats["hits"] + stats["coalesced"] + stats["trained"] - 5 == stats["rows_requested"]


def test_shared_memo_hits_carry_the_table_values():
    shared = eval_service.SharedMemo()
    k1, k2 = b"a" * 9, b"b" * 9
    shared.commit({k1: np.asarray([1.0, 2.0])})
    hits, owned = shared.plan([[k1, k2, k2], [k2, k1]])
    assert list(hits) == [k1] and np.array_equal(hits[k1], [1.0, 2.0])
    assert owned == {k2: (0, 1)}
    assert (shared.n_hits, shared.n_coalesced, shared.n_rows_requested) == (2, 2, 5)
    assert shared.hit_rate() == 0.8


# -- the wave scheduler ---------------------------------------------------------


def _eight_genomes():
    masks = np.zeros((8, N_BITS), bool)
    for i in range(8):
        masks[i, : i + 1] = True
    return masks, np.zeros((8, len(CATS)), np.int64)


@pytest.mark.parametrize("name", ["port", "ref"])
def test_wave_coalesces_and_dedupes_deterministically(name):
    """Two overlapping batches queued before start form one deduped wave, the
    unused slot shipped as zero rows; an empty batch answers zeros((0, 0))."""
    svc = PACKAGES[name]["svc"]
    shared = svc.SharedMemo()
    calls = []

    def observing(batches):
        calls.append([int(np.shape(m)[0]) for m, _ in batches])
        return _stacked(batches)

    sched = svc.WaveScheduler(observing, shared, wave_slots=3, coalesce_s=0.05)
    masks, cats = _eight_genomes()
    resolve_a = sched.submit(masks[:4], cats[:4])
    resolve_b = sched.submit(masks[2:], cats[2:])  # rows 2, 3 overlap
    resolve_e = sched.submit(masks[:0], cats[:0])
    with sched:
        objs_a, objs_b, objs_e = resolve_a(), resolve_b(), resolve_e()
    np.testing.assert_array_equal(objs_a, _objective(masks[:4], cats[:4]))
    np.testing.assert_array_equal(objs_b, _objective(masks[2:], cats[2:]))
    assert objs_e.shape == (0, 0) and objs_e.dtype == np.float64
    assert calls == [[4, 4, 0]]
    assert (shared.n_rows_requested, shared.n_trained, shared.n_coalesced, len(shared)) == (
        10, 8, 2, 8)
    assert sched.stats()["n_waves"] == 1 and sched.stats()["mean_occupancy"] == 3.0


def test_wave_scheduler_equals_reference():
    out = {}
    for name in PACKAGES:
        svc = PACKAGES[name]["svc"]
        shared = svc.SharedMemo()
        calls = []

        def observing(batches, calls=calls):
            calls.append([(np.asarray(m).tolist(), np.asarray(c).tolist()) for m, c in batches])
            return _stacked(batches)

        sched = svc.WaveScheduler(observing, shared, wave_slots=2, coalesce_s=0.05)
        masks, cats = _eight_genomes()
        resolves = [sched.submit(masks[i:i + 3], cats[i:i + 3]) for i in (0, 2, 4, 5)]
        with sched:
            objs = [r() for r in resolves]
        stats = sched.stats()
        out[name] = (calls, [o.tolist() for o in objs], shared.stats(),
                     {k: v for k, v in stats.items()},
                     [{k: v for k, v in w.items() if k != "wave_s"} for w in sched.waves])
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("name", ["port", "ref"])
def test_wave_failure_fails_its_requests_not_the_service(name):
    pkg = PACKAGES[name]
    shared = pkg["svc"].SharedMemo()
    fail_next = {"flag": True}

    def flaky(batches):
        if fail_next["flag"]:
            fail_next["flag"] = False
            raise pkg["fail"].DeviceLossError("wave lost")
        return _stacked(batches)

    masks = np.eye(4, N_BITS, dtype=bool)
    cats = np.zeros((4, len(CATS)), np.int64)
    with pkg["svc"].WaveScheduler(flaky, shared, wave_slots=2, coalesce_s=0.01) as sched:
        bad = sched.submit(masks[:2], cats[:2])
        with pytest.raises(pkg["fail"].DeviceLossError):
            bad()
        good = sched.submit(masks[2:], cats[2:])
        np.testing.assert_array_equal(good(), _objective(masks[2:], cats[2:]))
    assert len(shared) == 2 and shared.n_trained == 2  # the failed wave committed nothing
    assert sched.stats()["n_waves"] == 1
    with pytest.raises(RuntimeError, match="stopped"):
        sched.submit(masks[:1], cats[:1])
    with pytest.raises(ValueError, match="wave_slots"):
        pkg["svc"].WaveScheduler(_stacked, shared, wave_slots=0)


# -- the service on the analytic backend ------------------------------------------


def _every_other_screen(pkg):
    """A deterministic screen stage: defer every other unseen row once the memo has 12 rows."""

    def screen(ctx):
        if ctx.final or len(ctx.memo) < 12:
            return pkg["pipe"].ScreenDecision(train=dict(ctx.unseen))
        keys = list(ctx.unseen)
        deferred = {k: _objective(*_key_to_genome(k))[0] + 0.5 for k in keys[1::2]
                    if k not in ctx.must_train}
        return pkg["pipe"].ScreenDecision(
            train={k: ctx.unseen[k] for k in keys if k not in deferred}, deferred=deferred)

    return screen


@pytest.mark.parametrize("screened", [False, True], ids=["exact", "screened"])
def test_service_results_equal_reference_and_solo(screened):
    """Four requests at once (two of them the same search): every request's front,
    memo order and counters equal the reference service's and its solo run's;
    the duplicates train no row; with a screen stage the deferred counts agree too."""
    seeds = (1, 1, 2, 3)
    out = {}
    for name, pkg in PACKAGES.items():
        factory = (lambda pkg=pkg: _every_other_screen(pkg)) if screened else None
        with _service(pkg, stacked=_slow_stacked(0.002), screen_factory=factory) as svc:
            results = svc.run_all([pkg["svc"].SearchRequest(f"r{i}", ga=_ga(pkg, s), memo={})
                                   for i, s in enumerate(seeds)])
            stats = svc.stats()
        out[name] = ([_witness(r) for r in results], stats)
        for r, s in zip(results, seeds):
            screen = _every_other_screen(pkg) if screened else None
            _assert_same(_witness(r), _solo_witness(*_solo(pkg, s, memo={}, screen=screen)))
    for got, want in zip(out["port"][0], out["ref"][0]):
        _assert_same(got, want)
    if screened:
        assert all(w["n_deferred"] > 0 for w in out["port"][0])
    sm = out["port"][1]["shared_memo"]
    distinct = set().union(*(w["memo_keys"] for w in out["port"][0][1:]))
    assert sm["trained"] == sm["entries"] == len(distinct)  # the duplicate added nothing
    assert sm["hits"] + sm["coalesced"] == sm["rows_requested"] - sm["trained"] > 0
    for name in PACKAGES:
        adm = out[name][1]["admission"]
        assert (adm["n_admitted"], adm["n_rejected"], adm["active"]) == (4, 0, 0)


@pytest.mark.parametrize("name", ["port", "ref"])
def test_second_identical_request_costs_zero_device_rows(name):
    pkg = PACKAGES[name]
    with _service(pkg) as svc:
        svc.submit(pkg["svc"].SearchRequest("first", ga=_ga(pkg, 3)))
        first = svc.result("first")
        trained = svc.stats()["shared_memo"]["trained"]
        svc.submit(pkg["svc"].SearchRequest("again", ga=_ga(pkg, 3)))
        again = svc.result("again")
        stats = svc.stats()
    np.testing.assert_array_equal(again.result["objs"], first.result["objs"])
    rows = 6 + 2 * 6 * 4  # the setup pool and a pool of 12 a generation
    assert first.n_evaluations + first.n_memo_hits == rows
    assert (again.n_evaluations, again.n_memo_hits) == (0, rows)
    assert stats["shared_memo"]["trained"] == trained


def test_cross_request_dedupe_trains_twice_born_genome_once():
    seeds = (7, 7, 8)
    with _service(PORT, stacked=_slow_stacked(0.002)) as svc:
        results = svc.run_all([eval_service.SearchRequest(f"r{i}", ga=_ga(PORT, s))
                               for i, s in enumerate(seeds)])
        stats = svc.stats()
    unique = set().union(*(r.memo_keys for r in results))
    sm = stats["shared_memo"]
    assert sm["trained"] == len(unique) == sm["entries"]
    assert sm["hits"] + sm["coalesced"] == sm["rows_requested"] - sm["trained"] > 0


@pytest.mark.parametrize("name", ["port", "ref"])
def test_request_death_mid_wave_leaves_other_views_intact(name):
    pkg = PACKAGES[name]
    solo = _solo_witness(*_solo(pkg, 1))
    with _service(pkg, stacked=_slow_stacked(0.005)) as svc:
        svc.submit(pkg["svc"].SearchRequest(
            "victim", ga=_ga(pkg, 2), injector=pkg["fail"].FailureInjector(crash_at_step=1)))
        svc.submit(pkg["svc"].SearchRequest("survivor", ga=_ga(pkg, 1)))
        victim, survivor = svc.result("victim"), svc.result("survivor")
        svc.submit(pkg["svc"].SearchRequest("after", ga=_ga(pkg, 1)))
        after = svc.result("after")
        snapshot = svc.shared.snapshot()
        stats = svc.stats()
    assert isinstance(victim.error, pkg["fail"].DeviceLossError)
    _assert_same(_witness(survivor), solo)
    np.testing.assert_array_equal(after.result["objs"], solo["objs"])
    for key, val in snapshot.items():
        np.testing.assert_array_equal(val, _objective(*_key_to_genome(key))[0])
    assert stats["admission"]["n_admitted"] == 3 and stats["admission"]["active"] == 0


@pytest.mark.parametrize("name", ["port", "ref"])
def test_submit_refuses_unmemoized_duplicate_and_unstarted(name):
    pkg = PACKAGES[name]
    svc = _service(pkg)
    with pytest.raises(RuntimeError, match="not started"):
        svc.submit(pkg["svc"].SearchRequest("x", ga=_ga(pkg)))
    with svc:
        with pytest.raises(ValueError, match="memo cache"):
            svc.submit(pkg["svc"].SearchRequest("naive", ga=_ga(pkg, memoize=False)))
        svc.submit(pkg["svc"].SearchRequest("a", ga=_ga(pkg, gens=1)))
        with pytest.raises(ValueError, match="duplicate request_id"):
            svc.submit(pkg["svc"].SearchRequest("a", ga=_ga(pkg, gens=1)))
        assert svc.result("a").ok
        with pytest.raises(KeyError):
            svc.result("nope")


@pytest.mark.parametrize("name", ["port", "ref"])
def test_service_reports_deadline_exceeded(name):
    pkg = PACKAGES[name]
    with _service(pkg, stacked=_slow_stacked(0.05),
                  admission=pkg["adm"].AdmissionConfig(deadline_s=0.01)) as svc:
        svc.submit(pkg["svc"].SearchRequest("slow", ga=_ga(pkg, 1)))
        res = svc.result("slow", timeout=0.02)
        assert isinstance(res.error, TimeoutError) and "deadline" in str(res.error)
    assert svc.result("slow").ok


def test_admission_bounds_concurrency_without_changing_results():
    solos = {s: _solo_witness(*_solo(PORT, s)) for s in (1, 2, 3)}
    with _service(PORT, stacked=_slow_stacked(0.002),
                  admission=admission.AdmissionConfig(max_active=1)) as svc:
        results = svc.run_all([eval_service.SearchRequest(f"r{s}", ga=_ga(PORT, s))
                               for s in (1, 2, 3)])
        stats = svc.stats()
    for res, s in zip(results, (1, 2, 3)):
        np.testing.assert_array_equal(res.result["objs"], solos[s]["objs"])
    assert stats["admission"]["peak_active"] == 1 and stats["admission"]["peak_queued"] >= 1
    assert stats["waves"]["mean_occupancy"] == 1.0


def test_many_threads_stress_conserves_rows():
    """Twelve requests on short thread switches: every request equals its solo run
    and no row is lost or trained twice."""
    seeds = [s % 5 for s in range(12)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with _service(PORT, wave_slots=4, coalesce_s=0.001) as svc:
            results = svc.run_all([eval_service.SearchRequest(f"r{i}", ga=_ga(PORT, s, gens=3),
                                                              memo={})
                                   for i, s in enumerate(seeds)])
            stats = svc.stats()
    finally:
        sys.setswitchinterval(old)
    solos = {s: _solo_witness(*_solo(PORT, s, memo={}, gens=3)) for s in set(seeds)}
    for r, s in zip(results, seeds):
        _assert_same(_witness(r), solos[s])
    sm = stats["shared_memo"]
    unique = set().union(*(r.memo_keys for r in results))
    assert sm["trained"] == sm["entries"] == len(unique)
    assert sm["hits"] + sm["coalesced"] + sm["trained"] == sm["rows_requested"]
    assert stats["waves"]["trained"] == sm["trained"]


# -- the shared memo on disk ------------------------------------------------------


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")])
def test_service_memo_loads_across_packages(tmp_path, writer, reader):
    path = str(tmp_path / "memo")
    fp = {"dataset": "analytic", "v": 1}
    w = PACKAGES[writer]
    svc = w["svc"].EvalService(_stacked, N_BITS, CATS, cfg=w["svc"].ServiceConfig(
        wave_slots=3, coalesce_s=0.02, memo_path=path, persist_every_s=0.0), fingerprint=fp)
    with svc:
        svc.submit(w["svc"].SearchRequest("warm", ga=_ga(w, 4)))
        res = svc.result("warm")
        assert svc.stats()["shared_memo"]["n_saves"] >= 1
    loaded = (memo_store if reader == "port" else jmemo_store).load_memo(path, fp)
    assert list(loaded) == res.memo_keys
    r = PACKAGES[reader]
    svc2 = r["svc"].EvalService(_stacked, N_BITS, CATS, cfg=r["svc"].ServiceConfig(
        wave_slots=3, coalesce_s=0.02, memo_path=path), fingerprint=fp)
    assert len(svc2.shared) == len(res.memo_keys)
    with svc2:
        svc2.submit(r["svc"].SearchRequest("rerun", ga=_ga(r, 4)))
        rerun = svc2.result("rerun")
        assert svc2.stats()["shared_memo"]["trained"] == 0
    np.testing.assert_array_equal(rerun.result["objs"], res.result["objs"])
    with pytest.raises(ValueError, match="refusing to reuse"):
        r["svc"].EvalService(_stacked, N_BITS, CATS, cfg=r["svc"].ServiceConfig(
            memo_path=path), fingerprint={"dataset": "other", "v": 2})


# -- the QAT backend on the CPU -----------------------------------------------------

QAT = dict(dataset="seeds", pop_size=4, n_generations=2, step_scale=0.1, max_steps=30)
PAD = 8  # rows a call of the reference's row program is padded to (one compile)


def _reference_draws(seeds, ecfg, layer_sizes, n_train):
    """The reference's initial weights and minibatch indices of each row (its trainer's draw)."""
    mcfg = jqat.MLPConfig(layer_sizes)

    def one(seed):
        key = jax.random.fold_in(jax.random.PRNGKey(ecfg.seed), seed)
        idx = jax.vmap(lambda t: jax.random.randint(
            jax.random.fold_in(key, t), (ecfg.max_batch,), 0, n_train))(
                jnp.arange(ecfg.max_steps))
        return jqat.init_mlp(key, mcfg), idx

    params, idx = jax.jit(jax.vmap(one))(jnp.asarray(seeds, jnp.int32))
    return ({k: torch.from_numpy(np.array(v)) for k, v in params.items()},
            torch.from_numpy(np.array(idx, np.int64)))


def _patch_qat(monkeypatch):
    """The port trains from the reference's draws; the reference's island evaluator
    is its unsharded row program, each island padded to PAD rows."""

    def draw_rows(seeds, cfg, mlp_cfg, n_train):
        ecfg = jtrainer.EvalConfig(max_steps=cfg.max_steps, max_batch=cfg.max_batch,
                                   seed=cfg.seed)
        return _reference_draws(np.asarray(seeds).reshape(-1), ecfg, mlp_cfg.layer_sizes,
                                n_train)

    def islands(X_tr, y_tr, X_te, y_te, mlp_cfg, cfg, num_islands=1, **kw):
        run = jax.jit(jax.vmap(jtrainer._make_train_one(X_tr, y_tr, X_te, y_te, mlp_cfg, cfg)))

        def one(rows):
            n = int(np.shape(rows[0])[0])
            if n == 0:
                return np.zeros((0,), np.float32)
            out = []
            for s in range(0, n, PAD):
                chunk = [np.asarray(r)[s:s + PAD] for r in rows]
                k = chunk[0].shape[0]
                chunk = [np.concatenate([a, np.repeat(a[-1:], PAD - k, 0)]) for a in chunk]
                out.append(np.asarray(run(*chunk))[:k])
            return np.concatenate(out)

        def dispatch(batches):
            assert len(batches) == num_islands
            accs = [one(b) for b in batches]
            return lambda: accs

        evaluate = lambda batches: dispatch(batches)()  # noqa: E731
        evaluate.dispatch = dispatch
        return evaluate

    monkeypatch.setattr(trainer, "draw_rows", draw_rows)
    monkeypatch.setattr(jtrainer, "make_island_evaluator", islands)


def _backends():
    port = codesign.make_service_backend(codesign.CodesignConfig(**QAT, device="cpu"),
                                         wave_slots=3)
    ref = jcodesign.make_service_backend(jcodesign.CodesignConfig(**QAT), wave_slots=3)
    return port, ref


def _wave(backend, seed):
    """Three slots of 5, 0 and 2 genomes (the empty slot filled), two rows shared."""
    rng = np.random.default_rng(seed)
    n, cards = backend["n_mask_bits"], backend["cat_cardinalities"]
    masks = rng.uniform(size=(7, n)) < 0.6
    cats = np.stack([rng.integers(0, c, 7) for c in cards], 1).astype(np.int64)
    return [(masks[:5], cats[:5]), (masks[:0], cats[:0]), (masks[3:5], cats[3:5])]


def test_qat_backend_equals_reference(monkeypatch):
    """The port's ``stacked_evaluate`` bit-equal to the reference's from the same draws:
    an empty slot gives None, a row the same objectives in any slot; keys and shapes."""
    _patch_qat(monkeypatch)
    port, ref = _backends()
    assert port["fingerprint"] == {**ref["fingerprint"], "backend": "torch"}
    for k in ("n_mask_bits", "cat_cardinalities", "conv_area"):
        assert port[k] == ref[k], k
    assert port["spec"].n_features == ref["spec"].n_features
    assert port["screen_factory"] is None and ref["screen_factory"] is None
    batches = _wave(port, 0)
    got, want = port["stacked_evaluate"](batches), ref["stacked_evaluate"](batches)
    assert got[1] is None and want[1] is None
    for g, w in zip(got[::2], want[::2]):
        assert g.shape == w.shape and np.array_equal(g, w)
    np.testing.assert_array_equal(got[0][3:5], got[2])  # a row is its own, in any slot
    assert np.isfinite(got[0]).all() and ((got[0][:, 0] >= 0) & (got[0][:, 0] <= 1)).all()


def test_qat_service_equals_reference(monkeypatch):
    """Two concurrent searches on each package's QAT service: the same fronts, memo
    order and counters, from the same draws."""
    _patch_qat(monkeypatch)
    backends = dict(zip(("port", "ref"), _backends()))
    out = {}
    for name, pkg in PACKAGES.items():
        b = backends[name]
        svc = pkg["svc"].EvalService(b["stacked_evaluate"], b["n_mask_bits"],
                                     b["cat_cardinalities"],
                                     cfg=pkg["svc"].ServiceConfig(wave_slots=3, coalesce_s=0.05),
                                     fingerprint=b["fingerprint"])
        reqs = [pkg["svc"].SearchRequest(f"r{s}", ga=_ga(pkg, s, QAT["pop_size"],
                                                          QAT["n_generations"]), memo={})
                for s in (0, 11)]
        with svc:
            out[name] = [_witness(r) for r in svc.run_all(reqs)]
    for got, want in zip(out["port"], out["ref"]):
        _assert_same(got, want)


def test_qat_backend_screen_factory_builds_fresh_screens():
    port = codesign.make_service_backend(codesign.CodesignConfig(
        **QAT, device="cpu", surrogate=True, surrogate_min_rows=8), wave_slots=2)
    a, b = port["screen_factory"](), port["screen_factory"]()
    assert a is not b and a.cfg.min_rows == 8 and a.device.type == "cpu"
    assert a.n_mask_bits == port["n_mask_bits"]


def test_concurrent_qat_search_equals_solo_real_evaluator():
    """Concurrent == alone on the port's own QAT objective (its own draws)."""
    cd_cfg = codesign.CodesignConfig(**QAT, device="cpu")
    slots = 2
    backend = codesign.make_service_backend(cd_cfg, wave_slots=slots)
    empty = (np.zeros((0, backend["n_mask_bits"]), bool),
             np.zeros((0, len(backend["cat_cardinalities"])), np.int64))

    def row_evaluate(masks, cats):
        return backend["stacked_evaluate"]([(masks, cats)] + [empty] * (slots - 1))[0]

    ga = nsga2.NSGA2Config(pop_size=cd_cfg.pop_size, n_generations=cd_cfg.n_generations,
                           seed=cd_cfg.seed)
    solo = nsga2.NSGA2(backend["n_mask_bits"], backend["cat_cardinalities"], row_evaluate, ga,
                       memo={})
    solo_out = solo.run()
    svc = eval_service.EvalService(
        backend["stacked_evaluate"], backend["n_mask_bits"], backend["cat_cardinalities"],
        cfg=eval_service.ServiceConfig(wave_slots=slots, coalesce_s=0.05),
        fingerprint=backend["fingerprint"])
    other = nsga2.NSGA2Config(pop_size=cd_cfg.pop_size, n_generations=cd_cfg.n_generations,
                              seed=11)
    with svc:
        results = svc.run_all([eval_service.SearchRequest("main", ga=ga, memo={}),
                               eval_service.SearchRequest("other", ga=other, memo={})])
        stats = svc.stats()
    _assert_same(_witness(results[0]), _solo_witness(solo, solo_out))
    assert results[1].ok and stats["shared_memo"]["trained"] >= 1


def test_qat_service_memo_is_a_campaign_memo(tmp_path):
    """The service's memo on disk carries the campaign's fingerprint: the port's
    ``run_codesign`` over it trains nothing it holds, and the reference refuses it
    under its own config's fingerprint (the packages draw other weights)."""
    path = str(tmp_path / "memo")
    cfg = codesign.CodesignConfig(**{**QAT, "n_generations": 0}, device="cpu")
    b = codesign.make_service_backend(cfg, wave_slots=2)
    svc = eval_service.EvalService(
        b["stacked_evaluate"], b["n_mask_bits"], b["cat_cardinalities"],
        cfg=eval_service.ServiceConfig(wave_slots=2, memo_path=path),
        fingerprint=b["fingerprint"])
    with svc:
        svc.submit(eval_service.SearchRequest("r", ga=nsga2.NSGA2Config(
            pop_size=cfg.pop_size, n_generations=0, seed=cfg.seed)))
        served = svc.result("r")
    assert served.ok and served.n_evaluations == cfg.pop_size
    memo = memo_store.load_memo(path, cfg.memo_fingerprint())
    assert list(memo) == served.memo_keys
    res = codesign.run_codesign(dataclasses.replace(cfg, memo_path=path))
    assert (res.n_evaluations, res.n_memo_hits) == (0, cfg.pop_size)
    with pytest.raises(ValueError, match="refusing to reuse"):
        jmemo_store.load_memo(path, jcodesign.CodesignConfig(**QAT).memo_fingerprint())


# -- the launcher -----------------------------------------------------------------------


@pytest.mark.parametrize("n,dup", [(4, 2), (5, 0), (6, 3)])
def test_build_requests_equals_reference(n, dup):
    got = codesign_serve.build_requests(n, 8, 3, 5, duplicate_every=dup)
    want = jcodesign_serve.build_requests(n, 8, 3, 5, duplicate_every=dup)
    assert [(r.request_id, r.ga.seed, r.ga.pop_size, r.ga.n_generations) for r in got] == [
        (r.request_id, r.ga.seed, r.ga.pop_size, r.ga.n_generations) for r in want]


def test_codesign_serve_main_on_the_cpu(tmp_path, capsys):
    out = codesign_serve.main(["--device", "cpu", "--requests", "3", "--duplicate-every", "2",
                               "--pop", "4", "--gens", "1", "--max-steps", "12",
                               "--step-scale", "0.1", "--slots", "2",
                               "--memo-path", str(tmp_path / "memo")])
    text = capsys.readouterr().out
    assert "latency p50=" in text and "cross-request hit rate" in text
    assert [r.request_id for r in out["results"]] == ["req-000", "req-001", "req-002"]
    assert all(r.ok for r in out["results"])
    np.testing.assert_array_equal(out["results"][0].result["objs"],
                                  out["results"][1].result["objs"])
    assert memo_store.memo_path_exists(str(tmp_path / "memo"))
    assert out["stats"]["shared_memo"]["trained"] == out["stats"]["shared_memo"]["entries"]
