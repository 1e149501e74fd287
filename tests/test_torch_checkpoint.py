"""The port's checkpoints, memo store and elastic runner against the reference.

Both packages write the same on-disk format (``arrays.npz`` + a sha256
manifest), so what one writes the other loads: pytrees, GA-state
checkpoints through either ``CheckpointManager``, and genome memos.  An
engine's ``state_dict`` -> ``set_state`` round trip continues bit for bit,
also across the packages; a campaign interrupted by an injected
``HostFailure`` and resumed from its checkpoint equals the uninterrupted
one, as in the reference; a device loss replays only the lost batch.
"""

import json
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from _torch_shared import assert_same_codesign, assert_same_memo, patch_evaluators  # noqa: E402

from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.core import codesign as jcodesign  # noqa: E402
from repro.core import memo_store as jmemo_store  # noqa: E402
from repro.core import nsga2 as jnsga2  # noqa: E402
from repro.runtime import elastic as jelastic  # noqa: E402
from repro.runtime import failure as jfailure  # noqa: E402
from repro_torch.checkpoint import CheckpointManager, ckpt  # noqa: E402
from repro_torch.core import codesign, memo_store, nsga2  # noqa: E402
from repro_torch.runtime import elastic, failure, straggler  # noqa: E402


def _objective(masks, cats):
    h = masks.shape[1] // 2
    return np.stack([masks[:, :h].mean(1) + 0.01 * cats[:, 0],
                     1.0 - masks[:, h:].mean(1)], 1)


def _engine(mod):
    return mod.NSGA2(24, (3, 2), _objective, mod.NSGA2Config(pop_size=6, n_generations=6, seed=3))


def _islands(mod, evaluate=_objective):
    return mod.IslandNSGA2(20, (3, 2), evaluate, mod.NSGA2Config(pop_size=5, n_generations=5,
                                                                 seed=1),
                           mod.IslandConfig(num_islands=3, migration_interval=2,
                                            migration_size=1))


def _assert_same_out(got, want):
    for k in ("masks", "cats", "objs"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (got["n_evaluations"], got["n_memo_hits"]) == (want["n_evaluations"],
                                                          want["n_memo_hits"])


@pytest.mark.parametrize("make", [_engine, _islands], ids=["engine", "islands"])
@pytest.mark.parametrize("writer,reader", [("port", "port"), ("port", "ref"), ("ref", "port")])
def test_state_round_trip_continues_bit_for_bit(make, writer, reader):
    mods = {"port": nsga2, "ref": jnsga2}
    full = make(mods[reader])
    want = full.run()
    src = make(mods[writer])
    n = 0

    def stop_at_2(driver, gens_done):
        nonlocal n
        n = gens_done
        if gens_done == 2:
            raise StopIteration

    with pytest.raises(StopIteration):
        src.run(checkpoint_hook=stop_at_2)
    snap = src.state_dict()
    meta = json.loads(json.dumps(snap["meta"]))  # as the manifest carries it
    dst = make(mods[reader])
    dst.set_state({"arrays": snap["arrays"], "meta": meta})
    assert dst.gens_done == n == 2
    _assert_same_out(dst.run(), want)
    assert_same_memo(dst.memo, full.memo)


def test_state_dict_refuses_mid_generation_and_wrong_shapes():
    eng = _engine(nsga2)
    eng.setup()
    masks, cats = eng.step_begin()
    with pytest.raises(RuntimeError, match="generation boundaries"):
        eng.state_dict()
    eng.step_commit(_objective(masks, cats), 0.0)
    snap = eng.state_dict()
    with pytest.raises(ValueError, match="mask bits"):
        nsga2.NSGA2(16, (3, 2), _objective).set_state(snap)
    with pytest.raises(ValueError, match="islands"):
        _islands(nsga2).set_state({"arrays": {}, "meta": {"islands": []}})
    blank = _engine(nsga2).state_dict()
    fresh = _engine(nsga2)
    fresh.set_state(json.loads(json.dumps({"arrays": {}, "meta": blank["meta"]})))
    assert fresh.pop is None and fresh.gens_done == 0
    _assert_same_out(fresh.run(), _engine(nsga2).run())


@pytest.mark.parametrize("save,load", [(ckpt, jckpt), (jckpt, ckpt)], ids=["port>ref", "ref>port"])
def test_pytrees_load_across_packages(tmp_path, save, load):
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "nest": {"k": np.asarray([b"\x01\x02"], "S2").view(np.uint8), "e": np.zeros((0, 0))},
            "l": [np.int64(3), np.ones(2, bool)]}
    path = save.save_pytree(str(tmp_path / "t"), tree, step=4, extra={"x": [1, 2]})
    got, manifest = load.load_pytree(path)
    assert manifest["step"] == 4 and manifest["extra"] == {"x": [1, 2]}
    np.testing.assert_array_equal(got["a"], tree["a"])
    np.testing.assert_array_equal(got["nest"]["k"], tree["nest"]["k"])
    assert got["nest"]["e"].shape == (0, 0)
    np.testing.assert_array_equal(got["l"]["[1]"], tree["l"][1])


def test_port_reads_tensors_and_refuses_corruption(tmp_path):
    path = ckpt.save_pytree(str(tmp_path / "t"), {"w": torch.arange(4.0)})
    np.testing.assert_array_equal(ckpt.load_pytree(path)[0]["w"], np.arange(4.0, dtype=np.float32))
    failure.FailureInjector.corrupt_checkpoint(path)
    with pytest.raises(IOError, match="corrupted"):
        ckpt.load_pytree(path)
    with pytest.raises(FileNotFoundError, match="not a checkpoint"):
        failure.FailureInjector.corrupt_checkpoint(str(tmp_path))


def test_managers_read_each_others_rotated_checkpoints(tmp_path):
    d = str(tmp_path / "ck")
    mgr = CheckpointManager(d, keep_n=2)
    for step in range(4):
        mgr.save(step, {"x": np.full(3, step)}, extra={"meta": {"step": step}})
    mgr.wait()
    mgr.close()
    assert mgr.all_steps() == [2, 3]
    ref = JManager(d, keep_n=2)
    tree, manifest = ref.restore()
    ref.close()
    assert manifest["step"] == 3 and manifest["extra"]["meta"] == {"step": 3}
    np.testing.assert_array_equal(tree["x"], np.full(3, 3))
    # a corrupt newest checkpoint is skipped, newest first, by the port too
    failure.FailureInjector.corrupt_checkpoint(os.path.join(d, "step_3"))
    tree, manifest = CheckpointManager(d).restore()
    assert manifest["step"] == 2


@pytest.mark.parametrize("save,load", [(memo_store, jmemo_store), (jmemo_store, memo_store)],
                         ids=["port>ref", "ref>port"])
def test_memos_load_across_packages(tmp_path, save, load):
    rng = np.random.default_rng(0)
    memo = {rng.bytes(13): np.asarray([0.1 * i, 2.0 + i]) for i in range(7)}
    fp = {"dataset": "seeds", "layer_sizes": (7, 3, 3)}
    save.save_memo(str(tmp_path / "m"), memo, fp)
    assert load.memo_path_exists(str(tmp_path / "m"))
    assert_same_memo(load.load_memo(str(tmp_path / "m"), fp), memo)
    with pytest.raises(ValueError, match="refusing"):
        load.load_memo(str(tmp_path / "m"), {"dataset": "balance"})
    save.save_memo(str(tmp_path / "empty"), {})
    assert load.load_memo(str(tmp_path / "empty")) == {}


def test_memo_autosaver_rate_limits_and_flushes(tmp_path, monkeypatch):
    clock = {"t": 0.0}
    monkeypatch.setattr(memo_store.time, "monotonic", lambda: clock["t"])
    saver = memo_store.MemoAutosaver(str(tmp_path / "m"), {"a": 1}, every_s=10.0)
    memo = {b"k": np.ones(2)}
    assert saver.poke(memo) is not None and saver.n_saves == 1
    clock["t"] = 5.0
    assert saver.poke(memo) is None
    clock["t"] = 15.0
    memo[b"j"] = np.zeros(2)
    assert saver.poke(memo) is not None
    saver.flush(memo)
    assert saver.n_saves == 3
    assert_same_memo(jmemo_store.load_memo(str(tmp_path / "m"), {"a": 1}), memo)


def test_device_loss_replays_only_the_lost_batch():
    """The reference's drill (``tests/test_fault_tolerance.py``) on the port's runner."""
    rows = {"n": 0}
    full = _islands(nsga2, lambda m, c: (rows.__setitem__("n", rows["n"] + len(m)),
                                         _objective(m, c))[1])
    want = full.run()
    ref_rows, rows["n"] = rows["n"], 0
    state = {"calls": 0, "lost": None}

    def chaos(m, c):
        call, state["calls"] = state["calls"], state["calls"] + 1
        rows["n"] += len(m)
        if call == 7 and state["lost"] is None:
            state["lost"] = len(m)
            raise failure.DeviceLossError("drill: device group lost mid-batch")
        return _objective(m, c)

    driver = _islands(nsga2, chaos)
    rebuilt = []
    runner = elastic.ElasticGARunner(driver=driver, run_fn=lambda h: driver.run(checkpoint_hook=h),
                                     rebuild=rebuilt.append, probe=lambda: 1)
    got = runner.run()
    for k in ("masks", "cats", "objs"):
        np.testing.assert_array_equal(got[k], want[k])
    assert driver.migrations == full.migrations
    assert_same_memo(driver.memo, full.memo)
    assert rows["n"] == ref_rows + state["lost"]
    assert rebuilt == [1] and [r["reason"] for r in runner.recoveries] == ["device-loss"]


def test_straggler_eviction_and_max_recoveries():
    wd = straggler.StragglerWatchdog(evict_after=1, readmit_after=50)
    for s in range(12):
        wd.observe(s, 0.1)
    driver = _islands(nsga2)
    driver.run()
    driver.agg_history.append({"gen": driver.gens_done, "gen_s": 9.9})
    rebuilt, saved = [], []
    runner = elastic.ElasticGARunner(driver=driver, run_fn=lambda h: driver.run(checkpoint_hook=h),
                                     rebuild=rebuilt.append, probe=lambda: 1, watchdog=wd,
                                     checkpoint_cb=lambda d, g, urgent: saved.append((g, urgent)))
    runner._on_boundary(driver, driver.gens_done)
    assert rebuilt == [1] and saved == [(driver.gens_done, True)]

    def dies(m, c):
        raise failure.DeviceLossError("drill: permanent failure")

    doomed = _islands(nsga2, dies)
    runner = elastic.ElasticGARunner(driver=doomed, run_fn=lambda h: doomed.run(checkpoint_hook=h),
                                     max_recoveries=2)
    with pytest.raises(failure.DeviceLossError):
        runner.run()
    assert len(runner.recoveries) == 2


CHAOS = dict(dataset="seeds", pop_size=4, n_generations=3, step_scale=0.1, max_steps=30,
             num_islands=2, migration_interval=1, migration_size=1)


@pytest.mark.parametrize("islands,crash_at", [(2, 4), (1, 2)])
def test_host_failure_then_resume_equals_uninterrupted(tmp_path, monkeypatch, islands, crash_at):
    """Both packages: crash at a batch, resume from the checkpoint directory, same search."""
    patch_evaluators(monkeypatch)
    pkgs = {"port": (codesign, memo_store, elastic, failure, {"device": "cpu"}),
            "ref": (jcodesign, jmemo_store, jelastic, jfailure, {})}
    results = {}
    for name, (cd, ms, el, fl, dev) in pkgs.items():
        kw = {**CHAOS, "num_islands": islands, **dev}
        tmp = tmp_path / name
        ref = cd.run_codesign(cd.CodesignConfig(**kw, memo_path=str(tmp / "memo_ref")))
        crash = el.DrillConfig(
            injector=fl.FailureInjector(crash_at_step=crash_at, crash_mode="host"))
        with pytest.raises(fl.HostFailure):
            cd.run_codesign(cd.CodesignConfig(**kw, checkpoint_dir=str(tmp / "ck"), drill=crash))
        again = el.DrillConfig()
        res = cd.run_codesign(cd.CodesignConfig(**kw, checkpoint_dir=str(tmp / "ck"), resume=True,
                                                drill=again, memo_path=str(tmp / "memo_res")))
        assert_same_codesign(res, ref)
        assert_same_memo(ms.load_memo(str(tmp / "memo_res")), ms.load_memo(str(tmp / "memo_ref")))
        # across both processes: the reference's rows plus the interrupted batch
        assert crash.rows_dispatched + again.rows_dispatched > ref.n_evaluations
        results[name] = (res, crash.rows_dispatched + again.rows_dispatched,
                         ms.load_memo(str(tmp / "memo_res")))
    assert_same_codesign(results["port"][0], results["ref"][0])
    assert results["port"][1] == results["ref"][1]
    assert_same_memo(results["port"][2], results["ref"][2])


def test_resume_refuses_an_incompatible_campaign_and_a_reference_checkpoint(tmp_path, monkeypatch):
    patch_evaluators(monkeypatch)
    ck = str(tmp_path / "ck")
    codesign.run_codesign(codesign.CodesignConfig(**CHAOS, checkpoint_dir=ck, device="cpu"))
    with pytest.raises(ValueError, match="refusing to resume"):
        codesign.run_codesign(codesign.CodesignConfig(
            **{**CHAOS, "pop_size": 6}, checkpoint_dir=ck, resume=True, device="cpu"))
    # the reference's fingerprint lacks the port's backend key: its
    # checkpoints hold objectives trained by the other package
    jck = str(tmp_path / "jck")
    jcodesign.run_codesign(jcodesign.CodesignConfig(**CHAOS, checkpoint_dir=jck))
    with pytest.raises(ValueError, match="refusing to resume"):
        codesign.run_codesign(codesign.CodesignConfig(**CHAOS, checkpoint_dir=jck, resume=True,
                                                      device="cpu"))
    # resuming a finished campaign trains nothing
    drill = elastic.DrillConfig()
    done = codesign.run_codesign(codesign.CodesignConfig(**CHAOS, checkpoint_dir=ck, resume=True,
                                                         drill=drill, device="cpu"))
    assert drill.rows_dispatched == 0 and done.n_evaluations > 0
