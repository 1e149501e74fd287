"""Helpers shared by the campaign, island and checkpoint tests of the port.

``patch_evaluators`` replaces both packages' population and island
evaluators with one deterministic NumPy objective, so the two search
engines can be held to each other bit for bit without training (and
without the reference's sharded evaluator, which fails under JAX 0.9.0).
"""

import numpy as np

from repro.core import trainer as jtrainer
from repro_torch.core import trainer


def fake_accuracy(masks, wb, ab, bs, ep, lr, seeds) -> np.ndarray:
    """A pure function of each row: more kept levels, more accuracy (the area trade-off)."""
    masks = np.asarray(masks, bool)
    kept = masks[:, :, 1:].mean(axis=(1, 2))
    hp = (np.asarray(wb, np.float64) / 8 + np.asarray(ab, np.float64) / 6
          + np.log2(np.asarray(bs, np.float64)) / 7 + np.asarray(ep, np.float64) / 160
          + np.asarray(lr, np.float64) * 2)
    jitter = (np.asarray(seeds, np.int64) % 101) / 101.0
    return (0.35 + 0.5 * kept + 0.02 * hp + 0.03 * jitter).astype(np.float32)


def _population(*args, **kw):
    def dispatch(*rows):
        acc = fake_accuracy(*rows)
        return lambda: acc

    def evaluate(*rows):
        return dispatch(*rows)()

    evaluate.dispatch = dispatch
    evaluate.rebuild = lambda n_devices=None: _population()
    return evaluate


def _islands(*args, num_islands=1, **kw):
    def dispatch(batches):
        assert len(batches) == num_islands
        accs = [fake_accuracy(*b) for b in batches]
        return lambda: accs

    def evaluate(batches):
        return dispatch(batches)()

    evaluate.dispatch = dispatch
    evaluate.rebuild = lambda n_devices=None: _islands(num_islands=num_islands)
    return evaluate


def patch_evaluators(monkeypatch) -> None:
    for mod in (trainer, jtrainer):
        monkeypatch.setattr(mod, "make_population_evaluator", _population)
        monkeypatch.setattr(mod, "make_island_evaluator", _islands)


TIMES = ("eval_s", "gen_s")


def untimed(history: list) -> list:
    """History records without their wall-clock fields."""
    return [{k: v for k, v in r.items() if k not in TIMES} for r in history]


def assert_same_memo(a: dict, b: dict) -> None:
    assert list(a) == list(b), "memo keys or their insertion order differ"
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def assert_same_codesign(got, want) -> None:
    """Two ``CodesignResult``s of one search, times aside."""
    for k in ("front_masks", "front_cats", "front_acc", "front_area", "front_power"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
    for k in ("dataset", "conv_acc", "conv_area", "conv_power", "n_evaluations",
              "n_memo_hits", "n_deferred", "migrations", "genome_axes"):
        assert getattr(got, k) == getattr(want, k), k
    assert untimed(got.history) == untimed(want.history)
    if want.island_history is None:
        assert got.island_history is None
    else:
        assert [untimed(h) for h in got.island_history] == [
            untimed(h) for h in want.island_history]
