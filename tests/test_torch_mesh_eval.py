"""The port's population and island evaluators on a device grid
(``core.trainer``'s ``mesh=``) against the reference's partition.

The reference lays a generation's padded rows out with
``logical_sharding(..., population_rules())`` (and ``island_rules()`` for
the stacked island evaluator) after padding them to a bucket whose granule
is rounded up to the device count (``src/repro/core/trainer.py:203-207``,
``:312-315``).  Its evaluators cannot run here (the sharding fault, ROADMAP
Queue 3), so its partition is taken from ``logical_spec`` on an
``AbstractMesh`` of the grid's shape with its granule rule; the port's split
over 8 CPU stand-ins must be that partition, and its accuracies must be
``mesh=None``'s, bit for bit (a row's result depends on the row alone).
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh  # noqa: E402

from repro.data import uci_synth  # noqa: E402
from repro.parallel import sharding as jshd  # noqa: E402
from repro_torch.core import qat, trainer  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402

CPUS = [torch.device("cpu")] * 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(name="seeds"):
    X, y, spec = uci_synth.load(name)
    X_tr, y_tr, X_te, y_te = uci_synth.stratified_split(X, y, 0.7, 0)
    return X_tr, y_tr, X_te, y_te, (spec.n_features, spec.hidden, spec.n_classes)


def _rows(n_features, P, seed):
    rng = np.random.default_rng(seed)
    masks = rng.uniform(size=(P, n_features, 16)) < rng.uniform(0.2, 1.0, (P, 1, 1))
    masks[:, :, 0] = True
    return (
        masks,
        rng.choice([8.0, 6.0, 4.0], P).astype(np.float32),
        rng.choice([4.0, 3.0, 5.0], P).astype(np.float32),
        rng.choice([16, 64, 128], P).astype(np.int32),
        rng.choice([60, 120], P).astype(np.int32),
        rng.choice([0.05, 0.1, 0.02], P).astype(np.float32),
        rng.integers(0, 2**31 - 1, P).astype(np.int32),
    )


def _ref_granule(pad_granule: int, n: int) -> int:
    """The reference's granule: ``pad_granule`` rounded up to a multiple of n."""
    return -(-max(pad_granule, 1) // n) * n


def _ref_blocks(shape, spec, dims, names):
    """Each device's slice of the reference's layout: devices in mesh order,
    a dim split evenly over the product of its axes (row-major)."""
    sizes = dict(zip(names, dims))
    out = []
    for flat in range(int(np.prod(dims))):
        coord = dict(zip(names, np.unravel_index(flat, dims)))
        blk = []
        for dim, entry in zip(shape, spec):
            axes = () if entry is None else ((entry,) if isinstance(entry, str) else entry)
            n = int(np.prod([sizes[a] for a in axes])) if axes else 1
            part = 0
            for a in axes:
                part = part * sizes[a] + int(coord[a])
            blk.append((part * (dim // n), (part + 1) * (dim // n)))
        out.append(blk)
    return out


@pytest.mark.parametrize("P", [1, 5, 8, 13, 24])
@pytest.mark.parametrize("pad_granule", [4, 16])
def test_population_split_is_the_reference_partition(P, pad_granule):
    data = _data()
    cfg = trainer.EvalConfig(max_steps=2, pad_granule=pad_granule)
    ev = trainer.make_population_evaluator(*data[:4], qat.MLPConfig(data[4]), cfg,
                                           mesh=shd.population_mesh(devices=CPUS))
    granule = _ref_granule(pad_granule, 8)
    bucket, spec = ev.plan(P)
    assert ev.granule == granule and bucket == -(-P // granule) * granule
    jspec = tuple(jshd.logical_spec((bucket,), ("population",), AbstractMesh((8,), ("data",)),
                                    jshd.population_rules()))
    assert spec == jspec
    got = [[(s.start, s.stop) for s in blk]
           for blk in trainer.device_blocks((bucket,), spec, ev.mesh)]
    assert got == _ref_blocks((bucket,), jspec, (8,), ("data",))


@pytest.mark.parametrize("k,n", [(3, 8), (2, 8), (4, 8), (3, 2), (1, 8)])
@pytest.mark.parametrize("sizes_seed", [0, 1])
def test_island_split_is_the_reference_partition(k, n, sizes_seed):
    data = _data()
    cfg = trainer.EvalConfig(max_steps=2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        grid = shd.island_mesh(k, devices=CPUS[:n])
    ev = trainer.make_island_evaluator(*data[:4], qat.MLPConfig(data[4]), cfg, k, mesh=grid)
    sizes = list(np.random.default_rng(sizes_seed).integers(0, 11, k))
    sizes[0] = max(sizes[0], 1)
    group = grid.shape["data"]
    granule = _ref_granule(cfg.pad_granule, group)
    bucket, spec = ev.plan(sizes)
    assert bucket == -(-max(sizes) // granule) * granule
    amesh = AbstractMesh(grid.dims, grid.axis_names)
    jspec = tuple(jshd.logical_spec((k, bucket), ("island", "population"), amesh,
                                    jshd.island_rules()))
    assert spec == jspec
    got = [[(s.start, s.stop) for s in blk]
           for blk in trainer.device_blocks((k, bucket), spec, grid)]
    assert got == _ref_blocks((k, bucket), jspec, grid.dims, grid.axis_names)


def test_population_on_a_grid_is_bit_equal_to_no_mesh():
    data = _data()
    cfg = trainer.EvalConfig(max_steps=40)
    mcfg = qat.MLPConfig(data[4])
    rows = _rows(data[4][0], 13, seed=4)
    plain = trainer.make_population_evaluator(*data[:4], mcfg, cfg, device="cpu")
    grid = trainer.make_population_evaluator(*data[:4], mcfg, cfg,
                                             mesh=shd.population_mesh(devices=CPUS))
    want = plain(*rows)
    np.testing.assert_array_equal(grid(*rows), want)
    np.testing.assert_array_equal(grid.dispatch(*rows)(), want)
    one = trainer.make_population_evaluator(*data[:4], mcfg, cfg,
                                            mesh=shd.population_mesh(devices=CPUS[:1]))
    np.testing.assert_array_equal(one(*rows), want)
    # a (1,) grid runs mesh=None's buffers: the same calls, buckets and steps
    assert dict(one.stats.items()) == dict(plain.stats.items())
    assert grid.stats["calls"] == 2 * 8
    small = grid.rebuild(2)
    assert small.mesh.shape == {"data": 2}
    np.testing.assert_array_equal(small(*rows), want)


def test_islands_on_a_grid_are_bit_equal_to_no_mesh():
    data = _data()
    cfg = trainer.EvalConfig(max_steps=40)
    mcfg = qat.MLPConfig(data[4])
    batches = [_rows(data[4][0], n, seed=10 + i) for i, n in enumerate((5, 0, 3))]
    plain = trainer.make_island_evaluator(*data[:4], mcfg, cfg, 3, device="cpu")
    with pytest.warns(UserWarning, match="dropping"):
        grid_mesh = shd.island_mesh(3, devices=CPUS)
    grid = trainer.make_island_evaluator(*data[:4], mcfg, cfg, 3, mesh=grid_mesh)
    want = plain(batches)
    got = grid(batches)
    assert [len(a) for a in got] == [5, 0, 3]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(grid.dispatch(batches)(), want):
        np.testing.assert_array_equal(g, w)
    flat = trainer.make_island_evaluator(*data[:4], mcfg, cfg, 3,
                                         mesh=shd.island_mesh(3, devices=CPUS[:1]))
    assert flat.mesh.dims == (1, 1)
    for g, w in zip(flat(batches), want):
        np.testing.assert_array_equal(g, w)
    assert grid.rebuild(3).mesh.dims == (3, 1)
