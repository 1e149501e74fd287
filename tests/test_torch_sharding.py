"""The port's logical-axis rules (``repro_torch.parallel.sharding``) against the
reference's ``repro.parallel.sharding``.

``logical_spec`` reads only a mesh's axis names and sizes, so the reference
runs on a ``jax.sharding.AbstractMesh`` (no devices, no sharding fault) and
the port on a ``DeviceGrid`` of the same shape; the specs are held equal,
entry for entry, for every spec of every configuration of ``configs/``
(parameters, the decode shapes' caches after ``fix_cache_axes``, and the
inputs of the four shapes) on seven meshes.  Then ``to_placements``
round trips, the ``island_mesh`` factoring and its warning, and the grids'
refusal to default to devices on a host without a card.
"""

import warnings

import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.launch import shapes as jshapes  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.parallel import sharding as jshd  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import shapes, steps  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402

MESHES = {
    "1": ((1,), ("data",)),
    "2x2": ((2, 2), ("data", "model")),
    "4x4": ((4, 4), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "island3x2": ((3, 2), ("island", "data")),
    "island1x8": ((1, 8), ("island", "data")),
}
RULES = {"island3x2": shd.island_rules(), "island1x8": shd.island_rules()}


def _grid(dims, names):
    n = 1
    for s in dims:
        n *= s
    return shd.DeviceGrid((torch.device("cpu"),) * n, names, dims)


def _specs(arch: str):
    """Every (name, shape, axes) of a config: params, the decode shapes'
    caches (the reference's ``fix_cache_axes`` applied per mesh later), and
    each shape's inputs."""
    cfg = registry.get(arch)
    model = build_model(cfg)
    out = [("param:" + k, s, a) for k, (s, a, _) in model.param_specs().items()]
    caches = []
    for name, sp in shapes.SHAPES.items():
        _, inputs, axes = shapes.input_specs(cfg, name)
        out += [(f"input:{name}:{k}", s, axes[k]) for k, (s, _) in inputs.items()]
        if sp.kind == "decode":
            caches.append((name, model.cache_specs(sp.global_batch, sp.seq_len)))
    return cfg, out, caches


def _as_tuple(pspec) -> tuple:
    return tuple(pspec)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", sorted(registry.ARCHS))
def test_logical_spec_matches_reference(arch, mesh_name):
    dims, names = MESHES[mesh_name]
    jmesh = AbstractMesh(dims, names)
    grid = _grid(dims, names)
    rules = RULES.get(mesh_name)
    cfg, specs, caches = _specs(arch)
    jcfg = jregistry.get(arch)
    # the port's specs are the reference's: names, shapes and axes
    jparams = jbuild_model(jcfg).param_specs()
    assert {k[6:]: (tuple(s), tuple(a)) for k, s, a in specs if k.startswith("param:")} == {
        k: (tuple(s), tuple(a)) for k, (s, a, _) in jparams.items()}
    checked = 0
    for name, shape, axes in specs:
        want = _as_tuple(jshd.logical_spec(tuple(shape), tuple(axes), jmesh, rules))
        got = shd.logical_spec(tuple(shape), tuple(axes), grid, rules)
        assert got == want, (name, shape, axes, got, want)
        checked += 1
    for sname, cache in caches:
        jsp = jshapes.SHAPES[sname]
        jcache = jbuild_model(jcfg).cache_specs(jsp.global_batch, jsp.seq_len)
        jfixed = jsteps.fix_cache_axes(jcache, jcfg, jmesh)
        fixed = steps.fix_cache_axes(cache, cfg, grid)
        assert {k: (tuple(s), tuple(a)) for k, (s, a, _) in fixed.items()} == {
            k: (tuple(s), tuple(a)) for k, (s, a, _) in jfixed.items()}
        for k, (shape, axes, _) in fixed.items():
            want = _as_tuple(jshd.logical_spec(tuple(shape), tuple(axes), jmesh, rules))
            assert shd.logical_spec(tuple(shape), tuple(axes), grid, rules) == want, (sname, k)
            checked += 1
    assert checked > 20


def test_rule_table_and_overrides_match_reference():
    assert shd.LOGICAL_RULES == jshd.LOGICAL_RULES
    assert shd.population_rules() == jshd.population_rules()
    assert shd.island_rules() == jshd.island_rules()


@pytest.mark.parametrize("dims,names", list(MESHES.values()), ids=list(MESHES))
def test_to_placements_round_trips(dims, names):
    from torch.distributed.tensor import Replicate, Shard

    grid = _grid(dims, names)
    cases = [
        ((32, 64), ("batch", None)),
        ((64, 4096), ("embed", "ffn")),
        ((2, 32, 4096), ("batch", "seq_tp", None)),
        ((48, 4, 4096, 8, 128), (None, "batch", None, "kv_heads", "head_dim")),
        ((6, 12), ("island", "population")),
        ((7,), ("batch",)),
    ]
    for shape, axes in cases:
        spec = shd.logical_spec(shape, axes, grid)
        placements = shd.to_placements(spec, grid)
        assert len(placements) == len(dims)
        assert shd.from_placements(placements, len(shape), grid) == spec
        for i, name in enumerate(names):
            held = [d for d, e in enumerate(spec)
                    if e == name or (isinstance(e, tuple) and name in e)]
            assert placements[i] == (Shard(held[0]) if held else Replicate())


def test_composed_axes_shard_one_dim_on_each_mesh_dim():
    from torch.distributed.tensor import Replicate, Shard

    grid = _grid((2, 16, 16), ("pod", "data", "model"))
    spec = shd.logical_spec((256, 4096), ("batch", None), grid)
    assert spec == (("pod", "data"), None)
    assert shd.to_placements(spec, grid) == (Shard(0), Shard(0), Replicate())
    with pytest.raises(ValueError):
        shd.to_placements((("data", "pod"), None), grid)


@pytest.mark.parametrize("n,k", [(8, 3), (8, 4), (6, 4), (5, 5), (2, 3), (1, 2), (7, 1)])
def test_island_mesh_factoring_matches_reference(n, k):
    devs = [torch.device("cpu")] * n
    jmesh_shape = _reference_island_shape(n, k)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        grid = shd.island_mesh(k, devices=devs)
    assert grid.dims == jmesh_shape
    used = grid.dims[0] * grid.dims[1]
    dropped = [w for w in rec if "island_mesh" in str(w.message)]
    if k <= n and used != n:
        assert len(dropped) == 1 and f"dropping [{', '.join(['cpu'] * (n - used))}]" in str(
            dropped[0].message)
    else:
        assert not dropped
    assert grid.shape == dict(zip(("island", "data"), jmesh_shape))


def _reference_island_shape(n: int, k: int) -> tuple[int, int]:
    """The reference's ``island_mesh`` factoring (its body, on a count)."""
    group = n // k
    if group < 1:
        return (1, n)
    return (k, group)


def test_island_mesh_keeps_the_first_devices_in_order():
    devs = [torch.device("cpu", i) for i in range(7)]
    with pytest.warns(UserWarning, match="dropping"):
        grid = shd.island_mesh(3, devices=devs)
    assert [d.index for d in grid.devices] == [0, 1, 2, 3, 4, 5]


def test_grids_need_devices_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shd.population_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shd.island_mesh(2)
    grid = shd.population_mesh(devices=["cpu", "cpu"])
    assert grid.shape == {"data": 2} and grid.size == 2
    with pytest.raises(ValueError):
        shd.island_mesh(0, devices=["cpu"])


def test_act_constrain_is_a_no_op_outside_a_mesh_and_on_plain_tensors():
    x = torch.randn(4, 8)
    assert shd.act_constrain(x, ("batch", None)) is x
    with shd.activation_mesh(_grid((2, 2), ("data", "model"))):
        assert shd.act_constrain(x, ("batch", None)) is x
        assert shd.act_reshape(x, (4, 2, 4), ("batch", "heads", None)).shape == (4, 2, 4)
        assert shd.lm_act_axes(3) == ("batch", "seq_tp", None)
        assert shd.attn_q_axes(4) == ("batch", None, "heads", None)
        assert shd.attn_q_axes(3) == ("batch", "seq_tp", None, None)
        assert not shd.moe_stationary()
    with shd.activation_mesh(_grid((2, 2), ("data", "model")),
                             {"expert_ffn": ("data",), "expert_embed": None}):
        assert shd.moe_stationary()
    assert shd.lm_act_axes(3) == ("batch", None, None)


def test_shard_tree_matches_reference():
    dims, names = MESHES["16x16"]
    jmesh = AbstractMesh(dims, names)
    specs = build_model(registry.get("qwen3-32b")).param_specs()
    shapes_ = {k: s for k, (s, _, _) in specs.items()}
    axes = {k: a for k, (_, a, _) in specs.items()}
    got = shd.shard_tree(shapes_, axes, _grid(dims, names))
    want = jshd.shard_tree(shapes_, axes, jmesh)
    assert {k: v.spec for k, v in got.items()} == {k: tuple(v.spec) for k, v in want.items()}
    assert all(v.placements == shd.to_placements(v.spec, v.mesh) for v in got.values())
