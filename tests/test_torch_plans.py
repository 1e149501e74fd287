"""The port's cell plans (``repro_torch.launch.{shapes, steps}``) against the
reference's ``repro.launch.{shapes, steps}``.

The reference's ``build_plan`` runs on a ``jax.sharding.AbstractMesh``
(no devices); the port's runs in a subprocess on a fake ``DeviceMesh`` of
the same shape (PyTorch's ``fake`` process-group backend at world 256 and
512).  Every sharding of every run plan (parameters, optimizer state,
caches, inputs and outputs) is held equal, spec for spec, and its DTensor
placements to ``to_placements`` of the reference's spec.  Then the shape
sets and skips, ``fix_cache_axes`` and Adafactor's row/col rule directly,
the prefill outputs the plans derive from ``cache_specs`` against a real
prefill, and reduced yi-9b, phi3.5-moe, rwkv6 and zamba2 on a 2x2 gloo
mesh (4 processes) with DTensor parameters against the same steps in one
process:
train steps (yi-9b the reference's 5, the others 2), the losses within
``LOSS_TOL`` and falling (the counterpart of the reference's
``test_sharded_train_step_runs_on_mesh``); the plan's
prefill and a decode step (for the attention families against a
sequence-split cache: flash-decode), logits and caches within ``SERVE_TOL``.
"""

import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from _torch_dist import last_json, run_py, run_ranks  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.launch import shapes as jshapes  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import shapes, steps  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.parallel import sharding as shd  # noqa: E402

MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
RUN_CELLS = [(a, c.shape) for a in sorted(registry.ARCHS)
             for c in shapes.cell_plan(registry.get(a)) if c.status == "run"]
# fp32 loss of a 2x2 DTensor step against one process
LOSS_TOL = 1e-5  # measured: yi-9b 9.5e-7, phi3.5-moe 4.8e-7
# yi-9b takes the reference test's 5 steps; the others 2 (the loss, then
# after one update): rwkv6's and zamba2's gradients at init are
# ill-conditioned (ROADMAP Queue 3 caveats), so a reordered sum moves their
# later AdamW steps (measured 1.1e-4 and 3.7e-4 apart at the fifth step)
TRAIN_STEPS = {"yi-9b": 5}
SERVE_TOL = 1e-4  # fp32 logits and caches (the port's REF); measured <= 2.1e-5

_DUMP = """
import json, math, sys
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import registry
from repro_torch.launch import shapes, steps
from repro_torch.parallel import sharding as shd


def flat(tree, prefix, out):
    if isinstance(tree, shd.Sharding):
        out[prefix] = [[list(e) if isinstance(e, tuple) else e for e in tree.spec],
                       [str(p) for p in tree.placements]]
    elif isinstance(tree, dict):
        for k in tree:
            flat(tree[k], f"{{prefix}}/{{k}}", out)
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            flat(v, f"{{prefix}}/{{k}}", out)
    else:
        for i, v in enumerate(tree):
            flat(v, f"{{prefix}}/{{i}}", out)

res = {{}}
for name, (dims, names) in {meshes!r}.items():
    dist.init_process_group("fake", rank=0, world_size=math.prod(dims), store=FakeStore())
    mesh = init_device_mesh("cpu", dims, mesh_dim_names=names)
    res[name] = {{}}
    for arch in sorted(registry.ARCHS):
        cfg = registry.get(arch)
        for cell in shapes.cell_plan(cfg):
            if cell.status != "run":
                continue
            plan = steps.build_plan(cfg, cell.shape, mesh)
            out = {{}}
            flat(plan.in_shardings, "in", out)
            flat(plan.out_shardings, "out", out)
            res[name][f"{{arch}}|{{cell.shape}}"] = {{"shardings": out,
                                                  "donate": list(plan.donate_argnums)}}
    dist.destroy_process_group()
print(json.dumps(res))
"""


@pytest.fixture(scope="module")
def port_plans():
    return last_json(run_py(_DUMP.format(meshes=MESHES), timeout=120))


def _ref_flat(tree, prefix, out, mesh_dims, names):
    from jax.sharding import NamedSharding

    if isinstance(tree, NamedSharding):
        spec = tuple(tree.spec)
        grid = shd.DeviceGrid((torch.device("cpu"),) * _prod(mesh_dims), names, mesh_dims)
        out[prefix] = [[list(e) if isinstance(e, tuple) else e for e in spec],
                       [str(p) for p in shd.to_placements(spec, grid)]]
    elif isinstance(tree, dict):
        for k in tree:
            _ref_flat(tree[k], f"{prefix}/{k}", out, mesh_dims, names)
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            _ref_flat(v, f"{prefix}/{k}", out, mesh_dims, names)
    else:
        for i, v in enumerate(tree):
            _ref_flat(v, f"{prefix}/{i}", out, mesh_dims, names)


def _prod(xs):
    n = 1
    for x in xs:
        n *= x
    return n


def test_shapes_and_cell_plans_match_reference():
    assert {k: dataclasses.astuple(v) for k, v in shapes.SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in jshapes.SHAPES.items()}
    assert shapes.SKIP == jshapes.SKIP
    cells = [c for a in sorted(registry.ARCHS) for c in shapes.cell_plan(registry.get(a))]
    jcells = [c for a in sorted(jregistry.ARCHS) for c in jshapes.cell_plan(jregistry.get(a))]
    assert [dataclasses.astuple(c) for c in cells] == [dataclasses.astuple(c) for c in jcells]
    assert sum(c.status == "run" for c in cells) == 32
    assert sum(c.status == shapes.SKIP for c in cells) == 8


@pytest.mark.parametrize("arch", sorted(registry.ARCHS))
def test_input_specs_match_reference(arch):
    for name in shapes.SHAPES:
        kind, inputs, axes = shapes.input_specs(registry.get(arch), name)
        jkind, jinputs, jaxes = jshapes.input_specs(jregistry.get(arch), name)
        assert kind == jkind and axes == jaxes
        assert {k: (tuple(s), dt) for k, (s, dt) in inputs.items()} == {
            k: (tuple(v.shape), str(v.dtype)) for k, v in jinputs.items()}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,shape", RUN_CELLS)
def test_plan_shardings_match_reference(port_plans, arch, shape, mesh_name):
    dims, names = MESHES[mesh_name]
    jplan = jsteps.build_plan(jregistry.get(arch), shape, AbstractMesh(dims, names))
    want = {}
    _ref_flat(jplan.in_shardings, "in", want, dims, names)
    _ref_flat(jplan.out_shardings, "out", want, dims, names)
    got = port_plans[mesh_name][f"{arch}|{shape}"]
    assert got["shardings"] == json.loads(json.dumps(want))
    assert tuple(got["donate"]) == tuple(jplan.donate_argnums)


@pytest.mark.parametrize("arch", ["arctic-480b", "yi-9b", "rwkv6-1.6b"])
def test_opt_state_shardings_match_reference(arch):
    """Adafactor's row/col rule (arctic) and AdamW's mirror, exactly."""
    dims, names = MESHES["pod16x16"]
    jmesh = AbstractMesh(dims, names)
    grid = shd.DeviceGrid((torch.device("cpu"),) * 256, names, dims)
    cfg, jcfg = registry.get(arch), jregistry.get(arch)
    pspecs = build_model(cfg).param_specs()
    structs = steps.specs_to_structs(pspecs)
    psh = steps.specs_to_shardings(pspecs, grid)
    opt = steps.choose_optimizer(cfg)
    got = steps.opt_state_shardings(opt, structs, psh, grid)
    from repro.models import build_model as jbuild

    jspecs = jbuild(jcfg).param_specs()
    jopt = jsteps.choose_optimizer(jcfg)
    want = jsteps.opt_state_shardings(jopt, jsteps.specs_to_structs(jspecs),
                                      jsteps.specs_to_shardings(jspecs, jmesh), jmesh)
    assert type(got).__name__ == type(want).__name__ and got._fields == want._fields
    for field, g, w in zip(got._fields, got, want):
        if isinstance(w, dict):
            assert {k: v.spec for k, v in g.items()} == {k: tuple(v.spec) for k, v in w.items()}
        else:
            assert g.spec == tuple(w.spec), field


@pytest.mark.parametrize("arch", ["arctic-480b", "yi-9b", "whisper-medium", "zamba2-2.7b"])
@pytest.mark.parametrize("dims", [(16, 16), (2, 2), (4, 4)])
def test_fix_cache_axes_matches_reference(arch, dims):
    names = ("data", "model")
    jmesh = AbstractMesh(dims, names)
    grid = shd.DeviceGrid((torch.device("cpu"),) * _prod(dims), names, dims)
    sp = shapes.SHAPES["decode_32k"]
    cache = build_model(registry.get(arch)).cache_specs(sp.global_batch, sp.seq_len)
    from repro.models import build_model as jbuild

    jcache = jbuild(jregistry.get(arch)).cache_specs(sp.global_batch, sp.seq_len)
    got = steps.fix_cache_axes(cache, registry.get(arch), grid)
    want = jsteps.fix_cache_axes(jcache, jregistry.get(arch), jmesh)
    assert {k: (tuple(s), tuple(a), d) for k, (s, a, d) in got.items()} == {
        k: (tuple(s), tuple(a), d) for k, (s, a, d) in want.items()}


@pytest.mark.parametrize("arch", ["yi-9b", "internvl2-26b", "whisper-medium", "rwkv6-1.6b",
                                  "zamba2-2.7b", "phi3.5-moe-42b-a6.6b"])
def test_prefill_output_shapes_are_the_steps(arch):
    """The plan derives the prefill outputs from ``cache_specs``; a real
    prefill of the reduced config gives those shapes."""
    cfg = registry.reduced(registry.get(arch))
    sp = shapes.ShapeSpec("prefill_32k", "prefill", 24, 2)
    grid = shd.DeviceGrid((torch.device("cpu"),), ("data", "model"), (1, 1))
    plan = steps.build_plan(cfg, "prefill_32k", grid, shape=sp)
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0))
    _, inputs, _ = shapes.input_specs(cfg, "prefill_32k", sp)
    batch = {k: (torch.randint(0, cfg.vocab_size, s) if dt == "int32"
                 else torch.rand(s)) for k, (s, dt) in inputs.items()}
    with torch.no_grad():
        out = plan.step_fn(params, batch)
    want = steps._prefill_shapes(model, cfg, plan.args[1])

    def shapes_of(tree):
        if isinstance(tree, dict):
            return {k: shapes_of(v) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return [shapes_of(v) for v in tree]
        return tuple(tree.shape)

    assert shapes_of(out) == shapes_of(want)


_GLOO_TRAIN = """
import dataclasses
import json
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch import optim
from repro_torch.configs import registry
from repro_torch.data.tokens import TokenConfig, TokenStream
from repro_torch.launch import shapes, steps
from repro_torch.models import build_model
from repro_torch.parallel import sharding as shd

torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(STORE, WORLD), rank=RANK, world_size=WORLD)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))


def place(t, sh):
    return distribute_tensor(t, mesh, list(sh.placements))


def config(name):
    cfg = registry.reduced(registry.get(name.split(":")[0]))
    return dataclasses.replace(cfg, **GLOO_CONFIGS.get(name, {}))


def losses_of(arch):
    cfg = config(arch)
    sp = shapes.ShapeSpec("train_4k", "train", 32, 8)
    plan = steps.build_plan(cfg, "train_4k", mesh, shape=sp, opt=optim.adamw(lr=1e-3))
    params = build_model(cfg).init_params(torch.Generator().manual_seed(0))
    opt_state = optim.adamw(lr=1e-3).init(params)
    psh, osh, ish = plan.in_shardings
    params = {k: place(v, psh[k]) for k, v in params.items()}
    opt_state = type(opt_state)(*(
        {k: place(v, s[k]) for k, v in f.items()} if isinstance(f, dict) else place(f, s)
        for f, s in zip(opt_state, osh)))
    stream = TokenStream(TokenConfig(cfg.vocab_size, sp.seq_len, sp.global_batch, 0))
    batch = {k: place(torch.from_numpy(v).long(), ish[k])
             for k, v in stream.batch_at(0).items()}
    losses = []
    with shd.activation_mesh(mesh), implicit_replication():
        for step in range(TRAIN_STEPS.get(arch, 2)):
            params, opt_state, loss = plan.step_fn(params, opt_state, batch)
            losses.append(float(loss.full_tensor()))
    return losses


def serve_gaps(arch):
    # the plan's prefill and serve steps on the mesh against the model's own
    # on plain tensors: max |gap| of the logits and of the cache
    cfg = config(arch)
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (4, 32), generator=gen)
    pre = steps.build_plan(cfg, "prefill_32k", mesh,
                           shape=shapes.ShapeSpec("prefill_32k", "prefill", 32, 4))
    dec = steps.build_plan(cfg, "decode_32k", mesh,
                           shape=shapes.ShapeSpec("decode_32k", "decode", 32, 4))
    dparams = {k: place(v, pre.in_shardings[0][k]) for k, v in params.items()}
    with torch.no_grad():
        want_logits, want_cache = model.prefill(params, tokens)
        with shd.activation_mesh(mesh), implicit_replication():
            logits, cache = pre.step_fn(dparams, {"tokens": place(tokens,
                                                                 pre.in_shardings[1]["tokens"])})
        gaps = {"prefill_logits": (logits.full_tensor() - want_logits).abs().max().item(),
                "prefill_cache": max((cache[k].full_tensor() - want_cache[k]).abs().max().item()
                                     for k in want_cache)}
        tok = tokens[:, -1]
        kv_len = torch.tensor([3, 17, 30, 31], dtype=torch.int32)
        c0 = {k: v.clone() for k, v in want_cache.items()}
        want_d, want_c = model.decode_step(params, tok, c0, kv_len)
        _, ish_tok, csh, ish_len = dec.in_shardings
        dcache = {k: place(v, csh[k]) for k, v in want_cache.items()}
        with shd.activation_mesh(mesh), implicit_replication():
            got_d, got_c, nxt = dec.step_fn(dparams, place(tok, ish_tok), dcache,
                                            place(kv_len, ish_len))
        gaps["decode_logits"] = (got_d.full_tensor() - want_d).abs().max().item()
        gaps["decode_cache"] = max((got_c[k].full_tensor() - want_c[k]).abs().max().item()
                                   for k in want_c)
        gaps["kv_len_next"] = bool(torch.equal(nxt.full_tensor(), kv_len + 1))
        gaps["cache_split"] = [str(p) for p in csh[next(iter(csh))].placements]
    return gaps


print(json.dumps({arch: {"losses": losses_of(arch), "serve": serve_gaps(arch)}
                  for arch in GLOO_ARCHS}))
dist.destroy_process_group()
"""
# arctic cut to 3 heads (d_model 48): TP 2 does not divide them, so the layer
# runs context-parallel (seq_tp), as arctic's 56 heads do on TP 16
GLOO_CONFIGS = {"arctic-480b:seq_tp": dict(d_model=48, n_heads=3, n_kv_heads=1)}
GLOO_ARCHS = ("yi-9b", "phi3.5-moe-42b-a6.6b", "rwkv6-1.6b", "zamba2-2.7b",
              "arctic-480b:seq_tp")


def _config(name):
    cfg = registry.reduced(registry.get(name.split(":")[0]))
    return dataclasses.replace(cfg, **GLOO_CONFIGS.get(name, {}))


@pytest.fixture(scope="module")
def gloo_losses():
    code = (f"GLOO_ARCHS = {GLOO_ARCHS!r}\nGLOO_CONFIGS = {GLOO_CONFIGS!r}\n"
            f"TRAIN_STEPS = {TRAIN_STEPS!r}\n" + _GLOO_TRAIN)
    outs = [last_json(o) for o in run_ranks(code, 4, timeout=120)]
    assert all(o == outs[0] for o in outs)  # every rank reads the same loss
    return outs[0]


@pytest.mark.parametrize("arch", GLOO_ARCHS)
def test_train_step_on_a_2x2_gloo_mesh_matches_one_process(gloo_losses, arch):
    from repro_torch.data.tokens import TokenConfig, TokenStream

    got = gloo_losses[arch]["losses"]
    from repro_torch import optim

    cfg = _config(arch)
    sp = shapes.ShapeSpec("train_4k", "train", 32, 8)
    grid = shd.DeviceGrid((torch.device("cpu"),), ("data", "model"), (1, 1))
    plan = steps.build_plan(cfg, "train_4k", grid, shape=sp, opt=optim.adamw(lr=1e-3))
    params = build_model(cfg).init_params(torch.Generator().manual_seed(0))
    opt_state = optim.adamw(lr=1e-3).init(params)
    stream = TokenStream(TokenConfig(cfg.vocab_size, sp.seq_len, sp.global_batch, 0))
    batch = {k: torch.from_numpy(v).long() for k, v in stream.batch_at(0).items()}
    want = []
    for step in range(TRAIN_STEPS.get(arch, 2)):
        params, opt_state, loss = plan.step_fn(params, opt_state, batch)
        want.append(float(loss))
    gaps = [abs(g - w) for g, w in zip(got, want)]
    print(arch, "loss gaps", gaps)
    assert len(got) == TRAIN_STEPS.get(arch, 2)
    assert max(gaps) <= LOSS_TOL, (got, want)
    assert got[-1] < got[0]


@pytest.mark.parametrize("arch", GLOO_ARCHS)
def test_serve_steps_on_a_2x2_gloo_mesh_match_one_process(gloo_losses, arch):
    """Prefill (attention on local shards, the KV heads gathered) and a decode
    step against a sequence-split cache (flash-decode: softmax statistics
    all-reduced) on DTensors, against the model on plain tensors."""
    gaps = gloo_losses[arch]["serve"]
    print(arch, gaps)
    if arch != "rwkv6-1.6b" and arch != "zamba2-2.7b":
        # 1 KV head: fix_cache_axes splits the cached sequence
        assert any("S(2)" in p or "Shard(dim=2)" in p for p in gaps["cache_split"])
    assert gaps["kv_len_next"]
    for k in ("prefill_logits", "prefill_cache", "decode_logits", "decode_cache"):
        assert gaps[k] <= SERVE_TOL, (k, gaps)
