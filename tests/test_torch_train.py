"""The port's training driver (``repro_torch.launch.train``) on the CPU.

The reference's ``launch/train.run`` raises under JAX 0.9.0 (its
``act_constrain`` under the ``Explicit`` mesh, ROADMAP Queue 3 caveats),
so the port's ``run`` is held to the properties the reference's driver test
asserts (``tests/test_train_driver.py``): the loss falls, a crash plus a
resume replays the lost steps, ``int8_ef`` trains; and two resumes from
one checkpoint give the same bits.  The step itself is held to the
reference's ``train_step`` body (``src/repro/launch/train.py:66-73``)
composed from its pieces outside a mesh (``model.loss_fn``,
``jax.value_and_grad``, ``clip_by_global_norm``, ``choose_optimizer``'s
``opt.update``), from carried parameters, for three steps: losses and
gradient norms within ``REF`` (1e-4; measured 4.8e-7 and 1.4e-6), the
parameters and moments after three AdamW updates within ``REF`` too
(measured 3.0e-8 and 1.9e-8; the warmup's lr is still ~4.5e-6).  Then ``choose_optimizer``,
``choose_mesh_shape`` (warnings included) and bf16 checkpoints, against
the reference.
"""

import dataclasses
import importlib.util
import math
import shutil
import warnings
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_lm import PORT_ONLY_DEFAULTS, REF, carried, split_config  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.configs import registry as jregistry  # noqa: E402
from repro.data.tokens import TokenConfig as JTokenConfig  # noqa: E402
from repro.data.tokens import TokenStream as JTokenStream  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.runtime import elastic as jelastic  # noqa: E402
from repro_torch.checkpoint import CheckpointManager, ckpt  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.data.tokens import TokenConfig, TokenStream  # noqa: E402
from repro_torch.launch import steps, train, train_lm  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.runtime import elastic  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are tiny, and the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(tmp_path, **kw):
    base = dict(arch="yi-9b", reduced=True, steps=10, global_batch=4, seq_len=64,
                ckpt_dir=str(tmp_path), ckpt_every=50, log_every=50, device="cpu")
    base.update(kw)
    return train.TrainConfig(**base)


def test_train_loss_decreases(tmp_path):
    out = train.run(_cfg(tmp_path, steps=12))
    assert len(out["losses"]) == 12 and out["start_step"] == 0
    assert out["losses"][-1] < out["losses"][0]
    assert out["mesh_shape"] == (1, 1)
    assert all(math.isfinite(g) and g > 0 for g in out["gnorms"])


def test_crash_and_resume_replays_the_same_bits(tmp_path):
    with pytest.raises(RuntimeError, match="injected device failure"):
        train.run(_cfg(tmp_path / "a", ckpt_every=4, crash_at=6))
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    outs = [train.run(_cfg(tmp_path / d, ckpt_every=4, resume=True)) for d in "ab"]
    for out in outs:
        assert out["start_step"] == 4
        assert len(out["losses"]) == 6  # steps 4..9 replayed
        assert all(math.isfinite(x) for x in out["losses"])
    assert outs[0]["losses"] == outs[1]["losses"]
    for k, p in outs[0]["params"].items():
        assert torch.equal(p, outs[1]["params"][k]), k


def test_train_with_grad_compression(tmp_path):
    """int8_ef trains: its loss falls over 12 steps and follows the
    uncompressed run within the quantization noise.  (Over the reference's
    10 steps this draw falls with neither: each step has another batch and
    the warmup's lr is at most 1.5e-5, 6.8154 -> 6.9875 uncompressed.)"""
    out = train.run(_cfg(tmp_path / "c", steps=12, grad_compression="int8_ef"))
    plain = train.run(_cfg(tmp_path / "p", steps=12))
    assert out["losses"][-1] < out["losses"][0]
    np.testing.assert_allclose(out["losses"], plain["losses"], atol=2e-3)
    assert out["losses"] != plain["losses"]


def test_bf16_checkpoint_resumes_the_same_state(tmp_path, monkeypatch):
    """A bf16 model (params bf16, AdamW moments fp32): the checkpoint holds the
    state after its step bit for bit, and a resume computes from exactly that
    state (its first loss is the saved parameters' loss on that step's batch)."""
    cfg16 = dataclasses.replace(registry.reduced(registry.get("yi-9b")), name="yi-tiny-bf16",
                                dtype="bfloat16")
    monkeypatch.setitem(registry.ARCHS, cfg16.name, cfg16)
    kw = dict(arch=cfg16.name, reduced=False, ckpt_every=4)
    first = train.run(_cfg(tmp_path, steps=5, **kw))  # step_4 and step_5: the state after step 4
    tree, manifest = CheckpointManager(str(tmp_path)).restore(4)
    assert manifest["leaves"]["params/wq"]["dtype"] == "bfloat16"
    assert manifest["leaves"]["opt_mu/wq"]["dtype"] == "float32"
    for k, p in first["params"].items():
        assert p.dtype == tree["params"][k].dtype == torch.bfloat16
        assert torch.equal(tree["params"][k], p), k
    resumed = train.run(_cfg(tmp_path, steps=7, resume=True, **kw))
    assert resumed["start_step"] == 5 and len(resumed["losses"]) == 2
    tcfg = _cfg(tmp_path, **kw)
    stream = TokenStream(TokenConfig(cfg16.vocab_size, tcfg.seq_len, tcfg.global_batch, 0))
    with torch.no_grad():
        want = build_model(cfg16).loss_fn(first["params"],
                                          train.step_batch(stream, 5, cfg16, tcfg, "cpu"))
    assert resumed["losses"][0] == float(want)


def _reference_batch(stream, step, jcfg, B, S):
    """The reference's loop body (``src/repro/launch/train.py:114-137``)."""
    batch = {k: jnp.asarray(v) for k, v in stream.batch_at(step).items()}
    if jcfg.family == "vlm":
        rng = np.random.default_rng(step)
        batch["patch_embeds"] = jnp.asarray(
            rng.uniform(0, 1, (B, jcfg.frontend_len, jcfg.d_model)), jnp.float32)
    if jcfg.family == "audio":
        rng = np.random.default_rng(step)
        batch = {
            "frames": jnp.asarray(rng.uniform(0, 1, (B, S, jcfg.d_model)), jnp.float32),
            "tokens": batch["tokens"][:, : jcfg.max_target_len],
            "labels": batch["labels"][:, : jcfg.max_target_len],
        }
    return batch


@pytest.mark.parametrize("arch", ["yi-9b", "internvl2-26b", "whisper-medium"])
def test_three_steps_match_reference_train_step(arch):
    jmodel, jparams, model, params = carried(arch, seed=0)
    jcfg, cfg = jmodel.cfg, model.cfg
    jopt = jsteps.choose_optimizer(jcfg)

    @jax.jit
    def jstep(p, s, batch):
        loss, grads = jax.value_and_grad(jmodel.loss_fn)(p, batch)
        grads, gnorm = joptim.clip_by_global_norm(grads, 1.0)
        p, s = jopt.update(grads, s, p)
        return p, s, loss, gnorm

    B, S = 2, 32
    tcfg = train.TrainConfig(arch=arch, global_batch=B, seq_len=S, device="cpu")
    _, opt, _, step = train.build_train_state(cfg)
    jstate, state = jopt.init(jparams), opt.init(params)
    comp = None
    jstream = JTokenStream(JTokenConfig(jcfg.vocab_size, S, B, 0))
    stream = TokenStream(TokenConfig(cfg.vocab_size, S, B, 0))
    for i in range(3):
        jbatch = _reference_batch(jstream, i, jcfg, B, S)
        batch = train.step_batch(stream, i, cfg, tcfg, "cpu")
        assert set(batch) == set(jbatch)
        for k in jbatch:
            np.testing.assert_array_equal(batch[k].numpy(), np.asarray(jbatch[k]))
        jparams, jstate, jl, jg = jstep(jparams, jstate, jbatch)
        params, state, comp, loss, gnorm = step(params, state, comp, batch)
        np.testing.assert_allclose(float(loss), float(jl), **REF)
        np.testing.assert_allclose(float(gnorm), float(jg), **REF)
    assert int(state.step) == int(jstate.step) == 3
    for k, want in jparams.items():
        np.testing.assert_allclose(params[k].numpy(), np.asarray(want), err_msg=k, **REF)
        np.testing.assert_allclose(state.mu[k].numpy(), np.asarray(jstate.mu[k]), err_msg=k,
                                   **REF)


@pytest.mark.parametrize("arch", sorted(jregistry.ARCHS))
def test_choose_optimizer_matches_reference(arch):
    want = jsteps.choose_optimizer(jregistry.get(arch))
    got = steps.choose_optimizer(registry.get(arch))
    assert steps.ADAFACTOR_THRESHOLD == jsteps.ADAFACTOR_THRESHOLD
    assert type(got).__name__ == type(want).__name__
    assert type(got).__name__ == ("adafactor" if arch == "arctic-480b" else "adamw")
    for s in (1, 200, 5000):
        np.testing.assert_allclose(float(got.lr(torch.tensor(s))),
                                   float(want.lr(jnp.asarray(s))), rtol=1e-6)


MESH_CASES = [
    (512, 16, 256), (256, 16, 256), (240, 16, 256), (16, 16, 256), (768, 16, 256),
    (20, 2, 8), (24, 4, 6), (16, 8, 4), (21, 2, 8), (16, 2, 8), (1, 1, None), (7, 2, None),
]


@pytest.mark.parametrize("n,tp,per_pod", MESH_CASES)
def test_choose_mesh_shape_matches_reference(n, tp, per_pod):
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = jelastic.choose_mesh_shape(n, tp, devices_per_pod=per_pod)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got = elastic.choose_mesh_shape(n, tp, devices_per_pod=per_pod)
    assert got == want
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
    assert [w.category for w in tw] == [w.category for w in jw]


def test_choose_mesh_shape_rejects_too_small():
    for fn in (elastic.choose_mesh_shape, jelastic.choose_mesh_shape):
        with pytest.raises(ValueError):
            fn(8, 16)


def test_bf16_checkpoint_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    params = {"w": torch.from_numpy(rng.normal(size=(4, 6)).astype(np.float32)).bfloat16(),
              "b": torch.tensor([-0.0, float("inf"), float("nan"), 1e-40]).bfloat16()}
    opt = train.steps_mod.choose_optimizer(registry.reduced(registry.get("yi-9b")))
    state = opt.init(params)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, train._state_tree(params, state), block=True)
    mgr.close()
    tree, manifest = CheckpointManager(str(tmp_path)).restore()
    assert manifest["leaves"]["params/w"] == {"shape": [4, 6], "dtype": "bfloat16"}
    for k, p in params.items():
        got = tree["params"][k]
        assert got.dtype == torch.bfloat16
        assert torch.equal(got.view(torch.int16), p.view(torch.int16)), k
    restored = train._restore_opt(opt, params, tree, "cpu")
    assert int(restored.step) == 0 and set(restored.mu) == set(params)


def test_reference_bf16_checkpoint_loads_in_the_port(tmp_path):
    rng = np.random.default_rng(1)
    jtree = {"params": {"w": jnp.asarray(rng.normal(size=(3, 5)), jnp.bfloat16),
                        "x": jnp.asarray(rng.normal(size=(2,)), jnp.float32)},
             "opt_step": jnp.asarray(7, jnp.int32)}
    jckpt.save_pytree(str(tmp_path / "ref"), jtree, step=7)
    tree, manifest = ckpt.load_pytree(str(tmp_path / "ref"))
    assert manifest["step"] == 7
    w = tree["params"]["w"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(w.view(torch.int16).numpy(),
                                  np.asarray(jtree["params"]["w"]).view(np.int16))
    np.testing.assert_array_equal(tree["params"]["x"], np.asarray(jtree["params"]["x"]))
    # the port writes the same payload: the reference's own bf16 leaf and the port's agree
    ckpt.save_pytree(str(tmp_path / "port"), {"params": {"w": w}})
    with np.load(tmp_path / "port" / ckpt.PAYLOAD) as z, \
            np.load(tmp_path / "ref" / ckpt.PAYLOAD) as zr:
        key = "params\x1fw"
        assert z[key].dtype == zr[key].dtype == np.dtype("V2")
        assert z[key].tobytes() == zr[key].tobytes()


def test_hundred_m_config_is_the_examples():
    spec = importlib.util.spec_from_file_location("ref_train_lm", ROOT / "examples" / "train_lm.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    shared, own = split_config(train_lm.hundred_m_config())
    assert shared == dataclasses.asdict(ref.hundred_m_config())
    assert own == PORT_ONLY_DEFAULTS
