"""The port's whisper (audio family) against the reference, on the CPU.

The reference's parameters (``init_params`` of ``registry.reduced``
whisper-medium: 2 encoder and 2 decoder layers, d 64, 4 heads,
max_target_len 16) are carried across with ``convert.lm_params_from_jax``;
frames and tokens come from a numpy seed.  Both packages run in fp32.  The
frames go through the pruned-ADC frontend (the port's searchsorted route on
the CPU, as the reference's model path).

Tolerances, those of ``tests/test_torch_serving.py``:
* ``encode``, ``build_cross_cache``, ``decode_train``, ``decode_step``
  logits and caches against the reference: atol = rtol = 1e-4 (fp32 sums
  in another order);
* the port's own decode steps against its ``decode_train``: atol = rtol =
  2e-3;
* nothing written past ``max_target_len`` and ``serve.run``: exact.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import whisper as jwhisper  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build_model, init_cache, whisper  # noqa: E402

REF = dict(atol=1e-4, rtol=1e-4)
SELF = dict(atol=2e-3, rtol=2e-3)
ARCH = "whisper-medium"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are tiny, and the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def carried():
    jcfg = jregistry.reduced(jregistry.get(ARCH))
    jparams = jbuild(jcfg).init_params(jax.random.PRNGKey(7))
    cfg = registry.reduced(registry.get(ARCH))
    params = lm_params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, cfg, "cpu")
    return jcfg, jparams, cfg, params


def _frames(cfg, B, T, seed):
    rng = np.random.default_rng(seed)
    fr = rng.uniform(0, 1, (B, T, cfg.d_model)).astype(np.float32)
    fr[0, 0, :16] = np.arange(16) / 16  # exactly on the comparators
    return fr


@pytest.fixture(scope="module")
def encoded(carried):
    """Frames (B=2, T=12) encoded by both packages, and their cross caches."""
    jcfg, jparams, cfg, params = carried
    fr = _frames(cfg, 2, 12, seed=1)
    jenc = jax.jit(lambda p, f: jwhisper.encode(p, f, jcfg))(jparams, jnp.asarray(fr))
    jxk, jxv = jwhisper.build_cross_cache(jparams, jenc, jcfg)
    with torch.inference_mode():
        enc = whisper.encode(params, torch.from_numpy(fr), cfg)
        xk, xv = whisper.build_cross_cache(params, enc, cfg)
    return (jenc, jxk, jxv), (enc, xk, xv)


def test_encode_and_cross_cache_match_reference(carried, encoded):
    _, _, cfg, _ = carried
    (jenc, jxk, jxv), (enc, xk, xv) = encoded
    assert enc.shape == (2, 12, cfg.d_model)
    assert xk.shape == (cfg.n_layers, 2, 12, cfg.n_kv_heads, cfg.d_model // cfg.n_heads)
    np.testing.assert_allclose(enc.numpy(), np.asarray(jenc), **REF)
    np.testing.assert_allclose(xk.numpy(), np.asarray(jxk), **REF)
    np.testing.assert_allclose(xv.numpy(), np.asarray(jxv), **REF)


def test_decode_train_matches_reference(carried, encoded):
    jcfg, jparams, cfg, params = carried
    (jenc, _, _), (enc, _, _) = encoded
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    want = jax.jit(lambda p, t, e: jwhisper.decode_train(p, t, e, jcfg))(
        jparams, jnp.asarray(tokens), jenc)
    with torch.inference_mode():
        got = whisper.decode_train(params, torch.from_numpy(tokens), enc, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **REF)


def _caches(cfg, jcfg, xk, xv, jxk, jxv):
    B, Te = xk.shape[1], xk.shape[2]
    c = init_cache(build_model(cfg), B, Te, "cpu")
    c["cross_k"].copy_(xk)
    c["cross_v"].copy_(xv)
    jc = {k: jnp.zeros(shape, dtype)
          for k, (shape, _, dtype) in jwhisper.init_cache(jcfg, B, Te).items()}
    jc["cross_k"], jc["cross_v"] = jxk, jxv
    return c, jc


def test_decode_steps_match_reference_and_decode_train(carried, encoded):
    """Ragged rows (row 1 starts 3 later) against the reference's steps, and
    row 0's logits against the port's teacher-forced decoder."""
    jcfg, jparams, cfg, params = carried
    (_, jxk, jxv), (enc, xk, xv) = encoded
    S = 10
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    with torch.inference_mode():
        full = whisper.decode_train(params, torch.from_numpy(tokens), enc, cfg)
    c, jc = _caches(cfg, jcfg, xk, xv, jxk, jxv)
    step = jax.jit(lambda p, t, c, n: jwhisper.decode_step(p, t, c, n, jcfg))
    kv = np.array([0, 3], np.int32)
    for t in range(S):
        tok = tokens[:, t]
        jl, jc = step(jparams, jnp.asarray(tok), jc, jnp.asarray(kv))
        with torch.inference_mode():
            lg, c = whisper.decode_step(params, torch.from_numpy(tok), c, torch.from_numpy(kv),
                                        cfg)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **REF)
        torch.testing.assert_close(lg[0], full[0, t], **SELF)
        kv = kv + 1
    for n in ("self_k", "self_v"):
        np.testing.assert_allclose(c[n].numpy(), np.asarray(jc[n]), **REF)


def test_decode_writes_nothing_past_max_target_len(carried, encoded):
    """A row at kv_len >= max_target_len writes no cache position and reads
    the last decoder position, as the reference's where-update and clamp."""
    jcfg, jparams, cfg, params = carried
    (_, jxk, jxv), (_, xk, xv) = encoded
    c, jc = _caches(cfg, jcfg, xk, xv, jxk, jxv)
    gen = torch.Generator().manual_seed(0)
    for n in ("self_k", "self_v"):
        c[n].normal_(generator=gen)
        jc[n] = jnp.asarray(c[n].numpy())
    before = {n: c[n].clone() for n in ("self_k", "self_v")}
    Smax = cfg.max_target_len
    kv = np.array([Smax + 2, Smax - 1], np.int32)
    tok = np.array([5, 6], np.int32)
    jl, jc = jwhisper.decode_step(jparams, jnp.asarray(tok), jc, jnp.asarray(kv), jcfg)
    with torch.inference_mode():
        lg, c = whisper.decode_step(params, torch.from_numpy(tok), c, torch.from_numpy(kv), cfg)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **REF)
    for n in ("self_k", "self_v"):
        torch.testing.assert_close(c[n][:, 0], before[n][:, 0], rtol=0, atol=0)
        torch.testing.assert_close(c[n][:, 1, : Smax - 1], before[n][:, 1, : Smax - 1],
                                   rtol=0, atol=0)
        np.testing.assert_allclose(c[n].numpy(), np.asarray(jc[n]), **REF)


@pytest.mark.parametrize("arrival_steps", [(), (0, 0, 2, 24)])
def test_serve_run_matches_reference(arrival_steps):
    """The reference serves whisper's decoder alone (zeroed cross caches of
    max_len positions); prompt + generation run past max_target_len (16)."""
    kw = dict(arch=ARCH, reduced=True, max_batch=2, max_len=32, n_requests=4,
              prompt_len=8, gen_len=12, seed=0, arrival_steps=arrival_steps)
    want = jserve.run(jserve.ServeConfig(**kw))
    jparams = jbuild(jregistry.reduced(jregistry.get(ARCH))).init_params(jax.random.PRNGKey(0))
    cfg = registry.reduced(registry.get(ARCH))
    params = lm_params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, cfg, "cpu")
    got = serve.run(serve.ServeConfig(**kw, device="cpu"), params=params)
    for key in ("requests", "decode_steps", "tokens_generated", "peak_active",
                "first_token_step", "finish_step"):
        assert got[key] == want[key], key


def test_model_api_and_param_count_match_reference():
    from repro.models import exact_n_params as jexact
    from repro_torch.models import exact_n_params

    cfg = registry.get(ARCH)
    assert exact_n_params(cfg) == jexact(jregistry.get(ARCH))
    model = build_model(cfg)
    assert model.prefill is None and jbuild(jregistry.get(ARCH)).prefill is None
    specs = model.cache_specs(4, 1500)
    assert specs == jbuild(jregistry.get(ARCH)).cache_specs(4, 1500)
    assert (cfg.d_model // cfg.n_heads, cfg.n_kv_heads) == (64, 16)


def test_init_params_draws_the_reference_layout():
    cfg = registry.reduced(registry.get(ARCH))
    params = whisper.init_params(torch.Generator().manual_seed(0), cfg)
    specs = whisper.param_specs(cfg)
    assert sorted(params) == sorted(specs)
    for name, (shape, _, _) in specs.items():
        assert tuple(params[name].shape) == shape, name
    assert bool((params["x_ln"] == 1).all()) and bool((params["enc_final_norm"] == 1).all())
    assert 0.01 < float(params["pos_dec"].std()) < 0.03
    assert 0.8 < float(params["enc_w1"].std()) * cfg.d_model ** 0.5 < 1.2
