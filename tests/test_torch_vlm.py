"""The port's VLM path (internvl2 backbone + the pruned-ADC patch frontend)
against the reference, on the CPU.

The reference's parameters (``init_params`` of ``registry.reduced``
internvl2-26b: 2 layers, d 64, 4:1 GQA, 8 patches) are carried across with
``convert.lm_params_from_jax``; tokens and patch embeddings come from a
numpy seed.  Both packages run in fp32.  On the CPU the frontend takes the
port's searchsorted route, as the reference's model path does; its levels
equal K1's (``tests/test_torch_frontend.py``).

Tolerances, those of ``tests/test_torch_serving.py``:
* prefill / forward / decode logits and caches against the reference:
  atol = rtol = 1e-4 (fp32 sums in another order);
* the port's own decode against its prefill: atol = rtol = 2e-3;
* the frontend's fixed point and ``serve.run``: exact.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.core import adc  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import build_model, init_cache, transformer  # noqa: E402

REF = dict(atol=1e-4, rtol=1e-4)
SELF = dict(atol=2e-3, rtol=2e-3)
ARCH = "internvl2-26b"


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
    jmodel = jbuild(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(5))
    cfg = registry.reduced(registry.get(ARCH))
    params = lm_params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, cfg, "cpu")
    return jmodel, jparams, build_model(cfg), params


def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    pe = rng.uniform(0, 1, (B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    pe[0, 0, :16] = np.arange(16) / 16  # exactly on the comparators
    return tokens, pe


def test_prefill_and_forward_with_patches_match_reference(carried):
    jmodel, jparams, model, params = carried
    cfg = model.cfg
    tokens, pe = _batch(cfg, 2, 6, seed=1)
    jlogits, jcache = jax.jit(jmodel.prefill)(jparams, jnp.asarray(tokens), jnp.asarray(pe))
    jfwd = jax.jit(lambda p, t, e: jtransformer.forward(p, t, jmodel.cfg, e))(
        jparams, tokens, pe)
    with torch.inference_mode():
        logits, cache = model.prefill(params, torch.from_numpy(tokens), torch.from_numpy(pe))
        fwd = transformer.forward(params, torch.from_numpy(tokens), cfg, torch.from_numpy(pe))
    P = cfg.frontend_len
    assert logits.shape == (2, P + 6, cfg.padded_vocab)
    assert cache["k"].shape == (cfg.n_layers, 2, P + 6, cfg.n_kv_heads, cfg.hd)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **REF)
    np.testing.assert_allclose(fwd.numpy(), np.asarray(jfwd), **REF)
    for n in ("k", "v"):
        np.testing.assert_allclose(cache[n].numpy(), np.asarray(jcache[n]), **REF)


def test_prefill_without_patches_is_the_dense_path(carried):
    """patch_embeds=None: tokens only, as the reference (and serve.run) use it."""
    jmodel, jparams, model, params = carried
    tokens, _ = _batch(model.cfg, 2, 7, seed=2)
    jlogits, _ = jax.jit(jmodel.prefill)(jparams, jnp.asarray(tokens))
    with torch.inference_mode():
        logits, _ = model.prefill(params, torch.from_numpy(tokens))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **REF)


def test_frontend_is_applied_and_grid_values_are_its_fixed_points(carried):
    """prefill(pe) == prefill(quantized pe) bit for bit, and != with the frontend off."""
    _, _, model, params = carried
    cfg = model.cfg
    tokens, pe = _batch(cfg, 2, 5, seed=3)
    mask = torch.ones(cfg.d_model, 1 << cfg.frontend_adc_bits, dtype=torch.bool)
    pe_t = torch.from_numpy(pe)
    on_grid = adc.levels_to_values(adc.quantize_pruned(pe_t, mask, cfg.frontend_adc_bits),
                                   cfg.frontend_adc_bits)
    off = dataclasses.replace(cfg, use_pruned_frontend=False)
    with torch.inference_mode():
        a, _ = model.prefill(params, torch.from_numpy(tokens), pe_t)
        b, _ = model.prefill(params, torch.from_numpy(tokens), on_grid)
        c, _ = transformer.prefill(params, torch.from_numpy(tokens), off, pe_t)
    assert torch.equal(a, b)
    assert not torch.allclose(a, c, **REF)


def test_decode_after_patch_prefill_matches_reference_and_prefill(carried):
    """Prefill patches + a prompt, copy the cache into a longer one, decode on
    at kv_len = P + S: the logits follow the reference's decode steps and the
    port's own prefill of the whole sequence."""
    jmodel, jparams, model, params = carried
    cfg = model.cfg
    B, S0, S = 2, 3, 8
    tokens, pe = _batch(cfg, B, S, seed=4)
    P = cfg.frontend_len
    Smax = P + S + 2
    with torch.inference_mode():
        full, _ = model.prefill(params, torch.from_numpy(tokens), torch.from_numpy(pe))
        _, pre = model.prefill(params, torch.from_numpy(tokens[:, :S0]), torch.from_numpy(pe))
    _, jpre = jax.jit(jmodel.prefill)(jparams, jnp.asarray(tokens[:, :S0]), jnp.asarray(pe))
    cache = init_cache(model, B, Smax, "cpu")
    jc = {}
    for n in ("k", "v"):
        cache[n][:, :, : P + S0] = pre[n]
        jc[n] = jnp.zeros(cache[n].shape, jnp.float32).at[:, :, : P + S0].set(jpre[n])
    kv = np.full((B,), P + S0, np.int32)
    step = jax.jit(jmodel.decode_step)
    for t in range(S0, S):
        tok = tokens[:, t]
        jl, jc = step(jparams, jnp.asarray(tok), jc, jnp.asarray(kv))
        with torch.inference_mode():
            lg, cache = model.decode_step(params, torch.from_numpy(tok), cache,
                                          torch.from_numpy(kv))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **REF)
        torch.testing.assert_close(lg, full[:, P + t], **SELF)
        kv = kv + 1
    for n in ("k", "v"):
        np.testing.assert_allclose(cache[n].numpy(), np.asarray(jc[n]), **REF)


def test_greedy_tokens_match_reference(carried):
    """Greedy decode after a patch prefill gives the reference's tokens."""
    jmodel, jparams, model, params = carried
    cfg = model.cfg
    B, S, n_new = 2, 4, 6
    tokens, pe = _batch(cfg, B, S, seed=6)
    P, V = cfg.frontend_len, cfg.vocab_size
    Smax = P + S + n_new
    jl, jpre = jax.jit(jmodel.prefill)(jparams, jnp.asarray(tokens), jnp.asarray(pe))
    with torch.inference_mode():
        lg, pre = model.prefill(params, torch.from_numpy(tokens), torch.from_numpy(pe))
    cache = init_cache(model, B, Smax, "cpu")
    jc = {}
    for n in ("k", "v"):
        cache[n][:, :, : P + S] = pre[n]
        jc[n] = jnp.zeros(cache[n].shape, jnp.float32).at[:, :, : P + S].set(jpre[n])
    ours = [lg[:, -1, :V].argmax(-1)]
    theirs = [np.asarray(jnp.argmax(jl[:, -1, :V], -1))]
    kv = np.full((B,), P + S, np.int32)
    step = jax.jit(jmodel.decode_step)
    for _ in range(n_new - 1):
        jl, jc = step(jparams, jnp.asarray(theirs[-1], jnp.int32), jc, jnp.asarray(kv))
        with torch.inference_mode():
            lg, cache = model.decode_step(params, ours[-1].to(torch.int32), cache,
                                          torch.from_numpy(kv))
        ours.append(lg[:, :V].argmax(-1))
        theirs.append(np.asarray(jnp.argmax(jl[:, :V], -1)))
        kv = kv + 1
    np.testing.assert_array_equal(torch.stack(ours, 1).numpy(), np.stack(theirs, 1))


@pytest.mark.parametrize("arrival_steps", [(), (0, 0, 2, 24)])
def test_serve_run_matches_reference(arrival_steps):
    kw = dict(arch=ARCH, reduced=True, max_batch=2, max_len=32, n_requests=4,
              prompt_len=4, gen_len=6, seed=0, arrival_steps=arrival_steps)
    want = jserve.run(jserve.ServeConfig(**kw))
    jparams = jbuild(jregistry.reduced(jregistry.get(ARCH))).init_params(jax.random.PRNGKey(0))
    cfg = registry.reduced(registry.get(ARCH))
    params = lm_params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, cfg, "cpu")
    got = serve.run(serve.ServeConfig(**kw, device="cpu"), params=params)
    for key in ("requests", "decode_steps", "tokens_generated", "peak_active",
                "first_token_step", "finish_step"):
        assert got[key] == want[key], key


def test_param_count_matches_reference():
    from repro.models import exact_n_params as jexact
    from repro_torch.models import exact_n_params

    cfg = registry.get(ARCH)
    assert exact_n_params(cfg) == jexact(jregistry.get(ARCH))
    assert "patch_proj" in build_model(cfg).param_specs()
