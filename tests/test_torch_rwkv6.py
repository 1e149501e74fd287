"""The port's rwkv6 (the ssm family) against the reference, on the CPU.

The reference's parameters (``init_params`` of ``registry.reduced``: 2
layers, d 64, 4 heads of 16, chunk 8) are carried across with
``convert.lm_params_from_jax``; tokens and the WKV inputs come from numpy
seeds; both packages run in fp32.

Tolerances and measured gaps:
* ``_wkv_chunked`` (the recursive form ``forward`` runs; chunks 4 to 32,
  an uneven split at 18) and ``_wkv_chunked_with_state`` (the explicit
  form ``prefill`` runs; output and final state): atol = rtol = 1e-4
  (``REF``); measured at most 1.4e-4 on outputs up to ~30 (within rtol).
* ``_wkv_chunked`` with bf16 ``chunk_dtype``: both packages round the same
  fp32 values to bf16, but a 1-ulp fp32 difference before a cast (XLA's
  exp against torch's) flips a term's rounding now and then.  Held to:
  at least 99% of the elements within ``REF``, and the largest gap at most
  ``BF16_FLIP_SHARE`` (0.1) of the reference's own bf16-vs-fp32 distance
  on the same inputs.  Measured over six seeds: 4e-6 to 2.4e-5, and one
  flip of 5.2e-3 against that distance's 8.4e-2 (CPU).
* ``forward``, ``prefill`` and ``decode_step`` logits and caches: ``REF``;
  measured 3.1e-5 on logits up to 4.2, 1.7e-5 on the states.
* the port's decode against its forward: 5e-3, the reference's bound
  (``tests/test_serving.py``); measured 6.5e-5.
* ``serve.run``: tokens and every scheduling field equal to the
  reference's, all at once and staggered.  The tokens depend on the
  schedule in both packages (the serve loop pushes a prompt through the
  whole batch's recurrent state), so staggered is never held to together.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_lm import (  # noqa: E402
    REF,
    SERVE_FIELDS,
    assert_caches_close,
    carried,
    decode_both,
    self_decode,
    serve_both,
    tokens,
)

from repro.models import rwkv6 as jrwkv6  # noqa: E402
from repro_torch.models import rwkv6  # noqa: E402

ARCH = "rwkv6-1.6b"
BF16_FLIP_SHARE = 0.1  # bf16 chunk_dtype: the largest gap against the reference's own bf16 error


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are tiny, and the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wkv_inputs(B, S, d, seed):
    """r, k, v (B, S, d), log-decays <= 0 (the model's range: -exp(w0 + lora))
    and the bonus u (d,), fp32 numpy."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, S, d)).astype(np.float32) for _ in range(3))
    logw = -np.exp(rng.normal(0.5, 0.7, size=(B, S, d))).astype(np.float32)
    u = rng.normal(size=(d,)).astype(np.float32) * 0.5
    return r, k, v, logw, u


@pytest.mark.parametrize("S,chunk,chunk_dtype", [
    (32, 4, "float32"), (32, 8, "float32"), (32, 16, "float32"), (32, 32, "float32"),
    (36, 18, "float32"),  # 18 -> 9 + 9 -> 4 + 5: halves of unequal length
    (32, 16, "bfloat16"),
])
def test_wkv_chunked_matches_reference(S, chunk, chunk_dtype):
    B, d, H = 2, 64, 4
    r, k, v, logw, u = _wkv_inputs(B, S, d, seed=S + chunk)
    want = jrwkv6._wkv_chunked(*(jnp.asarray(a) for a in (r, k, v, logw, u)), H, chunk,
                               chunk_dtype=jnp.dtype(chunk_dtype))
    got = rwkv6._wkv_chunked(*(torch.from_numpy(a) for a in (r, k, v, logw, u)), H, chunk,
                             chunk_dtype=getattr(torch, chunk_dtype))
    assert got.dtype == torch.float32
    if chunk_dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **REF)
        return
    # bf16: a 1-ulp fp32 difference before a cast (XLA's exp against
    # torch's) can flip one term's bf16 rounding; such flips stay a small
    # part of the reference's own bf16-vs-fp32 distance, and are rare
    want32 = np.asarray(jrwkv6._wkv_chunked(*(jnp.asarray(a) for a in (r, k, v, logw, u)),
                                            H, chunk))
    gap = np.abs(got.numpy() - np.asarray(want))
    assert gap.max() <= BF16_FLIP_SHARE * np.abs(np.asarray(want) - want32).max()
    assert np.isclose(got.numpy(), np.asarray(want), **REF).mean() >= 0.99


@pytest.mark.parametrize("S,chunk", [(32, 8), (24, 24), (16, 64)])
def test_wkv_chunked_with_state_matches_reference(S, chunk):
    B, d, H = 2, 64, 4
    r, k, v, logw, u = _wkv_inputs(B, S, d, seed=S)
    want, wstate = jrwkv6._wkv_chunked_with_state(
        *(jnp.asarray(a) for a in (r, k, v, logw, u)), H, chunk)
    got, state = rwkv6._wkv_chunked_with_state(
        *(torch.from_numpy(a) for a in (r, k, v, logw, u)), H, chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **REF)
    np.testing.assert_allclose(state.numpy(), np.asarray(wstate), **REF)
    # the two forms compute one recurrence
    rec = rwkv6._wkv_chunked(*(torch.from_numpy(a) for a in (r, k, v, logw, u)), H, chunk)
    np.testing.assert_allclose(rec.numpy(), got.numpy(), **REF)


def test_forward_prefill_and_decode_match_reference():
    jmodel, jparams, model, params = carried(ARCH, seed=3)
    toks = tokens(model.cfg, (2, 16), seed=3)
    jlogits, jcache = jax.jit(jmodel.prefill)(jparams, jnp.asarray(toks))
    jfwd = jax.jit(lambda p, t: jrwkv6.forward(p, t, jmodel.cfg))(jparams, toks)
    with torch.inference_mode():
        logits, cache = model.prefill(params, torch.from_numpy(toks))
        fwd = rwkv6.forward(params, torch.from_numpy(toks), model.cfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **REF)
    np.testing.assert_allclose(fwd.numpy(), np.asarray(jfwd), **REF)
    assert_caches_close(cache, jcache)
    assert cache["wkv_state"].dtype == torch.float32
    _, c, jc = decode_both(jmodel, jparams, model, params, toks, max_len=16)
    assert_caches_close(c, jc)


def test_bf16_cache_dtypes_follow_the_reference():
    """In bf16 the wkv state stays fp32 and the token-shift buffers take the
    model's dtype, in prefill and in the zeroed serving cache."""
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.models import build_model, init_cache

    cfg = dataclasses.replace(registry.reduced(registry.get(ARCH)), dtype="bfloat16")
    model = build_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(tokens(cfg, (1, 8), seed=0))
    with torch.inference_mode():
        logits, cache = model.prefill(params, toks)
        c = init_cache(model, 1, 8, "cpu")
        step, c = model.decode_step(params, toks[:, 0], c, torch.zeros(1, dtype=torch.int32))
    for cc in (cache, c):
        assert cc["wkv_state"].dtype == torch.float32
        assert cc["tm_prev"].dtype == cc["cm_prev"].dtype == torch.bfloat16
    assert logits.dtype == step.dtype == torch.bfloat16


def test_decode_matches_forward():
    """The recurrent decode against the chunked forward (two chunks of 8)."""
    _, _, model, params = carried(ARCH, seed=2)
    toks = tokens(model.cfg, (2, 16), seed=2)
    with torch.inference_mode():
        full = rwkv6.forward(params, torch.from_numpy(toks), model.cfg)
    self_decode(model, params, toks, full, max_len=16, tol=5e-3)


SERVE = dict(max_batch=2, max_len=32, n_requests=4, prompt_len=4, gen_len=6, seed=0)


@pytest.mark.parametrize("kw", [{}, {"arrival_steps": (0, 1, 3, 5)},
                                {"max_batch": 4, "arrival_steps": (0, 0, 2, 24)}])
def test_serve_run_matches_reference(kw):
    got, want = serve_both(ARCH, **{**SERVE, **kw})
    for key in SERVE_FIELDS:
        assert got[key] == want[key], key
