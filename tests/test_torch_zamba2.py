"""The port's zamba2 (the hybrid family) against the reference, on the CPU.

The reference's parameters (``init_params`` of ``registry.reduced``: 4
Mamba2 layers, the shared attention block every 2, d 64, state 16, SSM
heads of 16, chunk 8) are carried across with
``convert.lm_params_from_jax``; tokens and the SSD inputs come from numpy
seeds; both packages run in fp32.

Tolerances and measured gaps:
* ``_ssd_chunked`` (chunks 4 to 32; output and final state), ``_ssd_step``
  and ``_causal_conv`` (zero history and a carried one): atol = rtol = 1e-4
  (``REF``); measured 2.6e-5 (chunked), 9.5e-7 (step), 0 (conv history).
* ``forward``, ``prefill`` and ``decode_step`` logits and caches (the SSM
  and conv states, one KV cache per shared-attention invocation): ``REF``;
  measured 5.8e-5 on logits up to 3.8, 6.7e-5 on the states.
* the port's decode against its forward: 5e-3, the reference's bound
  (``tests/test_serving.py``); measured 4.3e-5.
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

from repro.models import hybrid as jhybrid  # noqa: E402
from repro_torch.models import hybrid  # noqa: E402

ARCH = "zamba2-2.7b"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are tiny, and the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ssd_inputs(B, S, H, hd, N, seed):
    """x (B,S,H,hd), B/C (B,S,N), dt (B,S,H) > 0 (softplus'd), A_log, D (H,)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    Bm, Cm = (rng.normal(size=(B, S, N)).astype(np.float32) for _ in range(2))
    dtv = np.log1p(np.exp(rng.normal(size=(B, S, H)))).astype(np.float32)
    A_log = rng.normal(0.0, 0.5, size=(H,)).astype(np.float32)
    D = rng.normal(size=(H,)).astype(np.float32)
    return x, Bm, Cm, dtv, A_log, D


def _np(t):
    return np.asarray(t)


@pytest.mark.parametrize("S,chunk", [(32, 4), (32, 8), (32, 32), (16, 64)])
def test_ssd_chunked_matches_reference(S, chunk):
    args = _ssd_inputs(2, S, 4, 16, 8, seed=S + chunk)
    want, wh = jhybrid._ssd_chunked(*(jnp.asarray(a) for a in args), chunk)
    got, h = hybrid._ssd_chunked(*(torch.from_numpy(a) for a in args), chunk)
    np.testing.assert_allclose(got.numpy(), _np(want), **REF)
    np.testing.assert_allclose(h.numpy(), _np(wh), **REF)


def test_ssd_step_matches_reference_and_continues_the_chunked_state():
    x, Bm, Cm, dtv, A_log, D = _ssd_inputs(2, 17, 4, 16, 8, seed=7)
    _, h0 = hybrid._ssd_chunked(*(torch.from_numpy(a[:, :16]) for a in (x, Bm, Cm, dtv)),
                                torch.from_numpy(A_log), torch.from_numpy(D), 8)
    one = [a[:, 16:] for a in (x, Bm, Cm, dtv)]
    want, wh = jhybrid._ssd_step(*(jnp.asarray(a) for a in one), jnp.asarray(A_log),
                                 jnp.asarray(D), jnp.asarray(h0.numpy()))
    got, h = hybrid._ssd_step(*(torch.from_numpy(a) for a in one), torch.from_numpy(A_log),
                              torch.from_numpy(D), h0)
    np.testing.assert_allclose(got.numpy(), _np(want), **REF)
    np.testing.assert_allclose(h.numpy(), _np(wh), **REF)
    # the step after 16 chunked tokens gives the chunked form's 17th output
    full, _ = hybrid._ssd_chunked(*(torch.from_numpy(a) for a in (x, Bm, Cm, dtv)),
                                  torch.from_numpy(A_log), torch.from_numpy(D), 17)
    np.testing.assert_allclose(got[:, 0].numpy(), full[:, 16].numpy(), **REF)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(int(with_state))
    x = rng.normal(size=(2, 5, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    b = rng.normal(size=(12,)).astype(np.float32)
    st = rng.normal(size=(2, 3, 12)).astype(np.float32) if with_state else None
    want, wst = jhybrid._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                     None if st is None else jnp.asarray(st))
    got, gst = hybrid._causal_conv(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                                   None if st is None else torch.from_numpy(st))
    np.testing.assert_allclose(got.numpy(), _np(want), **REF)
    np.testing.assert_array_equal(gst.numpy(), _np(wst))


def test_forward_prefill_and_decode_match_reference():
    jmodel, jparams, model, params = carried(ARCH, seed=3)
    toks = tokens(model.cfg, (2, 16), seed=3)
    jlogits, jcache = jax.jit(jmodel.prefill)(jparams, jnp.asarray(toks))
    jfwd = jax.jit(lambda p, t: jhybrid.forward(p, t, jmodel.cfg))(jparams, toks)
    with torch.inference_mode():
        logits, cache = model.prefill(params, torch.from_numpy(toks))
        fwd = hybrid.forward(params, torch.from_numpy(toks), model.cfg)
    np.testing.assert_allclose(logits.numpy(), _np(jlogits), **REF)
    np.testing.assert_allclose(fwd.numpy(), _np(jfwd), **REF)
    assert_caches_close(cache, jcache)
    # decode from empty caches, row 1 starting 3 positions in
    _, c, jc = decode_both(jmodel, jparams, model, params, toks, max_len=20, kv0=[0, 3])
    assert_caches_close(c, jc)


def test_decode_writes_nothing_past_the_kv_cache():
    """A row at kv_len == max_len is written nowhere in the shared blocks'
    caches, as the reference's where-update."""
    jmodel, jparams, model, params = carried(ARCH, seed=4)
    toks = tokens(model.cfg, (2, 3), seed=4)
    _, c, jc = decode_both(jmodel, jparams, model, params, toks, max_len=2, kv0=[2, 0])
    assert_caches_close(c, jc)
    assert not c["sa_k"][:, 0].any() and not c["sa_v"][:, 0].any()


def test_decode_matches_forward():
    _, _, model, params = carried(ARCH, seed=3)
    toks = tokens(model.cfg, (2, 16), seed=3)
    with torch.inference_mode():
        full = hybrid.forward(params, torch.from_numpy(toks), model.cfg)
    self_decode(model, params, toks, full, max_len=16, tol=5e-3)


SERVE = dict(max_batch=2, max_len=32, n_requests=4, prompt_len=4, gen_len=6, seed=0)


@pytest.mark.parametrize("kw", [{}, {"arrival_steps": (0, 1, 3, 5)},
                                {"max_batch": 4, "arrival_steps": (0, 0, 2, 24)}])
def test_serve_run_matches_reference(kw):
    got, want = serve_both(ARCH, **{**SERVE, **kw})
    for key in SERVE_FIELDS:
        assert got[key] == want[key], key
