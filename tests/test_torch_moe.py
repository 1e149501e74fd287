"""The port's MoE family (phi3.5-moe, arctic) against the reference, on the CPU.

The reference's parameters (``init_params`` of ``registry.reduced``: 4
experts top-2, ``expert_d_ff`` 96; arctic with its dense residual MLP) are
carried across with ``convert.lm_params_from_jax``; tokens and activations
come from numpy seeds; both packages run in fp32.

Tolerances and measured gaps:
* routing integers (``topi``, ``pos``, ``keep``, ``C``) exactly equal,
  ties included (a zero router: every gate equal, the lower experts first);
  the renormalised gates ``topv`` within 1e-6 (measured 6.0e-7).
* ``_moe_block`` (measured 7.2e-7, the capacity-drop case included: 29
  of 32 rows zero in both), ``forward``, ``prefill`` and ``decode_step``
  logits and caches: atol = rtol = 1e-4 (``REF``).  Measured at most 4.6e-6
  on logits up to 3.8 (arctic's decode), 2.4e-6 on caches: fp32 matmuls
  summed in another order.
* the port's decode against its prefill: 5e-3, the reference's bound for
  the recurrent families (``tests/test_serving.py``), with
  ``capacity_factor = E / K`` so that a prefill drops nothing (C = S);
  measured 1.9e-6.
* ``serve.run``: tokens and every scheduling field equal, all at once and
  staggered; and staggered equal to together (per-row capacity: the
  reference holds this for MoE).
"""

import dataclasses

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

from repro.configs import registry as jregistry  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

PHI = "phi3.5-moe-42b-a6.6b"
ARCHS = (PHI, "arctic-480b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are tiny, and the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layer(arch, seed, scale=0.5, **over):
    """One layer's MoE params (numpy) and both packages' configs."""
    jcfg = dataclasses.replace(jregistry.reduced(jregistry.get(arch)), **over)
    cfg = dataclasses.replace(registry.reduced(registry.get(arch)), **over)
    rng = np.random.default_rng(seed)
    d, E, eff = cfg.d_model, cfg.n_experts, cfg.expert_d_ff
    lp = {
        "router": rng.normal(size=(d, E)) * scale,
        "we_gate": rng.normal(size=(E, d, eff)) / np.sqrt(d),
        "we_up": rng.normal(size=(E, d, eff)) / np.sqrt(d),
        "we_down": rng.normal(size=(E, eff, d)) / np.sqrt(eff),
    }
    if cfg.moe_dense_residual:
        lp["w_gate"] = rng.normal(size=(d, cfg.d_ff)) / np.sqrt(d)
        lp["w_up"] = rng.normal(size=(d, cfg.d_ff)) / np.sqrt(d)
        lp["w_down"] = rng.normal(size=(cfg.d_ff, d)) / np.sqrt(cfg.d_ff)
    lp = {k: v.astype(np.float32) for k, v in lp.items()}
    return jcfg, cfg, lp


def _both(lp):
    return ({k: jnp.asarray(v) for k, v in lp.items()},
            {k: torch.from_numpy(v) for k, v in lp.items()})


@pytest.mark.parametrize("arch,B,S,zero_router", [
    (PHI, 2, 16, False), (PHI, 3, 1, False), ("arctic-480b", 2, 24, False),
    (PHI, 2, 8, True),  # every gate equal: ties broken toward the lower expert
])
def test_route_integers_equal_reference(arch, B, S, zero_router):
    jcfg, cfg, lp = _layer(arch, seed=S)
    if zero_router:
        lp["router"][:] = 0.0
    jlp, tlp = _both(lp)
    h = np.random.default_rng(B).normal(size=(B, S, cfg.d_model)).astype(np.float32)
    jv, ji, jpos, jkeep, jC = jtransformer._moe_route(jnp.asarray(h), jlp, jcfg)
    v, i, pos, keep, C = transformer._moe_route(torch.from_numpy(h), tlp, cfg)
    assert C == jC
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    assert pos.dtype == torch.int32
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-6, rtol=1e-6)
    if zero_router:
        assert (i.numpy() == np.arange(cfg.top_k)).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_reference(arch):
    jcfg, cfg, lp = _layer(arch, seed=5)
    jlp, tlp = _both(lp)
    h = np.random.default_rng(5).normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    want = np.asarray(jax.jit(lambda x: jtransformer._moe_block(x, jlp, jcfg))(h))
    got = transformer._moe_block(torch.from_numpy(h), tlp, cfg)
    np.testing.assert_allclose(got.numpy(), want, **REF)


def test_capacity_drops_match_reference():
    """capacity_factor 0.01 (C = 1): most (token, k) pairs go to the overflow
    slot and give zero rows, the same ones in both packages."""
    jcfg, cfg, lp = _layer(PHI, seed=1, scale=1.0, capacity_factor=0.01)
    jlp, tlp = _both(lp)
    h = np.random.default_rng(1).normal(size=(1, 32, cfg.d_model)).astype(np.float32)
    want = np.asarray(jtransformer._moe_block(jnp.asarray(h), jlp, jcfg))
    got = transformer._moe_block(torch.from_numpy(h), tlp, cfg).numpy()
    np.testing.assert_allclose(got, want, **REF)
    zero = np.abs(got[0]).sum(-1) == 0
    np.testing.assert_array_equal(zero, np.abs(want[0]).sum(-1) == 0)
    assert (~zero).sum() <= cfg.n_experts + 1 and zero.sum() > 16


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_and_decode_match_reference(arch):
    jmodel, jparams, model, params = carried(arch, seed=3)
    toks = tokens(model.cfg, (2, 10), seed=3)
    jlogits, jcache = jax.jit(jmodel.prefill)(jparams, jnp.asarray(toks))
    jfwd = jax.jit(lambda p, t: jtransformer.forward(p, t, jmodel.cfg))(jparams, toks)
    with torch.inference_mode():
        logits, cache = model.prefill(params, torch.from_numpy(toks))
        fwd = transformer.forward(params, torch.from_numpy(toks), model.cfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **REF)
    np.testing.assert_allclose(fwd.numpy(), np.asarray(jfwd), **REF)
    assert_caches_close(cache, jcache)
    # decode from empty caches, row 1 starting 3 positions in
    _, c, jc = decode_both(jmodel, jparams, model, params, toks, max_len=16, kv0=[0, 3])
    assert_caches_close(c, jc)


def test_decode_matches_prefill():
    """capacity_factor = E / K: C = S, so the prefill drops no pair either."""
    cfg0 = registry.reduced(registry.get(PHI))
    over = dict(capacity_factor=cfg0.n_experts / cfg0.top_k)
    _, _, model, params = carried(PHI, seed=0, **over)
    toks = tokens(model.cfg, (2, 12), seed=0)
    with torch.inference_mode():
        full, _ = model.prefill(params, torch.from_numpy(toks))
    self_decode(model, params, toks, full, max_len=16, tol=5e-3)


SERVE = dict(max_batch=2, max_len=32, n_requests=4, prompt_len=4, gen_len=6, seed=0)


@pytest.mark.parametrize("arrival_steps", [(), (0, 1, 3, 5)])
def test_serve_run_matches_reference(arrival_steps):
    got, want = serve_both(PHI, **SERVE, arrival_steps=arrival_steps)
    for key in SERVE_FIELDS:
        assert got[key] == want[key], key


def test_serve_scheduling_does_not_change_tokens():
    """Staggered 2-slot serving decodes the same tokens as one 4-slot batch
    (each row's capacity is its own), as in the reference."""
    _, _, _, params = carried(PHI, seed=SERVE["seed"])

    def run(**kw):
        cfg = serve.ServeConfig(arch=PHI, reduced=True, device="cpu", **{**SERVE, **kw})
        return serve.run(cfg, params=params)

    staggered, together = run(arrival_steps=(0, 1, 3, 5)), run(max_batch=4)
    assert staggered["requests"] == together["requests"]
    assert staggered["peak_active"] <= 2 and together["peak_active"] == 4
