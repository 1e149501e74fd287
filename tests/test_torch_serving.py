"""The port's dense serving path against the reference, on the CPU.

The reference's parameters (``init_params`` of ``registry.reduced`` yi-9b,
GQA 4:1, and qwen3-32b, qk_norm) are carried across with
``convert.lm_params_from_jax``; tokens come from a numpy seed.  Both
packages run in fp32 (the reduced configs' dtype).

Tolerances:
* prefill / decode logits and caches against the reference: atol = rtol =
  1e-4.  Two layers of fp32 matmuls summed in another order (XLA vs
  PyTorch's CPU GEMM) and differently rounded rsqrt/cos/sin; the measured
  gap is at most 3.6e-6 on logits up to 4.2 in magnitude, 2.1e-6 on caches.
* the port's own decode against its prefill: atol = rtol = 2e-3, the bound
  of the reference's ``tests/test_serving.py`` for the same check.
* ``serve.run``: the greedy tokens and every scheduling field equal.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_lm import PORT_ONLY_DEFAULTS, split_config  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import (  # noqa: E402
    build_model,
    exact_n_active_params,
    exact_n_params,
    init_cache,
)
from repro_torch.models.config import n_active_params, n_params  # noqa: E402

REF = dict(atol=1e-4, rtol=1e-4)
SELF = dict(atol=2e-3, rtol=2e-3)
ARCHS = ("yi-9b", "qwen3-32b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are tiny, and the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _carried(arch, seed):
    """The reference's reduced model and params, and the port's copy of both."""
    jcfg = jregistry.reduced(jregistry.get(arch))
    jmodel = jbuild(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(seed))
    cfg = registry.reduced(registry.get(arch))
    params = lm_params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, cfg, "cpu")
    return jmodel, jparams, build_model(cfg), params


def _zeros(specs):
    return {k: jnp.zeros(shape, dtype) for k, (shape, _, dtype) in specs.items()}


def test_configs_and_counts_match_reference():
    from repro.models import exact_n_params as jexact
    from repro.models.config import n_active_params as jn_active
    from repro.models.config import n_params as jn_params

    for name in jregistry.ARCHS:
        ours, theirs = registry.get(name), jregistry.get(name)
        # the reference's fields equal; the port's own hold their defaults
        for port, ref in ((ours, theirs), (registry.reduced(ours), jregistry.reduced(theirs))):
            shared, own = split_config(port)
            assert shared == dataclasses.asdict(ref)
            assert own == PORT_ONLY_DEFAULTS
        assert (ours.hd, ours.padded_vocab) == (theirs.hd, theirs.padded_vocab)
        assert n_params(ours) == jn_params(theirs)
        assert n_active_params(ours) == jn_active(theirs)
        if ours.family == "dense":
            assert exact_n_params(ours) == jexact(theirs)
    assert exact_n_params(registry.get("yi-9b")) == 8_829_407_232


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    jmodel, jparams, model, params = _carried(arch, seed=3)
    rng = np.random.default_rng(3)
    B, S, Smax = 2, 10, 16
    tokens = rng.integers(0, model.cfg.vocab_size, (B, S)).astype(np.int32)
    jlogits, jcache = jax.jit(jmodel.prefill)(jparams, jnp.asarray(tokens))
    with torch.inference_mode():
        logits, cache = model.prefill(params, torch.from_numpy(tokens))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **REF)
    for n in ("k", "v"):
        np.testing.assert_allclose(cache[n].numpy(), np.asarray(jcache[n]), **REF)

    # decode from empty caches, rows at different lengths (row 1 starts later)
    jc = _zeros(jmodel.cache_specs(B, Smax))
    step = jax.jit(jmodel.decode_step)
    c = init_cache(model, B, Smax, "cpu")
    kv = np.array([0, 3], np.int32)
    for t in range(S):
        tok = tokens[:, t]
        jl, jc = step(jparams, jnp.asarray(tok), jc, jnp.asarray(kv))
        with torch.inference_mode():
            lg, c = model.decode_step(params, torch.from_numpy(tok), c, torch.from_numpy(kv))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **REF)
        kv = kv + 1
    for n in ("k", "v"):
        np.testing.assert_allclose(c[n].numpy(), np.asarray(jc[n]), **REF)


def test_decode_writes_nothing_past_the_cache():
    """A row at kv_len == Smax is written nowhere, as the reference's where-update."""
    jmodel, jparams, model, params = _carried("yi-9b", seed=4)
    B, Smax = 2, 4
    rng = np.random.default_rng(4)
    c = init_cache(model, B, Smax, "cpu")
    c["k"].normal_(generator=torch.Generator().manual_seed(0))
    c["v"].normal_(generator=torch.Generator().manual_seed(1))
    jc = {n: jnp.asarray(c[n].numpy()) for n in ("k", "v")}
    before = {n: c[n].clone() for n in ("k", "v")}
    tok = rng.integers(0, model.cfg.vocab_size, (B,)).astype(np.int32)
    kv = np.array([Smax, 1], np.int32)
    jl, jc = jax.jit(jmodel.decode_step)(jparams, jnp.asarray(tok), jc, jnp.asarray(kv))
    with torch.inference_mode():
        lg, c = model.decode_step(params, torch.from_numpy(tok), c, torch.from_numpy(kv))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **REF)
    for n in ("k", "v"):
        torch.testing.assert_close(c[n][:, 0], before[n][:, 0], rtol=0, atol=0)
        np.testing.assert_allclose(c[n].numpy(), np.asarray(jc[n]), **REF)


@pytest.mark.parametrize("arch,B,S", [("yi-9b", 2, 12), ("qwen3-32b", 1, 8)])
def test_decode_matches_prefill(arch, B, S):
    """The port's greedy decode logits equal its teacher-forced prefill logits."""
    model = build_model(registry.reduced(registry.get(arch)))
    params = model.init_params(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, model.cfg.vocab_size, (B, S)).astype(np.int32))
    with torch.inference_mode():
        full, _ = model.prefill(params, tokens)
        cache = init_cache(model, B, S + 4, "cpu")
        kv_len = torch.zeros(B, dtype=torch.int32)
        for t in range(S):
            logits, cache = model.decode_step(params, tokens[:, t], cache, kv_len)
            kv_len = kv_len + 1
            torch.testing.assert_close(logits, full[:, t], **SELF)


@pytest.mark.parametrize("impl", ["flash", "pallas"])
def test_attention_impl_chooses_among_plain_versions_on_the_cpu(impl):
    """On the CPU, ``attention_impl`` picks the blocked scan or K4's plain
    version; both give the plain path's logits (3e-5, the kernels' fp32 bound)."""
    base = registry.reduced(registry.get("yi-9b"))
    params = build_model(base).init_params(torch.Generator().manual_seed(2))
    tokens = torch.from_numpy(
        np.random.default_rng(2).integers(0, base.vocab_size, (2, 40)).astype(np.int32))
    other = dataclasses.replace(base, attention_impl=impl, flash_block_k=16)
    with torch.inference_mode():
        want, _ = build_model(base).prefill(params, tokens)
        got, _ = build_model(other).prefill(params, tokens)
    torch.testing.assert_close(got, want, atol=3e-5, rtol=3e-5)


def _serve_cfg(**kw):
    base = dict(
        arch="yi-9b", reduced=True, max_batch=2, max_len=32,
        n_requests=4, prompt_len=4, gen_len=6, seed=0,
    )
    base.update(kw)
    return base


@pytest.mark.parametrize("arrival_steps", [(), (0, 0, 2, 24)])
def test_serve_run_matches_reference(arrival_steps):
    kw = _serve_cfg(arrival_steps=arrival_steps)
    want = jserve.run(jserve.ServeConfig(**kw))
    _, jparams, model, params = _carried("yi-9b", seed=kw["seed"])
    got = serve.run(serve.ServeConfig(**kw, device="cpu"), params=params)
    for key in ("requests", "decode_steps", "tokens_generated", "peak_active",
                "first_token_step", "finish_step"):
        assert got[key] == want[key], key


def test_serve_slot_refill_under_staggered_arrival():
    """Requests arriving mid-run wait, refill freed slots, and finish."""
    out = serve.run(serve.ServeConfig(**_serve_cfg(arrival_steps=(0, 0, 2, 24)), device="cpu"))
    for rid, toks in out["requests"].items():
        assert len(toks) == 6, f"request {rid} generated {len(toks)} tokens"
    assert out["peak_active"] <= 2
    first, finish = out["first_token_step"], out["finish_step"]
    assert first[2] >= min(finish[0], finish[1])
    assert first[3] >= 24
    assert finish[3] > finish[2]


def test_serve_scheduling_does_not_change_tokens():
    """Staggered 2-slot serving decodes the same tokens as one 4-slot batch."""
    staggered = serve.run(serve.ServeConfig(**_serve_cfg(arrival_steps=(0, 1, 3, 5)),
                                            device="cpu"))
    together = serve.run(serve.ServeConfig(**_serve_cfg(max_batch=4), device="cpu"))
    assert staggered["requests"] == together["requests"]
    assert staggered["peak_active"] <= 2
    assert together["peak_active"] == 4


def test_entry_points_default_to_cuda():
    """device=None means CUDA; without a card the entry points raise, never fall back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.run(serve.ServeConfig(**_serve_cfg()))
    cfg = registry.reduced(registry.get("yi-9b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        lm_params_from_jax({}, cfg)


@pytest.mark.parametrize("arch", sorted(registry.ARCHS))
def test_every_family_builds_with_the_reference_counts(arch):
    """Every LM configuration builds (full width, no allocation), with the
    reference's exact and active parameter counts; without a card, the
    recurrent and MoE families' entry points raise on device=None too."""
    from repro.models import exact_n_active_params as jactive
    from repro.models import exact_n_params as jexact

    cfg = registry.get(arch)
    model = build_model(cfg)
    assert model.cfg.name == arch
    assert exact_n_params(cfg) == jexact(jregistry.get(arch))
    assert exact_n_active_params(cfg) == jactive(jregistry.get(arch))
    if torch.cuda.is_available() or cfg.family not in ("moe", "ssm", "hybrid"):
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.run(serve.ServeConfig(**_serve_cfg(arch=arch)))
    with pytest.raises(RuntimeError, match="CUDA"):
        lm_params_from_jax({}, registry.reduced(cfg))
