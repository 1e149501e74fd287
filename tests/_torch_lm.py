"""Helpers shared by the port's LM family tests (MoE, rwkv6, zamba2).

``carried`` builds a reduced config in both packages (with the same field
overrides), draws the reference's parameters and carries them across with
``convert.lm_params_from_jax``; ``decode_both`` runs a teacher-forced
decode in both packages from zeroed caches; ``serve_both`` runs both
packages' ``serve.run`` on the same parameters; ``split_config`` parts a
port config into the reference's fields and the port's own.  Arrays cross
as numpy.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import registry as jregistry
from repro.launch import serve as jserve
from repro.models import build_model as jbuild
from repro.models.config import ModelConfig as JModelConfig
from repro_torch.configs import registry
from repro_torch.convert import lm_params_from_jax
from repro_torch.launch import serve
from repro_torch.models import build_model, init_cache

REF = dict(atol=1e-4, rtol=1e-4)
# the fields of the port's ModelConfig that the reference's lacks, at the
# values a configuration the JAX package also has must hold
PORT_ONLY_DEFAULTS = dict(rms_norm_eps=1e-6, window=0, window_pattern="L", post_norm=False,
                          first_dense_layers=0, experts_held=0, routed_scale=1.0,
                          n_shared_experts=0, n_group=1, topk_group=1, q_lora_rank=0,
                          kv_lora_rank=0, qk_nope_head_dim=0, qk_rope_head_dim=0, v_head_dim=0,
                          rope_scaling=None)
SERVE_FIELDS = ("requests", "decode_steps", "tokens_generated", "peak_active",
                "first_token_step", "finish_step")


def split_config(cfg) -> tuple[dict, dict]:
    """``cfg``'s fields as two dicts: those of the reference's ModelConfig,
    and the port's others."""
    ref = {f.name for f in dataclasses.fields(JModelConfig)}
    d = dataclasses.asdict(cfg)
    return ({k: v for k, v in d.items() if k in ref},
            {k: v for k, v in d.items() if k not in ref})


def carried(arch: str, seed: int, **over):
    """(reference model, its params, the port's model, the carried params)."""
    jcfg = dataclasses.replace(jregistry.reduced(jregistry.get(arch)), **over)
    jmodel = jbuild(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(seed))
    cfg = dataclasses.replace(registry.reduced(registry.get(arch)), **over)
    params = lm_params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, cfg, "cpu")
    return jmodel, jparams, build_model(cfg), params


def tokens(cfg, shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def assert_caches_close(got: dict, want: dict, **tol) -> None:
    assert set(got) == set(want)
    for n in want:
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]), err_msg=n,
                                   **(tol or REF))


def decode_both(jmodel, jparams, model, params, toks: np.ndarray, max_len: int,
                kv0=None) -> tuple[float, dict, dict]:
    """Feed ``toks`` (B, S) one step at a time through both packages' decode
    from zeroed caches (rows starting at ``kv0``); assert every step's logits
    within REF.  Returns (the largest logit gap, the port's cache, the
    reference's)."""
    B, S = toks.shape
    jc = {k: jnp.zeros(shape, dt) for k, (shape, _, dt) in jmodel.cache_specs(B, max_len).items()}
    step = jax.jit(jmodel.decode_step)
    c = init_cache(model, B, max_len, "cpu")
    kv = np.zeros(B, np.int32) if kv0 is None else np.array(kv0, np.int32)
    gap = 0.0
    for t in range(S):
        jl, jc = step(jparams, jnp.asarray(toks[:, t]), jc, jnp.asarray(kv))
        with torch.inference_mode():
            lg, c = model.decode_step(params, torch.from_numpy(toks[:, t]), c,
                                      torch.from_numpy(kv))
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **REF)
        gap = max(gap, float(np.abs(lg.numpy() - np.asarray(jl)).max()))
        kv = kv + 1
    return gap, c, jc


def serve_both(arch: str, **kw) -> tuple[dict, dict]:
    """Both packages' ``serve.run`` on the reference's draw (``kw`` are
    ``ServeConfig`` fields, ``reduced=True``)."""
    want = jserve.run(jserve.ServeConfig(arch=arch, reduced=True, **kw))
    _, _, _, params = carried(arch, seed=kw.get("seed", 0))
    got = serve.run(serve.ServeConfig(arch=arch, reduced=True, device="cpu", **kw),
                    params=params)
    return got, want


def self_decode(model, params, toks: np.ndarray, full: torch.Tensor, max_len: int,
                tol: float) -> float:
    """The port's own decode over ``toks`` (B, S) against its full-sequence
    logits ``full`` (B, S, V), every step within atol = rtol = ``tol``.
    Returns the largest gap."""
    B, S = toks.shape
    c = init_cache(model, B, max_len, "cpu")
    kv = torch.zeros(B, dtype=torch.int32)
    gap = 0.0
    with torch.inference_mode():
        for t in range(S):
            lg, c = model.decode_step(params, torch.from_numpy(toks[:, t]), c, kv)
            kv = kv + 1
            torch.testing.assert_close(lg, full[:, t], atol=tol, rtol=tol)
            gap = max(gap, float((lg - full[:, t]).abs().max()))
    return gap
