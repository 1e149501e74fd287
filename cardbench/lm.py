"""The language model's weights, made on the card from the seed, and its sizes.

The weights are the benchmark's inputs: drawn with a ``torch.Generator``
on the card, in bf16 (the type they are served in), one call a tensor,
``normal / sqrt(fan_in)`` for a matrix (fan_in its second-to-last size)
and ones for a norm, in the layout of ``reference/internlm2.weight_shapes``.
The program and the reference are both handed the same tensors.
"""

from __future__ import annotations

import math

from cardbench.reference import internlm2

__all__ = ["model_sizes", "configured", "check_config", "make_weights"]


def model_sizes(config: dict) -> dict:
    """The reference's view of a configuration file."""
    m = 256  # the program pads the vocabulary to a multiple of 256
    return dict(config, padded_vocab=-(-config["vocab_size"] // m) * m)


OVERRIDES = ("n_layers", "rope_theta")  # ModelConfig fields the file sets


def configured(cfg, config: dict):
    """The program's ``ModelConfig`` with the fields of ``OVERRIDES`` that
    the configuration file states."""
    import dataclasses

    return dataclasses.replace(cfg, **{k: config[k] for k in OVERRIDES if k in config})


def check_config(run):
    """The program's config of this model, after checking that the
    configuration file holds it; returns the program's ``ModelConfig``."""
    from repro_torch.configs import registry

    c = run.config
    cfg = registry.get(c["arch"])
    if c.get("test_reduced"):  # the CPU tests' tiny same-family model
        cfg = registry.reduced(cfg)
    cfg = configured(cfg, c)
    prog = {"n_layers": cfg.n_layers, "d_model": cfg.d_model, "n_heads": cfg.n_heads,
            "n_kv_heads": cfg.n_kv_heads, "d_ff": cfg.d_ff, "vocab_size": cfg.vocab_size,
            "frontend_len": cfg.frontend_len, "adc_bits": cfg.frontend_adc_bits,
            "rope_theta": cfg.rope_theta, "dtype": cfg.dtype,
            "head_dim": cfg.hd, "tie_embeddings": cfg.tie_embeddings}
    diff = {k: (c.get(k), v) for k, v in prog.items() if c.get(k) != v}
    if diff:
        raise SystemExit(f"configs/{run.cell['config']}.json differs from the program: {diff}")
    if not cfg.use_pruned_frontend or cfg.family != "vlm" or cfg.qk_norm:
        raise SystemExit(f"{c['arch']} is no longer a VLM with the pruned frontend")
    return cfg


def make_weights(run, model) -> dict:
    """The weights on ``run.device``, checked against the program's own specs."""
    torch = run.torch
    sizes = model_sizes(run.config)
    shapes = internlm2.weight_shapes(sizes)
    specs = {n: tuple(s) for n, (s, _, _) in model.param_specs().items()}
    if specs != shapes:
        raise SystemExit(f"the program's weights are laid out otherwise: {specs} vs {shapes}")
    dtype = getattr(torch, run.config["dtype"])
    gen = torch.Generator(device=run.device).manual_seed(run.derived_seed(7))
    weights = {}
    for name in sorted(shapes):
        shape = shapes[name]
        if "norm" in name or name.startswith("ln"):
            weights[name] = torch.ones(shape, dtype=dtype, device=run.device)
            continue
        w = torch.randn(shape, generator=gen, dtype=dtype, device=run.device)
        weights[name] = w.mul_(1.0 / math.sqrt(shape[-2]))
    return weights
