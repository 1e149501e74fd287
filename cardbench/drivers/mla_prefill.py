"""Closed loop of long text prompts through DeepSeek-V3's ``Model.prefill``, one client, B=1.

The loop, the prompts and their lengths are ``long_prefill``'s: request i
a prompt of token ids drawn on the card from ``derived_seed(2, i)``, no
patches, no prefix shared with another request, the lengths a fixed
log-spaced grid over [prompt_len_min, prompt_len_max] dealt in a new
seeded order each pass, a request timed from its send to its first token
on the host, ``ttft_p95_ms`` the 95th percentile over the window; the
expert layer's pair counters kept a request, the program's spans in a
traced run.  Beside them the window records the bytes of latent cache its
prefills wrote (``mla.LATENT_BYTES``).

What is DeepSeek-V3's own: the configuration file holds the source's keys
(its config.json), and ``check_config`` holds the program's ``ModelConfig``
to them (latent attention's ranks and head dims, YaRN's scaling, the
router's groups) before anything is allocated, so a program without the
architecture stops in seconds.  The weights are drawn on the card in the
reference's layout (``reference/deepseek_v3.weight_shapes``), each in the
dtype of the program's spec; the router's selection-only bias from the
seed at the file's ``router_bias_std``.  The output check is
``long_prefill``'s against ``reference/deepseek_v3``: the longest request
and drawn ones made again and run through the plain fp32 reference; at
each of the last ``check_positions`` positions the program's widest logit
gap over the RMS of the reference's logits; a request reads the median over
its positions, the check the largest over its requests.
"""

from __future__ import annotations

import math

from cardbench.drivers import long_prefill
from cardbench.drivers.long_prefill import State, WARM_KEY, request_tokens
from cardbench.drivers.prefill import length_grid, lengths, sample
from cardbench.reference import deepseek_v3

# ModelConfig attribute: the configuration file's key
PROGRAM_KEYS = {
    "n_layers": "num_hidden_layers", "d_model": "hidden_size",
    "n_heads": "num_attention_heads", "n_kv_heads": "num_key_value_heads",
    "d_ff": "intermediate_size", "expert_d_ff": "moe_intermediate_size",
    "n_experts": "n_routed_experts", "top_k": "num_experts_per_tok",
    "n_shared_experts": "n_shared_experts", "first_dense_layers": "first_k_dense_replace",
    "routed_scale": "routed_scaling_factor", "n_group": "n_group", "topk_group": "topk_group",
    "q_lora_rank": "q_lora_rank", "kv_lora_rank": "kv_lora_rank",
    "qk_nope_head_dim": "qk_nope_head_dim", "qk_rope_head_dim": "qk_rope_head_dim",
    "v_head_dim": "v_head_dim", "rope_theta": "rope_theta", "rms_norm_eps": "rms_norm_eps",
    "vocab_size": "vocab_size", "tie_embeddings": "tie_word_embeddings",
    "experts_held": "experts_held", "dtype": "dtype",
}
YARN_KEYS = ("factor", "original_max_position_embeddings", "beta_fast", "beta_slow", "mscale",
             "mscale_all_dim")

sizes = long_prefill.sizes


def check_config(run):
    """The program's ``ModelConfig`` of this model, after checking that the
    configuration file holds it."""
    from repro_torch.configs import registry

    c = run.config
    try:
        cfg = registry.get(c["arch"])
    except KeyError:
        raise SystemExit(f"the program has no architecture {c['arch']!r}") from None
    if c.get("test_reduced"):  # the CPU tests' tiny same-family model
        cfg = registry.reduced(cfg)
    prog = {k: getattr(cfg, f, None) for f, k in PROGRAM_KEYS.items()}
    y = getattr(cfg, "rope_scaling", None)
    prog.update(
        rope_scaling=None if y is None else dict(
            {k: getattr(y, k) for k in YARN_KEYS}, type="yarn"),
        # the program's dropless layer: DeepSeek-V3's noaux_tc router
        scoring_func="sigmoid", topk_method="noaux_tc", norm_topk_prob=True,
        hidden_act="silu", attention_bias=False, num_nextn_predict_layers=0)
    diff = {k: (c.get(k), v) for k, v in prog.items() if c.get(k) != v}
    if diff:
        raise SystemExit(f"configs/{run.cell['config']}.json differs from the program: {diff}")
    if not (cfg.family == "moe" and not cfg.qk_norm and not cfg.post_norm and not cfg.window):
        raise SystemExit(f"{c['arch']} no longer has the reference's layer")
    return cfg


def make_weights(run, model) -> dict:
    """The weights on ``run.device``: ``normal / sqrt(fan_in)`` for a matrix
    (fan_in its second-to-last size), ones for a norm, ``normal *
    router_bias_std`` for the router's bias, drawn one tensor a call (the
    experts one layer at a time) in the dtype of the program's spec,
    checked against the reference's layout."""
    torch = run.torch
    shapes = deepseek_v3.weight_shapes(sizes(run.config))
    specs = model.param_specs()
    if {n: tuple(s) for n, (s, _, _) in specs.items()} != shapes:
        raise SystemExit("the program's weights are laid out otherwise than the reference's")
    gen = torch.Generator(device=run.device).manual_seed(run.derived_seed(7))
    weights = {}
    for name in sorted(shapes):
        shape, dtype = shapes[name], getattr(torch, specs[name][2])
        if "norm" in name or name.startswith("ln"):
            weights[name] = torch.ones(shape, dtype=dtype, device=run.device)
            continue
        scale = (run.config["router_bias_std"] if name == "router_bias"
                 else 1.0 / math.sqrt(shape[-2]))
        w = torch.empty(shape, dtype=dtype, device=run.device)
        for part in (w if name.startswith("we_") else [w]):
            part.normal_(generator=gen).mul_(scale)
        weights[name] = w
    return weights


def setup(run) -> State:
    import torch

    from repro_torch.models import build_model

    cfg = check_config(run)
    model = build_model(cfg)
    weights = make_weights(run, model)
    state = State(model, weights, lengths(run, 4096))
    grid = length_grid(run.traffic)
    V = run.config["vocab_size"]
    # the longest first, so the allocator holds its blocks; then the shortest
    with torch.inference_mode():
        for j, n in enumerate((int(grid[-1]), int(grid[0]), int(grid[len(grid) // 2]))):
            logits, _ = model.prefill(weights, request_tokens(run, WARM_KEY + j, n)[None])
            int(torch.argmax(logits[0, -1, :V]))
            del logits
    return state


def window(run, state: State) -> dict:
    from repro_torch.models import mla

    mla.reset_latent_bytes()
    out = long_prefill.window(run, state)
    run.records["latent_bytes"] = mla.LATENT_BYTES["prefill"]
    return out


def compare(run, state: State, reqs: list, precision: str = "fp32") -> dict:
    """Per checked request, the gaps of its checked positions (the last
    ``len(r["tail"])``): the program's (``logit_err``), and for a control
    the reference's computed at a lower precision (``control_logit_err``)."""
    torch = run.torch
    V = run.config["vocab_size"]
    seqs = [request_tokens(run, r["i"], r["n_text"]) for r in reqs]
    pos = [list(range(r["n_text"] - len(r["tail"]), r["n_text"])) for r in reqs]
    with torch.inference_mode():
        want = deepseek_v3.logits_at(state.weights, sizes(run.config), seqs, pos)
        got = (deepseek_v3.logits_at(state.weights, sizes(run.config), seqs, pos, precision)
               if precision != "fp32" else None)
    out = {"logit_err": [], "control_logit_err": []}
    for j, r in enumerate(reqs):
        out["logit_err"].append(long_prefill._gaps(r["tail"], want[j], V))
        if got is not None:
            out["control_logit_err"].append(long_prefill._gaps(got[j], want[j], V))
    return out


def check(run, state: State) -> list[tuple[str, float]]:
    if run.device == "cuda":
        run.torch.cuda.empty_cache()  # the prefills' logits and caches, before the reference
    reqs = run.records["requests"]
    if not reqs:
        return [("logit_err", None)]
    return numbers(compare(run, state, sample(run, reqs)))


numbers = long_prefill.numbers
control_numbers = long_prefill.control_numbers
