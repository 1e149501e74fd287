"""Closed loop of long text prompts through ``Model.prefill``, one client, B=1.

Request i of a run: a prompt of token ids drawn on the card from the seed
``derived_seed(2, i)``, no patches, no prefix shared with another request.
The lengths are ``drivers/prefill.py``'s: a fixed log-spaced grid over
[prompt_len_min, prompt_len_max] (``n_lengths`` of them) dealt in a new
seeded order each pass.  A request is timed from its send to the moment
its first token (the argmax of the last position's logits over the
vocabulary) is on the host; ``ttft_p95_ms`` is the 95th percentile over
all requests of the window.  The expert layer's pair counters
(``transformer.MOE_PAIRS``) are kept a request; in a traced run the
program's own spans (``repro_torch.spans``) go into ``run.spans``.

A request keeps the logits of its last ``check_positions`` positions
(the cell's), which the check compares.  The configuration file holds the
source's keys (``config.json`` of the model); the program's
``ModelConfig`` is checked against them before anything is allocated, so
a program without the architecture stops in seconds.  The weights are drawn on the card in the reference's layout
(``reference/exaone_moe.weight_shapes``), each in the dtype the program's
spec gives it.  The output check samples requests from the seed, the
longest among them, makes their prompts again and runs the plain fp32
reference over each: at each of the last ``check_positions`` positions, the
program's widest logit gap to the reference's over the RMS of the
reference's logits; a request reads the median over its positions, the
check the largest over its requests.  The median, because one position's
gap is heavy-tailed: a token whose router scores nearly tie picks another
expert under any rounding (PERF.md section 2); a lower precision moves
every position.
"""

from __future__ import annotations

import dataclasses
import math
import time
import traceback

import numpy as np

from cardbench.drivers.prefill import length_grid, lengths, sample
from cardbench.reference import exaone_moe

WARM_KEY = 1 << 40  # the warm-up requests' inputs, apart from the window's

# ModelConfig attribute: the configuration file's key
PROGRAM_KEYS = {
    "n_layers": "num_hidden_layers", "d_model": "hidden_size",
    "n_heads": "num_attention_heads", "n_kv_heads": "num_key_value_heads", "hd": "head_dim",
    "d_ff": "intermediate_size", "expert_d_ff": "moe_intermediate_size",
    "n_experts": "num_experts", "top_k": "num_experts_per_tok",
    "n_shared_experts": "num_shared_experts", "first_dense_layers": "first_k_dense_replace",
    "routed_scale": "routed_scaling_factor", "window": "sliding_window",
    "rms_norm_eps": "rms_norm_eps", "vocab_size": "vocab_size",
    "tie_embeddings": "tie_word_embeddings", "experts_held": "experts_held", "dtype": "dtype",
}


@dataclasses.dataclass
class State:
    model: object
    weights: dict
    lengths: list


def sizes(config: dict) -> dict:
    """The reference's view of the configuration file."""
    return dict(config, padded_vocab=-(-config["vocab_size"] // 256) * 256)


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
    prog.update(
        rope_parameters={"rope_theta": cfg.rope_theta, "rope_type": "default"},
        # the program's dropless layer: DeepSeek-V3's sigmoid router, no groups
        scoring_func="sigmoid", norm_topk_prob=True, n_group=1, topk_group=1,
        layer_types=["sliding_attention" if cfg.windowed(i) else "full_attention"
                     for i in range(cfg.n_layers)],
        num_nextn_predict_layers=0)
    want = dict(c, layer_types=c["layer_types"][: c["num_hidden_layers"]])
    diff = {k: (want.get(k), v) for k, v in prog.items() if want.get(k) != v}
    if diff:
        raise SystemExit(f"configs/{run.cell['config']}.json differs from the program: {diff}")
    # the layer equations of the reference: QK-norm and post-norms (a window
    # makes the global layers NoPE)
    if not (cfg.family == "moe" and cfg.qk_norm and cfg.post_norm):
        raise SystemExit(f"{c['arch']} no longer has the reference's layer")
    return cfg


def make_weights(run, model) -> dict:
    """The weights on ``run.device``: ``normal / sqrt(fan_in)`` for a matrix
    (fan_in its second-to-last size), ones for a norm, drawn one tensor a
    call (the experts one layer at a time) in the dtype of the program's
    spec, checked against the reference's layout."""
    torch = run.torch
    shapes = exaone_moe.weight_shapes(sizes(run.config))
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
        w = torch.empty(shape, dtype=dtype, device=run.device)
        for part in (w if name.startswith("we_") else [w]):
            part.normal_(generator=gen).mul_(1.0 / math.sqrt(shape[-2]))
        weights[name] = w
    return weights


def request_tokens(run, i: int, n: int):
    torch = run.torch
    gen = torch.Generator(device=run.device).manual_seed(run.derived_seed(2, i))
    return torch.randint(0, run.config["vocab_size"], (n,), generator=gen, device=run.device)


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
    from repro_torch import spans
    from repro_torch.models import transformer

    torch = run.torch
    V = run.config["vocab_size"]
    prefill = state.model.prefill
    pairs = transformer.MOE_PAIRS
    reqs = []
    failed = 0
    if run.trace_on:
        spans.enable()
    t0 = time.perf_counter()
    i = 0
    with torch.inference_mode():
        while time.perf_counter() - t0 < run.seconds:
            n = state.lengths[i]
            tokens = request_tokens(run, i, n)
            traced = run.trace.active
            before = dict(pairs)
            t_send = time.perf_counter()
            try:
                with run.spans.span("prefill"):
                    logits, cache = prefill(state.weights, tokens[None])
                tail = logits[0, -run.cell["check_positions"]:].clone()
                del logits, cache
                with run.spans.span("first_token"):
                    tok = int(torch.argmax(tail[-1, :V]))
                t_done = time.perf_counter()
                reqs.append({"i": i, "n_text": n, "ttft": t_done - t_send, "token": tok,
                             "tail": tail, "traced": traced,
                             **{f"{k}_pairs": pairs[k] - before[k] for k in pairs}})
            except Exception:
                traceback.print_exc()
                failed += 1
            i += 1
            run.trace.boundary()
    t1 = time.perf_counter()
    if run.trace_on:
        spans.disable()
        run.spans.items.extend(spans.take())
    run.records.update(attempted=i, failed=failed, requests=reqs, window=(t0, t1))
    ttft = [r["ttft"] for r in reqs]
    return {"ttft_p95_ms": 1e3 * float(np.percentile(ttft, 95)) if ttft else float("nan")}


def _gaps(got, want, V: int) -> list[float]:
    """Each position's widest logit gap over the RMS of the reference's logits."""
    w = want[:, :V]
    rms = w.square().mean(-1).sqrt()
    return ((got[:, :V].float() - w).abs().amax(-1) / rms).tolist()


def compare(run, state: State, reqs: list, precision: str = "fp32") -> dict:
    """Per checked request, the gaps of its checked positions (the last
    ``len(r["tail"])``): the program's (``logit_err``), and for a control
    the reference's computed at a lower precision (``control_logit_err``)."""
    torch = run.torch
    V = run.config["vocab_size"]
    seqs = [request_tokens(run, r["i"], r["n_text"]) for r in reqs]
    pos = [list(range(r["n_text"] - len(r["tail"]), r["n_text"])) for r in reqs]
    with torch.inference_mode():
        want = exaone_moe.logits_at(state.weights, sizes(run.config), seqs, pos)
        got = (exaone_moe.logits_at(state.weights, sizes(run.config), seqs, pos, precision)
               if precision != "fp32" else None)
    out = {"logit_err": [], "control_logit_err": []}
    for j, r in enumerate(reqs):
        out["logit_err"].append(_gaps(r["tail"], want[j], V))
        if got is not None:
            out["control_logit_err"].append(_gaps(got[j], want[j], V))
    return out


def check(run, state: State) -> list[tuple[str, float]]:
    if run.device == "cuda":
        run.torch.cuda.empty_cache()  # the prefills' logits and caches, before the reference
    reqs = run.records["requests"]
    if not reqs:
        return [("logit_err", None)]
    return numbers(compare(run, state, sample(run, reqs)))


def numbers(got: dict) -> list[tuple[str, float]]:
    """The numbers the check compares, from :func:`compare`'s readings: the
    largest over the requests of the median over their positions."""
    return [("logit_err", max(float(np.median(g)) for g in got["logit_err"]))]


def control_numbers(got: dict) -> list[tuple[str, float]]:
    """The same numbers for the control (:func:`compare` at a lower precision)."""
    return [("logit_err", max(float(np.median(g)) for g in got["control_logit_err"]))]
