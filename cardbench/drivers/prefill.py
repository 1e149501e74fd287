"""Closed loop of image-plus-text requests through ``Model.prefill``, one client, B=1.

Request i of a run: 256 patch embeddings drawn in [0, 1) and a text prompt,
both from the seed ``derived_seed(2, i)`` on the card.  The prompt lengths
come from a fixed log-spaced grid over [prompt_len_min, prompt_len_max]
(``n_lengths`` of them), dealt in a new seeded order each pass, so every
seed sends the same sizes.  A request is timed from its send to the
moment its first token (the argmax of the last position's logits over the
vocabulary) is on the host; ``ttft_p95_ms`` is the 95th percentile over
all requests of the window.

The output check samples requests from the seed, the longest among them,
makes their inputs again and runs the plain fp32 reference over each:
the logits the program gave at the last position against the reference's,
and the reference's gap below its best at the token the program served.
"""

from __future__ import annotations

import dataclasses
import math
import time
import traceback

import numpy as np

from cardbench import lm
from cardbench.reference import internlm2

WARM_KEY = 1 << 40  # the warm-up requests' inputs, apart from the window's


@dataclasses.dataclass
class State:
    model: object
    weights: dict
    lengths: list


def length_grid(t: dict) -> np.ndarray:
    lo, hi, n = t["prompt_len_min"], t["prompt_len_max"], t["n_lengths"]
    return np.unique(np.round(np.exp(np.linspace(math.log(lo), math.log(hi), n))).astype(int))


def lengths(run, n_needed: int) -> list[int]:
    grid = length_grid(run.traffic)
    out, p = [], 0
    while len(out) < n_needed:
        rng = np.random.default_rng(run.derived_seed(3, p))
        out.extend(int(v) for v in rng.permutation(grid))
        p += 1
    return out


def request_inputs(run, i: int, n_text: int, sizes: dict):
    torch = run.torch
    gen = torch.Generator(device=run.device).manual_seed(run.derived_seed(2, i))
    patches = torch.rand((run.traffic["patches"], sizes["d_model"]), generator=gen,
                         device=run.device, dtype=torch.float32)
    tokens = torch.randint(0, sizes["vocab_size"], (n_text,), generator=gen, device=run.device)
    return tokens, patches


def setup(run) -> State:
    import torch

    from repro_torch.models import build_model

    cfg = lm.check_config(run)
    if run.traffic["patches"] != cfg.frontend_len:
        raise SystemExit("the traffic's patches differ from the model's frontend_len")
    model = build_model(cfg)
    weights = lm.make_weights(run, model)
    state = State(model, weights, lengths(run, 4096))
    sizes = lm.model_sizes(run.config)
    grid = length_grid(run.traffic)
    # the longest first, so the allocator holds its blocks; then the shortest
    with torch.inference_mode():
        for j, n in enumerate((int(grid[-1]), int(grid[0]), int(grid[len(grid) // 2]))):
            tokens, patches = request_inputs(run, WARM_KEY + j, n, sizes)
            logits, _ = model.prefill(weights, tokens[None], patches[None])
            int(torch.argmax(logits[0, -1, : sizes["vocab_size"]]))
    return state


def window(run, state: State) -> dict:
    torch = run.torch
    sizes = lm.model_sizes(run.config)
    V = sizes["vocab_size"]
    prefill = state.model.prefill
    reqs = []
    failed = 0
    t0 = time.perf_counter()
    i = 0
    with torch.inference_mode():
        while time.perf_counter() - t0 < run.seconds:
            n = state.lengths[i]
            tokens, patches = request_inputs(run, i, n, sizes)
            traced = run.trace.active
            t_send = time.perf_counter()
            try:
                with run.spans.span("prefill"):
                    logits, cache = prefill(state.weights, tokens[None], patches[None])
                last = logits[0, -1].clone()
                del logits, cache
                with run.spans.span("first_token"):
                    tok = int(torch.argmax(last[:V]))
                t_done = time.perf_counter()
                reqs.append({"i": i, "n_text": n, "ttft": t_done - t_send, "token": tok,
                             "last": last, "traced": traced})
            except Exception:
                traceback.print_exc()
                failed += 1
            i += 1
            run.trace.boundary()
    t1 = time.perf_counter()
    run.records.update(attempted=i, failed=failed, requests=reqs, window=(t0, t1),
                       n_patches=run.traffic["patches"])
    ttft = [r["ttft"] for r in reqs]
    return {"ttft_p95_ms": 1e3 * float(np.percentile(ttft, 95)) if ttft else float("nan")}


def sample(run, reqs: list) -> list:
    """The checked requests: the longest and ``check_requests - 1`` drawn from the seed."""
    k = int(run.cell.get("check_requests", 6))
    longest = max(range(len(reqs)), key=lambda j: reqs[j]["n_text"])
    rng = np.random.default_rng(run.derived_seed(4))
    rest = [j for j in rng.permutation(len(reqs)) if j != longest][: k - 1]
    return [reqs[j] for j in [longest, *rest]]


def compare(run, state: State, reqs: list, precision: str = "fp32") -> dict:
    """Per checked request: the program's logit error and token gap, both in
    units of the reference logits' RMS, and (for a control) the gap of the
    token a lower-precision reference puts first."""
    torch = run.torch
    sizes = lm.model_sizes(run.config)
    V = sizes["vocab_size"]
    seqs, pos = [], []
    for r in reqs:
        tokens, patches = request_inputs(run, r["i"], r["n_text"], sizes)
        seqs.append((tokens, patches))
        pos.append([run.traffic["patches"] + r["n_text"] - 1])
    with torch.inference_mode():
        want = internlm2.logits_at(state.weights, sizes, seqs, pos)
        got = (internlm2.logits_at(state.weights, sizes, seqs, pos, precision)
               if precision != "fp32" else None)
    out = {"logit_err": [], "token_gap": [], "control_logit_err": [], "control_gap": []}
    for j, r in enumerate(reqs):
        w = want[j][0, :V]
        rms = float(w.square().mean().sqrt())
        best = float(w.max())
        out["logit_err"].append(float((r["last"][:V].float() - w).abs().max()) / rms)
        out["token_gap"].append((best - float(w[r["token"]])) / rms)
        if got is not None:
            out["control_logit_err"].append(float((got[j][0, :V] - w).abs().max()) / rms)
            out["control_gap"].append((best - float(w[int(got[j][0, :V].argmax())])) / rms)
    return out


def check(run, state: State) -> list[tuple[str, float]]:
    if run.device == "cuda":
        run.torch.cuda.empty_cache()  # the prefills' caches, before the reference
    reqs = run.records["requests"]
    if not reqs:
        return [("logit_err", None)]
    return numbers(compare(run, state, sample(run, reqs)))


def numbers(got: dict) -> list[tuple[str, float]]:
    """The numbers the check compares, from :func:`compare`'s readings.  The
    served token's gap is not compared: the fp8 control's first token is
    often the reference's own, so it has no upper reading (PERF.md)."""
    return [("logit_err", max(got["logit_err"]))]


def control_numbers(got: dict) -> list[tuple[str, float]]:
    """The same numbers for the control (:func:`compare` at a lower precision)."""
    return [("logit_err", max(got["control_logit_err"]))]
