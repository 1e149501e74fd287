"""Closed loop of chat calls through the program's own serving loop, ``launch/serve.run``.

Each call serves ``n_requests`` text prompts in ``max_batch`` slots: the
prompts fed token by token through ``decode_step``, the slots refilled as
requests finish, greedy tokens.  Call k takes the seed
``derived_seed(5, k)``, from which ``serve.run`` draws its prompts; the
parameters are made once in set-up and handed in.  Calls run back to back;
the one running at the deadline runs to its end, and ``tokens_per_s`` is
every token generated in the window over the window's time.

The harness wraps the model's ``decode_step`` on its own side (through
``serve.build_model``, which also gives the model the configuration file's
``rope_theta``): it keeps every call's tokens and cache lengths, and the
logits the calls return on ``check_steps`` steps a ``serve.run`` call drawn
from the seed.  The output check runs the plain fp32 reference over

* ``check_rows`` slots of the kept steps, drawn from the seed: a slot's
  sequence is worked out again from the tokens and cache lengths of the
  steps before (a step writes its token at the slot's cache length and
  attends up to it), and the logits the program returned are compared
  with the reference's at that position (``logit_err``: the widest gap
  over the RMS of the reference's logits);
* requests sampled from the seed, the longest among them: their prompts
  made again from the call's seed and their served tokens, and the gap by
  which each served token's reference logit lies below the reference's
  best, over the RMS (``token_gap``).
"""

from __future__ import annotations

import dataclasses
import time
import traceback

import numpy as np

from cardbench import lm
from cardbench.reference import internlm2


@dataclasses.dataclass
class State:
    weights: dict
    calls: list = dataclasses.field(default_factory=list)
    decode: list = dataclasses.field(default_factory=list)  # (traced, kv_len clone)
    call: dict | None = None  # the record of the serve.run call running now


def serve_config(run, seed: int, **over):
    from repro_torch.launch.serve import ServeConfig

    t = run.traffic
    fields = dict(max_batch=t["max_batch"], n_requests=t["n_requests"],
                  prompt_len=t["prompt_len"], gen_len=t["gen_len"],
                  max_len=t["prompt_len"] + t["gen_len"])
    fields.update(over)
    return ServeConfig(arch=run.config["arch"], reduced=bool(run.config.get("test_reduced")),
                       seed=seed, device=run.device, n_layers=run.config["n_layers"], **fields)


_WATCH: dict = {}  # the run and state the installed wrapper records into


def _install(run, state: State) -> None:
    """Wrap ``serve.build_model`` so the models it builds have a watched
    ``decode_step`` (once a process; the wrapper records into the newest run)."""
    from repro_torch.launch import serve

    _WATCH.update(run=run, state=state)
    build = serve.build_model
    if getattr(build, "cardbench", False):
        return

    def build_watched(cfg):
        model = build(lm.configured(cfg, _WATCH["run"].config))
        step = model.decode_step

        def decode_step(params, token, cache, kv_len):
            run, state = _WATCH["run"], _WATCH["state"]
            kv = kv_len.clone()  # serve.run writes both in place
            state.decode.append((run.trace.active, kv))
            rec = state.call
            if rec is not None:
                i = len(rec["steps"])
                rec["steps"].append((token.clone(), kv))
            with run.spans.span("decode_step"):
                logits, cache = step(params, token, cache, kv_len)
            if rec is not None and i in rec["keep"]:
                rec["kept"][i] = logits.clone()
            return logits, cache

        return dataclasses.replace(model, decode_step=decode_step)

    build_watched.cardbench = True
    serve.build_model = build_watched


def setup(run) -> State:
    from repro_torch.launch import serve
    from repro_torch.models import build_model

    cfg = lm.check_config(run)
    weights = lm.make_weights(run, build_model(cfg))
    state = State(weights)
    _install(run, state)
    # every shape of the cell: the batch of slots and the cache length
    serve.run(serve_config(run, run.derived_seed(0), n_requests=run.traffic["max_batch"],
                           prompt_len=2, gen_len=2), weights)
    state.decode.clear()
    return state


def window(run, state: State) -> dict:
    from repro_torch.launch.serve import run as serve_run

    t0 = time.perf_counter()
    k = failed = tokens = 0
    while True:
        seed = run.derived_seed(5, k)
        state.call = rec = {"seed": seed, "requests": None, "steps": [], "kept": {},
                            "keep": kept_steps(run, k)}
        try:
            with run.spans.span("serve.run"):
                out = serve_run(serve_config(run, seed), state.weights)
            tokens += out["tokens_generated"]
            rec["requests"] = out["requests"]
            state.calls.append(rec)
        except Exception:
            traceback.print_exc()
            failed += 1
        k += 1
        run.trace.boundary()
        if time.perf_counter() - t0 >= run.seconds:
            break
    t1 = time.perf_counter()
    state.call = None
    n_req = run.traffic["n_requests"]
    run.records.update(attempted=k * n_req, failed=failed * n_req, window=(t0, t1),
                       decode=state.decode, tokens=tokens)
    return {"tokens_per_s": tokens / (t1 - t0)}


def kept_steps(run, k: int) -> set[int]:
    """The steps of call ``k`` whose logits are kept: ``check_steps`` drawn
    from the seed among the first steps every call makes (each prompt token
    fed, then the generated tokens with every slot busy)."""
    t = run.traffic
    n = t["n_requests"] * t["prompt_len"] + -(-t["n_requests"] * (t["gen_len"] - 1)
                                                // t["max_batch"])
    rng = np.random.default_rng(run.derived_seed(8, k))
    return set(rng.choice(n, size=min(int(run.cell.get("check_steps", 4)), n),
                          replace=False).tolist())


def kept_rows(state: State) -> list[tuple[np.ndarray, object]] | None:
    """(sequence, the logits the program returned for it) of every slot of
    every kept step; None where a step's cache length lies beyond what the
    slot has been fed, which no sound serving loop does."""
    out = []
    for call in state.calls:
        if not call["kept"]:
            continue
        toks = [t.cpu().numpy() for t, _ in call["steps"]]
        kvs = [k.cpu().numpy() for _, k in call["steps"]]
        seqs: list[list[int]] = [[] for _ in range(len(toks[0]))]
        for i, (tok, kv) in enumerate(zip(toks, kvs)):
            for b, seq in enumerate(seqs):
                if int(kv[b]) > len(seq):
                    return None
                seqs[b] = seq[: int(kv[b])] + [int(tok[b])]
            if i in call["kept"]:
                out.extend((np.asarray(seq, np.int64), call["kept"][i][b])
                           for b, seq in enumerate(seqs))
    return out


def sample_rows(run, rows: list) -> list:
    """``check_rows`` of the kept rows, drawn from the seed: every run that
    keeps that many compares as many, whatever its number of calls."""
    k = min(int(run.cell.get("check_rows", len(rows))), len(rows))
    rng = np.random.default_rng(run.derived_seed(9))
    return [rows[j] for j in sorted(rng.choice(len(rows), size=k, replace=False))]


def prompts(run, seed: int) -> list[np.ndarray]:
    """The prompts ``serve.run`` draws from its seed: ``n_requests`` of
    ``prompt_len`` ids below the vocabulary size, in order."""
    rng = np.random.default_rng(seed)
    t = run.traffic
    return [rng.integers(0, run.config["vocab_size"], t["prompt_len"]).astype(np.int32)
            for _ in range(t["n_requests"])]


def sample(run, state: State) -> list[tuple[np.ndarray, list]]:
    """(prompt, served tokens) of ``check_requests`` requests drawn from the seed."""
    served = []
    for call in state.calls:
        ps = prompts(run, call["seed"])
        served.extend((ps[rid], toks) for rid, toks in sorted(call["requests"].items()))
    rng = np.random.default_rng(run.derived_seed(6))
    k = int(run.cell.get("check_requests", 16))
    order = sorted(range(len(served)), key=lambda j: -len(served[j][1]))
    pick = [order[0], *[j for j in rng.permutation(len(served)) if j != order[0]][: k - 1]]
    return [served[j] for j in pick]


def compare(run, state: State, reqs, rows, precision: str = "fp32") -> dict:
    """The served tokens' gaps and the kept steps' logit errors (and, for a
    control, the gaps of the tokens a lower-precision reference puts first
    at the same positions, and its logit errors), in one reference pass."""
    torch = run.torch
    sizes = lm.model_sizes(run.config)
    V = sizes["vocab_size"]
    as_t = lambda a: torch.as_tensor(a, dtype=torch.int64, device=run.device)  # noqa: E731
    seqs, pos = [], []
    for prompt, toks in reqs:
        seqs.append((as_t(np.concatenate([prompt, np.asarray(toks[:-1], np.int64)])), None))
        pos.append(list(range(len(prompt) - 1, len(prompt) - 1 + len(toks))))
    for seq, _ in rows:
        seqs.append((as_t(seq), None))
        pos.append([len(seq) - 1])
    with torch.inference_mode():
        want = internlm2.logits_at(state.weights, sizes, seqs, pos)
        got = (internlm2.logits_at(state.weights, sizes, seqs, pos, precision)
               if precision != "fp32" else None)
    out = {"token_gap": [], "control_gap": [], "logit_err": [], "control_logit_err": []}
    for j, (_, toks) in enumerate(reqs):
        w = want[j][:, :V]
        rms = w.square().mean(-1).sqrt()
        best = w.max(-1).values
        served = torch.as_tensor(toks, device=w.device)
        out["token_gap"].extend(((best - w.gather(1, served[:, None])[:, 0]) / rms).tolist())
        if got is not None:
            first = got[j][:, :V].argmax(-1)
            out["control_gap"].extend(((best - w.gather(1, first[:, None])[:, 0]) / rms).tolist())
    for j, (_, logits) in enumerate(rows, start=len(reqs)):
        w = want[j][0, :V]
        rms = float(w.square().mean().sqrt())
        out["logit_err"].append(float((logits[:V].float() - w).abs().max()) / rms)
        if got is not None:
            out["control_logit_err"].append(float((got[j][0, :V] - w).abs().max()) / rms)
    return out


def check(run, state: State) -> list[tuple[str, float]]:
    if run.device == "cuda":
        run.torch.cuda.empty_cache()  # the calls' caches, before the reference
    rows = kept_rows(state)
    if not state.calls or not rows:
        return [("token_gap", None), ("logit_err", None)]
    return numbers(compare(run, state, sample(run, state), sample_rows(run, rows)))


def numbers(got: dict) -> list[tuple[str, float]]:
    """The numbers the check compares, from :func:`compare`'s readings."""
    return [("token_gap", max(got["token_gap"])), ("logit_err", max(got["logit_err"]))]


def control_numbers(got: dict) -> list[tuple[str, float]]:
    """The same numbers for the control (:func:`compare` at a lower precision)."""
    return [("token_gap", max(got["control_gap"])),
            ("logit_err", max(got["control_logit_err"]))]
