"""Tiny same-family versions of the cells, for runs of the harness on the CPU."""

from __future__ import annotations

import time

LM = {"test_reduced": True, "n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 1,
      "head_dim": 16, "d_ff": 128, "vocab_size": 503, "frontend_len": 8, "dtype": "float32"}
SEARCH = {"pop_size": 4, "n_generations": 1, "max_steps": 12, "surrogate_min_rows": 2}

OVERRIDES = {
    "cardio-search": {"traffic": {"search": SEARCH, "warm_generations": 0}},
    "_cardio-hybrid-3axis": {"traffic": {"search": dict(SEARCH, genome_axes="adc,act,wprec",
                                                       surrogate=True, hybrid_warm_frac=0.25,
                                                       hybrid_refine_every=1,
                                                       hybrid_grad_steps=2),
                                        "warm_generations": 0}},
    "internvl2-image-ttft": {"config": LM, "traffic": {"patches": 8, "prompt_len_min": 4,
                                                       "prompt_len_max": 16, "n_lengths": 4},
                             "cell": {"check_requests": 3}},
    "_internvl2-chat-decode": {"config": LM, "traffic": {"n_requests": 4, "prompt_len": 3,
                                                        "gen_len": 4},
                              "cell": {"check_requests": 3}},
}


def run(cell: str, seed: int = 11, seconds: float = 0.01, root=None, trace: bool = False,
        **kw):
    """(Run, result) of one tiny run of ``cell`` on the CPU."""
    import torch

    from cardbench import harness

    torch.set_num_threads(1)
    args = dict(device="cpu", overrides=OVERRIDES.get(cell))
    if root is not None:
        args["root"] = root
    args.update(kw)
    r = harness.Run(cell, seed, seconds, trace, **args)
    return r, harness.run_cell(r, time.time())


def control(cell: str, seed: int = 11, seconds: float = 0.01, overrides=None):
    """(correct, compared) of the control of one tiny run of ``cell`` on the
    CPU: the reference one precision below the configuration's, put in the
    program's place, judged by the harness's limits."""
    import torch

    from cardbench import harness
    from cardbench.tracing import Trace

    torch.set_num_threads(1)
    r = harness.Run(cell, seed, seconds, False, device="cpu",
                    overrides=overrides or OVERRIDES.get(cell))
    r.torch, r.trace = torch, Trace(torch, False, 0.0)
    driver = harness.load_module("drivers", r.traffic["driver"])
    state = driver.setup(r)
    driver.window(r, state)
    if r.traffic["driver"] == "search":
        driver.check(r, state)
        checks = driver.control_numbers(r, state)
    elif r.traffic["driver"] == "prefill":
        reqs = driver.sample(r, r.records["requests"])
        checks = driver.control_numbers(driver.compare(r, state, reqs, "fp8"))
    else:
        rows = driver.sample_rows(r, driver.kept_rows(state))
        got = driver.compare(r, state, driver.sample(r, state), rows, "fp8")
        checks = driver.control_numbers(got)
    return harness.judge(r, checks)
