"""A run with the timed path broken underneath, or the control in the
program's place, comes out not correct.

Each test drives a tiny run of a cell on the CPU (the harness's look for a
card skipped) with one fault planted in the program and checks that
``correct`` is false: a step that leaves its state unchanged, half of the
batch left out, an answer or a token altered where it is produced.  The
exchange between cards is no fault here: every cell takes one card.  The
prefill cell serves B=1, so it has no half batch to leave out.  The
control is the plain reference one precision below the configuration's
(TF32 inputs for the printed MLP's fp32 QAT, fp8 for the language model),
judged by the cell's own limits.
"""

import pytest
import torch

from cardbench.tests import tiny

SEARCH = {"traffic": {"search": dict(tiny.SEARCH, pop_size=8, max_steps=60),
                      "warm_generations": 0}}


def _search_faults(mp, fault):
    from repro_torch.core import qat, trainer

    if fault == "state_unchanged":
        mp.setattr(trainer, "_train_block", lambda *a, **k: None)
    elif fault == "half_batch":
        ce = qat.cross_entropy

        def half(logits, labels):
            out = ce(logits, labels)
            keep = torch.arange(out.shape[-1], device=out.device) < out.shape[-1] // 2
            return torch.where(keep, 2.0 * out, torch.zeros_like(out))

        mp.setattr(qat, "cross_entropy", half)
    elif fault == "answer_altered":
        acc = qat.accuracy
        mp.setattr(qat, "accuracy", lambda logits, labels: acc(logits, labels)
                   + 1.0 / labels.shape[-1])


def _lm_faults(mp, fault):
    from repro_torch.models import transformer

    if fault == "state_unchanged":
        if_prefill = transformer._layer

        def skip(x, lp, *a, **k):  # a layer that passes its input through
            return x, if_prefill(x, lp, *a, **k)[1]

        mp.setattr(transformer, "_layer", skip)
        mp.setattr(transformer, "cache_write", lambda kc, vc, *a: (kc, vc))
    elif fault == "half_batch":
        step = transformer.decode_step

        def half(params, token, cache, kv_len, cfg):
            logits, cache = step(params, token, cache, kv_len, cfg)
            B = logits.shape[0]
            logits = torch.cat([logits[: B // 2], logits[:1].expand(B - B // 2, -1)])
            return logits, cache

        mp.setattr(transformer, "decode_step", half)
    elif fault in ("token_altered", "answer_altered"):
        step, prefill = transformer.decode_step, transformer.prefill

        def bump(logits):
            logits = logits.clone()
            logits[..., 7] += 100.0 * logits.float().std()
            return logits

        def altered_step(params, token, cache, kv_len, cfg):
            logits, cache = step(params, token, cache, kv_len, cfg)
            return bump(logits), cache

        def altered_prefill(params, tokens, cfg, patch_embeds=None):
            logits, cache = prefill(params, tokens, cfg, patch_embeds)
            return bump(logits), cache

        mp.setattr(transformer, "decode_step", altered_step)
        mp.setattr(transformer, "prefill", altered_prefill)


CASES = [
    ("cardio-search", "state_unchanged"), ("cardio-search", "half_batch"),
    ("cardio-search", "answer_altered"),
    ("_cardio-hybrid-3axis", "state_unchanged"), ("_cardio-hybrid-3axis", "half_batch"),
    ("_cardio-hybrid-3axis", "answer_altered"),
    ("internvl2-image-ttft", "state_unchanged"), ("internvl2-image-ttft", "answer_altered"),
    ("_internvl2-chat-decode", "state_unchanged"), ("_internvl2-chat-decode", "half_batch"),
    ("_internvl2-chat-decode", "token_altered"),
]


@pytest.mark.parametrize("cell, fault", CASES, ids=[f"{c}-{f}" for c, f in CASES])
def test_fault_is_not_correct(monkeypatch, cell, fault):
    over = {k: dict(v) for k, v in tiny.OVERRIDES[cell].items()}
    if cell.lstrip("_").startswith("cardio"):
        search = dict(over["traffic"]["search"], **SEARCH["traffic"]["search"])
        over["traffic"] = dict(over["traffic"], search=search)
        _search_faults(monkeypatch, fault)
    else:
        over["cell"] = {"check_requests": 4}
        _lm_faults(monkeypatch, fault)
    _, out = tiny.run(cell, overrides=over)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("cell", sorted(tiny.OVERRIDES))
def test_sound_run_is_correct(cell):
    _, out = tiny.run(cell, seed=23)
    assert out["correct"] is True, out["checks"]


@pytest.mark.parametrize("cell", sorted(tiny.OVERRIDES))
def test_control_is_not_correct(cell):
    over = {k: dict(v) for k, v in tiny.OVERRIDES[cell].items()}
    if cell.lstrip("_").startswith("cardio"):
        # the cell's own 600 steps: TF32's rounding parts a row from the
        # fp32 reference over the steps, not within the first 60
        search = dict(over["traffic"]["search"], pop_size=8, max_steps=600)
        over["traffic"] = dict(over["traffic"], search=search)
    correct, compared = tiny.control(cell, overrides=over)
    assert correct is False, compared
