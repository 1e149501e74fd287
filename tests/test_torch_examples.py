"""The port's twins of ``examples/{adc_codesign, quickstart, serve_lm}.py``
against the reference examples.

Under one deterministic objective (``_torch_shared.patch_evaluators``:
both packages' evaluators replaced, which also routes round the
reference's sharding fault under JAX 0.9.0) the co-design twins print the
reference's lines character for character, at the CI budget and at the
paper's full budget (the objective is NumPy, so the full budget trains
nothing).  Only the heading of the comparator-bank demo differs: it names
the route that ran (the reference's Pallas kernel in interpret mode, the
port's plain PyTorch version here).  ``serve_lm`` with the reference's
parameters carried across gives the reference's requests.  Without
``--device`` each twin raises on this card-less host and runs nothing.
"""

import importlib.util
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_lm import carried  # noqa: E402
from _torch_shared import patch_evaluators  # noqa: E402

from repro.core.frontend import kv_codebook_quantize as jkv_codebook_quantize  # noqa: E402
from repro.kernels.pruned_quant import ops as jpq_ops  # noqa: E402
from repro_torch.core import campaign, codesign  # noqa: E402
from repro_torch.launch import adc_codesign, quickstart, serve_lm  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
# the lines of adc_codesign's output: six datasets, "", MEAN, "", the K1
# heading, input[0], levels[0], "", the KV codebook
K1_HEADING = 9


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are tiny, and the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference(name: str, argv: list, monkeypatch, capsys) -> list:
    """The lines the reference's ``examples/<name>.py`` prints with ``argv``."""
    spec = importlib.util.spec_from_file_location(f"_example_{name}", EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    monkeypatch.setattr(sys, "argv", [name, *argv])
    capsys.readouterr()
    module.main()
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("quick", [True, False], ids=["quick", "full"])
def test_adc_codesign_prints_the_reference_lines(monkeypatch, capsys, quick):
    patch_evaluators(monkeypatch)
    want = _reference("adc_codesign", ["--quick"] if quick else [], monkeypatch, capsys)
    got = adc_codesign.run(quick, "cpu")
    assert len(got["lines"]) == len(want) == K1_HEADING + 5
    assert got["lines"][:K1_HEADING] == want[:K1_HEADING]  # every dataset and MEAN
    assert want[K1_HEADING].startswith("Pallas pruned-quant kernel on the searched Seeds")
    assert got["lines"][K1_HEADING] == ("Pruned-quant comparator bank (its plain PyTorch "
                                        "version) on the searched Seeds ADC bank:")
    assert got["lines"][K1_HEADING + 1:] == want[K1_HEADING + 1:]  # input, levels, KV
    # main prints what run returns
    monkeypatch.setattr(sys, "argv", ["adc_codesign", "--device", "cpu"]
                        + (["--quick"] if quick else []))
    adc_codesign.main()
    assert capsys.readouterr().out.splitlines() == got["lines"]


def test_adc_codesign_runs_the_configured_budget(monkeypatch):
    patch_evaluators(monkeypatch)
    seen = []
    run_codesign = codesign.run_codesign
    monkeypatch.setattr(codesign, "run_codesign", lambda cfg: seen.append(cfg) or run_codesign(cfg))
    adc_codesign.search(False, "cpu")
    assert [c.dataset for c in seen] == list(adc_codesign.PAPER_DATASETS)
    assert {(c.pop_size, c.n_generations, c.step_scale, c.max_steps, c.device)
            for c in seen} == {(24, 16, 1.0, 600, "cpu")}


def test_quick_gains_equal_the_default_campaign(monkeypatch):
    patch_evaluators(monkeypatch)
    got = adc_codesign.run(True, "cpu")
    want = campaign.run_campaign(campaign.CampaignConfig(device="cpu"))
    assert list(want.gains) == list(got["searches"])
    for ds, (res, g5, _) in got["searches"].items():
        for k, v in want.gains[ds].items():
            np.testing.assert_array_equal(g5[k], v, err_msg=f"{ds}: {k}")
        np.testing.assert_array_equal(res.front_acc, want.results[ds].front_acc)
    assert got["mean_area_gain"] == want.mean_area_gain
    assert got["mean_power_gain"] == want.mean_power_gain


def test_searched_bank_levels_equal_the_pallas_kernel(monkeypatch):
    patch_evaluators(monkeypatch)
    mask = adc_codesign.search(True, "cpu")["seeds"][1]["mask"]
    x, levels = adc_codesign.searched_bank_levels(mask, "cpu")
    assert x.shape == (8, mask.shape[0]) and levels.dtype == torch.int32
    want = jpq_ops.pruned_quantize(jnp.asarray(x.numpy()), jnp.asarray(mask), 4)  # interpret
    np.testing.assert_array_equal(levels.numpy(), np.asarray(want))
    # other banks through the same helper: all levels kept, level 0 only, a random one
    rng = np.random.default_rng(3)
    for m in (np.ones_like(mask), np.eye(1, 16, 0, bool).repeat(mask.shape[0], 0),
              rng.uniform(size=mask.shape) < 0.4):
        m[:, 0] = True
        _, lv = adc_codesign.searched_bank_levels(m, "cpu")
        np.testing.assert_array_equal(
            lv.numpy(), np.asarray(jpq_ops.pruned_quantize(jnp.asarray(x.numpy()),
                                                           jnp.asarray(m), 4)))


def test_kv_codebook_equals_the_reference():
    kv, codes, deq = adc_codesign.kv_codebook_demo("cpu")
    rng = np.random.default_rng(1)
    jkv = jnp.asarray(rng.normal(size=(4, 16)).astype(np.float32))
    grid = np.linspace(-3, 3, 16)
    keep = np.sort(rng.choice(16, size=6, replace=False))
    jcodes, jdeq = jkv_codebook_quantize(
        jkv, jnp.asarray(np.tile(grid[keep], (16, 1)).astype(np.float32)))
    np.testing.assert_array_equal(kv.numpy(), np.asarray(jkv))
    assert codes.dtype == torch.uint8 and jcodes.dtype == jnp.uint8
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(deq.numpy(), np.asarray(jdeq))
    # the mean of |err|: the printed digits equal; the fp32 sums differ in order only
    err, jerr = float(torch.mean(torch.abs(kv - deq))), float(jnp.mean(jnp.abs(jkv - jdeq)))
    assert f"{err:.3f}" == f"{jerr:.3f}"
    np.testing.assert_allclose(err, jerr, rtol=1e-6)


def test_quickstart_prints_the_reference_lines(monkeypatch, capsys):
    patch_evaluators(monkeypatch)
    want = _reference("quickstart", [], monkeypatch, capsys)
    got = quickstart.run("cpu")
    assert got["lines"] == want
    assert sum(line.startswith("  acc=") for line in want) == got["result"].front_acc.size >= 1
    assert (got["cfg"].pop_size, got["cfg"].n_generations, got["cfg"].max_steps) == (16, 8, 400)
    monkeypatch.setattr(sys, "argv", ["quickstart", "--device", "cpu"])
    quickstart.main()
    assert capsys.readouterr().out.splitlines() == want


@pytest.mark.parametrize("arch", ["yi-9b", "rwkv6-1.6b"])
def test_serve_lm_serves_the_reference_requests(monkeypatch, capsys, arch):
    want = _reference("serve_lm", ["--arch", arch], monkeypatch, capsys)
    _, _, _, params = carried(arch, seed=0)
    got = serve_lm.run(arch, "cpu", params=params)
    n = 10
    assert got["lines"][:n] == want[:n]  # "request i: [...]", every token
    assert all(len(t) >= serve_lm.GEN_LEN for t in got["requests"].values())
    # the counts before the parenthesis; the rate is each package's own clock
    assert got["lines"][n + 1].split(" (")[0] == want[n + 1].split(" (")[0]
    assert got["lines"][n + 1].endswith("plain PyTorch on the CPU)")
    assert got["lines"][-1] == want[-1] == "OK: all requests completed"


def test_serve_lm_refuses_short_requests(monkeypatch):
    real = serve_mod.run

    def truncated(cfg, params=None):
        out = real(cfg, params)
        out["requests"][3] = out["requests"][3][:5]
        return out

    monkeypatch.setattr(serve_mod, "run", truncated)
    with pytest.raises(RuntimeError, match="fewer than 12 tokens"):
        serve_lm.run("yi-9b", "cpu")


@pytest.mark.parametrize("twin, target", [
    (adc_codesign, (codesign, "run_codesign")),
    (quickstart, (codesign, "run_codesign")),
    (serve_lm, (serve_mod, "run")),
], ids=["adc_codesign", "quickstart", "serve_lm"])
def test_twins_default_to_the_card_and_raise_without_one(monkeypatch, twin, target):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    monkeypatch.setattr(*target, lambda *a, **kw: ran.append(a))
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        twin.run()
    monkeypatch.setattr(sys, "argv", [twin.__name__])
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        twin.main()
    assert not ran
