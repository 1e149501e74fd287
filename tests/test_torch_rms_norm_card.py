"""The norm kernel on the card (each test skips without a CUDA device).

    python3 -m pytest -q -m card tests/test_torch_rms_norm_card.py   # on an NVIDIA H100

* The kernel against ``layers.rms_norm`` run on the card, at K-EXAONE's
  prefill shapes (S 4096 and 32768: the hidden state, d 6144; q's 64 and
  k's 8 heads of 128) and decode shapes, internvl2's (its d is 6144 too),
  and ragged ones, in bf16 and fp32, with and without the residual, within
  ``tests/_torch_rms_norm.py``'s tolerance: at least 99.9% of rows bit-equal
  in bf16, any other row one ulp of ``inv`` off (bit for bit, each element
  within 3 ulps), fp32 within 2e-6.  A second call gives the same bits.
* The wrapper raises on what the kernel does not take and under autograd.
* Launches: a K-EXAONE prefill at its 48 layers makes 193 (96 with the
  residual), a decode step as many; an internvl2 prefill 97.  The widths
  are cut (the count does not depend on them), the head dim is 128.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from _torch_rms_norm import check_close  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels.rms_norm import ops  # noqa: E402
from repro_torch.models import build_model, init_cache  # noqa: E402

SHAPES = {
    "exaone_hidden_4096": (1, 4096, 6144), "exaone_hidden_32768": (1, 32768, 6144),
    "exaone_q_4096": (1, 4096, 64, 128), "exaone_q_32768": (1, 32768, 64, 128),
    "exaone_k_32768": (1, 32768, 8, 128), "decode_hidden": (4, 6144),
    "decode_q": (4, 64, 128), "ragged_1024": (1000, 1024), "one_row": (1, 8192),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the norm kernel runs on the card only")
    return torch.device("cuda")


def _inputs(shape, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=device)
    x = x * torch.exp(3 * torch.rand(shape[:-1] + (1,), generator=g, device=device))
    scale = 1 + 0.2 * torch.randn(shape[-1], generator=g, device=device)
    res = 4 * torch.randn(shape, generator=g, device=device)
    return x.to(dtype), scale.to(dtype), res.to(dtype)


@pytest.mark.card
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", list(SHAPES))
def test_kernel_matches_plain_on_the_card(card, case, dtype, residual):
    x, scale, res = _inputs(SHAPES[case], dtype, card, seed=len(case))
    r = res if residual else None
    with torch.inference_mode():
        got = ops.rms_norm(x, scale, 1e-5, r)
        again = ops.rms_norm(x, scale, 1e-5, r)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        check_close(got, x, scale, 1e-5, r)


@pytest.mark.card
def test_wrapper_refuses_on_the_card(card):
    x, scale, res = _inputs((8, 128), torch.bfloat16, card, seed=0)
    with pytest.raises(ValueError):  # not contiguous
        ops.rms_norm(x.t().contiguous().t(), scale, 1e-6)
    with pytest.raises(ValueError):  # not 16-byte aligned
        ops.rms_norm(x.reshape(-1)[1:1 + 7 * 128].reshape(7, 128), scale, 1e-6)
    with pytest.raises(ValueError):  # a width of 12: not whole vectors
        ops.rms_norm(x[:, :12].contiguous(), scale[:12].contiguous(), 1e-6)
    with pytest.raises(RuntimeError):  # autograd would record it
        ops.rms_norm(x.float().requires_grad_(), scale.float(), 1e-6)
    with torch.no_grad():
        ops.rms_norm(x.float().requires_grad_(), scale.float(), 1e-6)


def _counted_model(arch):
    cfg = dataclasses.replace(registry.reduced(registry.get(arch)), n_layers=48, head_dim=128,
                              dtype="bfloat16")
    model = build_model(cfg)
    return cfg, model, model.init_params(torch.Generator(device="cuda").manual_seed(0))


@pytest.mark.card
@pytest.mark.parametrize("arch, per_call, residual", [("k-exaone-236b-a23b", 193, 96),
                                                      ("internvl2-26b", 97, 0)])
def test_launches_a_prefill_and_a_decode_step(card, arch, per_call, residual):
    cfg, model, params = _counted_model(arch)
    g = torch.Generator(device=card).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (1, 256), generator=g, device=card)
    patches = None
    P = 0
    if cfg.family == "vlm":
        P = cfg.frontend_len
        patches = torch.rand((1, P, cfg.d_model), generator=g, device=card)
    with torch.inference_mode():
        ops.reset_launch_counts()
        logits, pre = model.prefill(params, tokens, patches)
        torch.cuda.synchronize()
        assert ops.LAUNCHES == {"rms_norm": per_call, "rms_norm_residual": residual}
        assert bool(torch.isfinite(logits).all())
        cache = init_cache(model, 1, P + 257, "cuda")
        for n, t in pre.items():
            if n.endswith("_win"):
                cache[n].copy_(t)
            else:
                cache[n][:, :, : P + 256] = t
        ops.reset_launch_counts()
        kv = torch.full((1,), P + 256, dtype=torch.int32, device=card)
        model.decode_step(params, tokens[:, -1], cache, kv)
        torch.cuda.synchronize()
        assert ops.LAUNCHES == {"rms_norm": per_call, "rms_norm_residual": residual}
