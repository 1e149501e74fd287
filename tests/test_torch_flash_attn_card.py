"""K4's bf16 tensor-core kernel on the card (each test skips without a CUDA device).

    python3 -m pytest -q -m card tests/test_torch_flash_attn_card.py

``flash_attn.ops.flash_attention`` on bf16 CUDA tensors launches
``flash_attn_tc_kernel<D>`` (``flash_attn_tc_window_kernel<D>`` with a
window).  Held here against the plain version ``ref.flash_attention_ref``
(fp32 scores and softmax on the same bf16 inputs, the output rounded to
bf16) at the bf16 gate 3e-2 that ``chip_smoke.py``'s attention phase uses:
both round the same fp32 function to bf16, and the kernel rounds P to bf16
before P.V.  Cases: every head dim the kernel has, causal and non-causal
calls with Sq != Sk, ragged Sq of 1000 and 130, K-EXAONE's global layers
(S 4096 and 32768, 64/8 heads) and InternVL2's (4352, 48/8); the window
instance at ``chip_smoke.py``'s WINDOW_CASES, where a window past every
distance must give the causal call's bits.  Each call is made twice and
must give the same bits, and ``LAUNCHES`` must count one
``flash_attention_tc`` a call.  The plain version runs in blocks of 1024
queries past 4096 positions (its whole scores at 32768 would be 275 GB).
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attn import ops, ref  # noqa: E402

TOL = dict(rtol=3e-2, atol=3e-2)
BLOCK_Q = 1024

# (B, Sq, Sk, Hq, Hkv, d, causal)
HEAD_DIM_CASES = [(2, 300, 300, 8, 2, d, True) for d in ops.TC_HEAD_DIMS] + [
    (1, 200, 333, 4, 4, d, False) for d in ops.TC_HEAD_DIMS]
SHAPES = {
    **{f"d{c[5]}_{'causal' if c[6] else 'cross'}": c for c in HEAD_DIM_CASES},
    "causal_sq_lt_sk": (1, 130, 300, 8, 2, 128, True),
    "causal_sq_gt_sk": (1, 300, 130, 8, 2, 128, True),
    "cross_sq_gt_sk": (2, 1000, 257, 16, 2, 128, False),
    "ragged_1000": (2, 1000, 1000, 16, 2, 128, True),
    "ragged_130": (1, 130, 130, 8, 8, 64, True),
    "kexaone_4096": (1, 4096, 4096, 64, 8, 128, True),
    "kexaone_32768": (1, 32768, 32768, 64, 8, 128, True),
    "internvl2_4352": (1, 4352, 4352, 48, 8, 128, True),
}
# chip_smoke.py's WINDOW_CASES: (B, S, Hq, Hkv, d, window)
WINDOW_CASES = [
    (1, 4096, 64, 8, 128, 128),
    (1, 32768, 64, 8, 128, 128),
    (1, 100, 64, 8, 128, 128),    # shorter than the window
    (2, 1000, 16, 2, 128, 128),   # ragged tile edge, two rows
    (1, 777, 8, 8, 64, 100),      # a window that is no multiple of a key tile
    (1, 513, 8, 2, 128, 1),       # each query keeps itself alone
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: K4's tensor-core kernel runs on the card only")
    return torch.device("cuda")


def _qkv(B, Sq, Sk, Hq, Hkv, d, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(B, Sq, Hq, d, generator=g, device=device).bfloat16(),
            torch.randn(B, Sk, Hkv, d, generator=g, device=device).bfloat16(),
            torch.randn(B, Sk, Hkv, d, generator=g, device=device).bfloat16())


def _twice(q, k, v, causal, window=None):
    """Two calls: the output, whether both gave the same bits, and the launches they counted."""
    ops.reset_launch_counts()
    with torch.inference_mode():
        out = ops.flash_attention(q, k, v, causal, window)
        again = ops.flash_attention(q, k, v, causal, window)
    torch.cuda.synchronize()
    return out, bool(torch.equal(out.view(torch.int16), again.view(torch.int16))), dict(ops.LAUNCHES)


def _plain(q, k, v, causal, window=None):
    block_q = BLOCK_Q if q.shape[1] > 4096 else 0
    with torch.inference_mode():
        return ref.flash_attention_ref(q, k, v, causal, window, block_q=block_q)


@pytest.mark.card
@pytest.mark.parametrize("case", list(SHAPES))
def test_kernel_matches_plain_on_the_card(card, case):
    B, Sq, Sk, Hq, Hkv, d, causal = SHAPES[case]
    q, k, v = _qkv(B, Sq, Sk, Hq, Hkv, d, card, seed=Sq + Sk + d)
    out, same_bits, launches = _twice(q, k, v, causal)
    assert same_bits
    assert launches == {"flash_attention": 2, "flash_attention_tc": 2,
                        "flash_attention_fp32": 0, "flash_attention_window": 0, "flash_attention_dv": 0}
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    torch.testing.assert_close(out, _plain(q, k, v, causal), **TOL)


@pytest.mark.card
@pytest.mark.parametrize("case", WINDOW_CASES, ids=lambda c: "_".join(map(str, c)))
def test_window_matches_plain_on_the_card(card, case):
    B, S, Hq, Hkv, d, W = case
    q, k, v = _qkv(B, S, S, Hq, Hkv, d, card, seed=S + W)
    out, same_bits, launches = _twice(q, k, v, True, W)
    assert same_bits
    assert launches == {"flash_attention": 2, "flash_attention_tc": 2,
                        "flash_attention_fp32": 0, "flash_attention_window": 2, "flash_attention_dv": 0}
    torch.testing.assert_close(out, _plain(q, k, v, True, W), **TOL)
    if W >= S:  # no key lies past the window: the causal kernel's bits
        causal, _, _ = _twice(q, k, v, True)
        assert torch.equal(out.view(torch.int16), causal.view(torch.int16))
