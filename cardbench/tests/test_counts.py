"""The frozen counts against hand counts at tiny shapes and PERF.md's recorded bounds."""

import pytest

from cardbench import counts as c


def _ms(nbytes, ops, peak):
    return max(nbytes / c.HBM_BYTES_PER_S, ops / peak) * 1e3


def test_flash_bound_hand_count():
    # q, out: 1*4*2*8 each; k, v: 1*4*1*8 each; bf16.  Causal pairs 1+2+3+4.
    assert c.flash_bound(1, 4, 4, 2, 1, 8, True)[0] == pytest.approx(
        _ms((2 * 64 + 2 * 32) * 2, 4 * 1 * 2 * 8 * 10, c.BF16_FLOPS))
    assert c.flash_bound(1, 2, 5, 1, 1, 4, False, itemsize=4)[0] == pytest.approx(
        _ms((2 * 8 + 2 * 20) * 4, 4 * 4 * 10, c.FP32_FLOPS))
    # causal with Sk < Sq: every query past Sk sees all Sk keys
    assert c.flash_bound(1, 5, 3, 1, 1, 2, True)[0] == pytest.approx(
        _ms((2 * 10 + 2 * 6) * 2, 4 * 2 * (1 + 2 + 3 + 3 + 3), c.BF16_FLOPS))


def test_decode_and_k1_hand_counts():
    assert c.decode_bound(2, 2, 1, 8, 4, 5)[0] == pytest.approx(
        _ms((2 * 2 * 2 * 4 + 2 * 5 * 1 * 4) * 2 + 8, 4 * 2 * 4 * 5, c.BF16_FLOPS))
    assert c.k1_bound(3, 2)[0] == pytest.approx(_ms(8 * 6 + 8 * 2 * 15, 2 * 3 * 2 * 15,
                                                    c.FP32_FLOPS))


def test_qat_bound_hand_count():
    # P=1, B=2, C=1, F=1, T=1: x 8 B, tables 8 B, w 4 B, bias 4 B, out 8 B
    assert c.bound_ms(2, False, P=1, C=1, F=1, T=1)[0] == pytest.approx(
        _ms(32, 2 * 5 + 4, c.FP32_FLOPS))
    # backward without dx: x, tables, g read; dw written
    assert c.bound_ms(2, True, need_dx=False, P=1, C=1, F=1, T=1)[0] == pytest.approx(
        _ms(8 + 8 + 8 + 4, 2 * 5 + 4, c.FP32_FLOPS))


@pytest.mark.parametrize("got, want", [
    (lambda: c.flash_bound(1, 4096, 4096, 32, 4, 128, True), (0.139002, "operations")),
    (lambda: c.decode_bound(4, 32, 4, 4096, 128, 9797), (0.006009, "bytes")),
    (lambda: c.k1_bound(4 * 256, 6144), (0.015244, "bytes")),
    (lambda: c.bound_ms(128, False), (0.000117, "bytes")),
    (lambda: c.bound_ms(128, True, need_dx=False), (0.000116, "bytes")),
], ids=["K4_yi9b_prefill", "K5_yi9b_decode", "K1_internvl2_patches", "K2", "K3"])
def test_recorded_bounds(got, want):
    """PERF.md's kernel table: K4 at yi-9b's prefill, K5 at its decode (the
    cache lengths the table's run drew sum to 9797 rows), K1 at four
    internvl2 images, K2/K3 at P=24, B=128."""
    ms, by = got()
    assert (round(ms, 6), by) == want


def test_step_flops_hand_counts():
    # 21-5-3: forward 2*(105+15), weight grads the same, input grads of layer 2
    assert c.mlp_sample_flops([21, 5, 3]) == 240 + 240 + 30
    assert c.mlp_sample_flops([21, 5, 3], train=False) == 240
    assert c.step_budget(128, 60, 1488, 1.0, 600) == 600
    assert c.step_budget(64, 2, 100, 0.5, 600) == 2
    assert c.qat_row_flops([2, 1], 4, 1, 8, 3, 1.0, 600) == 2 * 4 * 8 + 3 * 4
    # L=1, d=2, H=Hkv=1, hd=2, d_ff=1, V=5: linear weights 4+8+4+6 = 22
    assert c.linear_params(1, 2, 1, 1, 2, 1) == 22
    assert c.prefill_flops(3, 1, 1, 2, 1, 1, 2, 1, 5) == 2 * 3 * 22 + 2 * 3 * 2 * 5 + 8 + 4 * 2 * 6
    assert c.decode_flops(2, 3, 1, 2, 1, 1, 2, 1, 5) == 2 * 2 * (22 + 10) + 4 * 2 * 3
