"""The port's pruned flash-ADC twin against the JAX reference and the gate-level circuit.

Levels are discrete decisions, so every comparison here is exact: the
same inputs (made from a seed with numpy) must give the same level, the
same dequantized STE value bit for bit, and the same comparator tables.
The port's own gate-level oracle (``adc.circuit_simulate``,
``adc.thermometer_code``) and ``adc.ADCSpec`` equal the reference's.
"""

import itertools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import adc as jadc  # noqa: E402
from repro.kernels.pruned_quant import ref as jpq  # noqa: E402
from repro_torch.core import adc  # noqa: E402
from repro_torch.kernels.pruned_quant import ref as pq  # noqa: E402


def _all_masks(n_bits: int) -> np.ndarray:
    """Every mask over levels 1..2^N-1 (level 0 is forced kept)."""
    n = 1 << n_bits
    return np.asarray([(True,) + b for b in itertools.product((False, True), repeat=n - 1)])


def _probe_grid(n_bits: int) -> np.ndarray:
    """Midpoints, exact thresholds, both sides of each, the domain edges and beyond."""
    n = 1 << n_bits
    thr = np.arange(1, n) / n
    pts = np.concatenate(
        [[0.0, 1.0 - 1e-7, -0.25, 1.0, 1.5], thr, thr - 1e-6, thr + 1e-6, thr - 1 / (2 * n)]
    )
    return pts.astype(np.float32)


@pytest.mark.parametrize("n_bits", [2, 3])
def test_levels_equal_reference_and_circuit_for_every_mask(n_bits):
    x = _probe_grid(n_bits)[:, None]
    for mask in _all_masks(n_bits):
        m = mask[None]
        got = adc.quantize_pruned(torch.from_numpy(x), torch.from_numpy(m), n_bits).numpy()
        want = np.asarray(jadc.quantize_pruned(jnp.asarray(x), jnp.asarray(m), n_bits))
        np.testing.assert_array_equal(got, want, err_msg=f"mask={mask.astype(int)}")
        np.testing.assert_array_equal(got, adc.circuit_simulate(x, m, n_bits))


def test_population_masks_match_reference_row_by_row():
    """(P, C, 2^N) masks with (P, B, C) inputs: each row its own bank."""
    rng = np.random.default_rng(11)
    P, B, C, n_bits = 4, 50, 6, 4
    masks = rng.uniform(size=(P, C, 16)) < 0.5
    masks[0] = True  # full bank
    masks[1, :, 1:] = False  # all pruned: level 0 only
    x = rng.uniform(-0.2, 1.2, (P, B, C)).astype(np.float32)
    got = adc.quantize_pruned(torch.from_numpy(x), torch.from_numpy(masks), n_bits).numpy()
    for p in range(P):
        want = np.asarray(jadc.quantize_pruned(jnp.asarray(x[p]), jnp.asarray(masks[p]), n_bits))
        np.testing.assert_array_equal(got[p], want)
    assert (got[1] == 0).all()


def test_ste_value_bit_equal_and_gradient_identity():
    rng = np.random.default_rng(5)
    x = rng.uniform(-0.1, 1.1, (64, 5)).astype(np.float32)
    mask = rng.uniform(size=(5, 16)) < 0.5
    xt = torch.from_numpy(x).requires_grad_(True)
    got = adc.quantize_pruned_ste(xt, torch.from_numpy(mask), 4)
    want = np.asarray(jadc.quantize_pruned_ste(jnp.asarray(x), jnp.asarray(mask), 4))
    np.testing.assert_array_equal(got.detach().numpy(), want)
    got.sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.ones_like(x))
    jg = jax.grad(lambda v: jnp.sum(jadc.quantize_pruned_ste(v, jnp.asarray(mask), 4)))(
        jnp.asarray(x)
    )
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jg))


@pytest.mark.parametrize("n_bits", [2, 4])
def test_tables_and_helpers_equal_reference(n_bits):
    rng = np.random.default_rng(n_bits)
    masks = rng.uniform(size=(3, 7, 1 << n_bits)) < 0.5
    thr, ids = pq.make_tables(torch.from_numpy(masks), n_bits)
    for p in range(3):
        jthr, jids = jpq.make_tables(jnp.asarray(masks[p]), n_bits)
        np.testing.assert_array_equal(thr[p].numpy(), np.asarray(jthr))
        np.testing.assert_array_equal(ids[p].numpy(), np.asarray(jids))
        np.testing.assert_array_equal(
            adc.kept_thresholds(torch.from_numpy(masks[p]), n_bits).numpy(),
            np.asarray(jadc.kept_thresholds(jnp.asarray(masks[p]), n_bits)),
        )
    x = rng.uniform(-0.5, 1.5, (3, 40, 7)).astype(np.float32)
    lv = pq.pruned_quantize_ref(torch.from_numpy(x), thr[:, None], ids[:, None])
    np.testing.assert_array_equal(
        lv.numpy(), adc.quantize_pruned(torch.from_numpy(x), torch.from_numpy(masks), n_bits)
    )
    np.testing.assert_array_equal(
        adc.levels_to_values(lv, n_bits).numpy(),
        np.asarray(jadc.levels_to_values(jnp.asarray(lv.numpy()), n_bits)),
    )
    m0 = adc.force_level0(torch.zeros(2, 1 << n_bits, dtype=torch.bool))
    np.testing.assert_array_equal(m0[:, 0].numpy(), True)


@pytest.mark.parametrize("n_bits", [2, 3, 4])
def test_circuit_oracle_equals_reference_for_every_mask(n_bits):
    """Every mask over levels 1..2^N-1 as one bank of channels, each channel probed at the
    grid: the thermometer code and the encoded levels equal the reference's, and
    the fast path equals the circuit."""
    masks = _all_masks(n_bits)  # (2^(2^N - 1), 2^N): one channel a mask
    x = np.repeat(_probe_grid(n_bits)[:, None], masks.shape[0], axis=1)  # (probes, C)
    np.testing.assert_array_equal(adc.thermometer_code(x, masks, n_bits),
                                  jadc.thermometer_code(x, masks, n_bits))
    got = adc.circuit_simulate(x, masks, n_bits)
    assert got.dtype == np.int64 and got.shape == x.shape
    np.testing.assert_array_equal(got, jadc.circuit_simulate(x, masks, n_bits))
    fast = adc.quantize_pruned(torch.from_numpy(x), torch.from_numpy(masks), n_bits).numpy()
    np.testing.assert_array_equal(fast, got)
    # a pruned comparator never fires; vref scales the thresholds
    assert not adc.thermometer_code(x, masks & False, n_bits).any()
    np.testing.assert_array_equal(adc.circuit_simulate(2 * x, masks, n_bits, vref=2.0), got)


@pytest.mark.parametrize("n_bits,n_channels,vref", [(4, 1, 1.0), (3, 21, 1.0), (2, 6, 2.5)])
def test_adc_spec_equals_reference(n_bits, n_channels, vref):
    spec, jspec = adc.ADCSpec(n_bits, n_channels, vref), jadc.ADCSpec(n_bits, n_channels, vref)
    assert (spec.n_bits, spec.n_channels, spec.vref, spec.n_levels) == (
        jspec.n_bits, jspec.n_channels, jspec.vref, jspec.n_levels)
    mask = spec.full_mask("cpu")
    assert mask.dtype == torch.bool and mask.device.type == "cpu"
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jspec.full_mask()))
    assert adc.ADCSpec() == adc.ADCSpec(4, 1, 1.0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            spec.full_mask()
