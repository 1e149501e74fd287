"""The port's pruned-ADC frontend against the reference: K1 and ``core/frontend``.

On the CPU the port's K1 wrapper (``kernels/pruned_quant/ops``) runs its
plain PyTorch version; the reference's ``pruned_quantize`` runs its Pallas
kernel in interpret mode (``use_pallas=True``, as
``tests/test_kernels_pruned_quant.py`` runs it) and its pure-jnp oracle
(``use_pallas=False``).  Inputs come from a seed with numpy.

Tolerances: none.  Levels and codebook codes are integers, and the
frontend's output ``x + (v - x)`` is the same fp32 operations on equal
values, so everything is compared bit for bit (NaN where the reference
gives NaN).
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import frontend as jfe  # noqa: E402
from repro.kernels.pruned_quant import ops as jpq  # noqa: E402
from repro_torch.core import frontend as fe  # noqa: E402
from repro_torch.kernels.pruned_quant import ops as pq  # noqa: E402
from repro_torch.kernels.pruned_quant import ref as pq_ref  # noqa: E402

# NaN, +-inf, below 0, at and above vref, -0.0
EDGES = np.array([np.nan, np.inf, -np.inf, -0.5, -0.0, 0.0, 1.0, 1.5, 7.0], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are tiny, and the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(shape, n_bits, seed, mask_kind="random"):
    """x (..., C) with the edge inputs and every threshold k / 2^N planted, and a mask."""
    rng = np.random.default_rng(seed)
    C = shape[-1]
    n = 1 << n_bits
    x = rng.uniform(-0.1, 1.1, shape).astype(np.float32)
    flat = x.reshape(-1, C)
    on_thr = (np.arange(n, dtype=np.float32) / n)  # exactly on each comparator
    k = min(flat.shape[0], n)
    flat[:k, 0] = on_thr[:k]
    for i, e in enumerate(EDGES):
        if i < flat.shape[0]:
            flat[-1 - i, C // 2] = e
    if mask_kind == "full":
        mask = np.ones((C, n), bool)
    elif mask_kind == "level0":
        mask = np.zeros((C, n), bool)
    else:
        mask = rng.uniform(size=(C, n)) < rng.uniform(0.1, 1.0)
        mask[0] = True           # a full bank
        if C > 1:
            mask[1, 1:] = False  # level 0 only
    return x, mask


def _jax_levels(x, mask, n_bits, use_pallas):
    return np.asarray(jpq.pruned_quantize(jnp.asarray(x), jnp.asarray(mask), n_bits,
                                          use_pallas=use_pallas))


@pytest.mark.parametrize("n_bits", [2, 3, 4, 5])
@pytest.mark.parametrize("shape", [(1, 21), (7, 21), (257, 6), (3, 5, 16), (2, 4, 3, 9)])
def test_k1_levels_equal_reference(n_bits, shape):
    x, mask = _inputs(shape, n_bits, seed=n_bits * 100 + len(shape) * 10 + shape[-1])
    want = _jax_levels(x, mask, n_bits, use_pallas=True)
    np.testing.assert_array_equal(want, _jax_levels(x, mask, n_bits, use_pallas=False))
    got = pq.pruned_quantize(torch.from_numpy(x), torch.from_numpy(mask), n_bits)
    assert got.dtype == torch.int32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)
    thr, ids = pq_ref.make_tables(torch.from_numpy(mask), n_bits)
    plain = pq_ref.pruned_quantize_ref(torch.from_numpy(x).reshape(-1, shape[-1]), thr, ids)
    np.testing.assert_array_equal(plain.reshape(shape).numpy(), want)


@pytest.mark.parametrize("mask_kind", ["full", "random", "level0"])
def test_k1_edge_inputs_and_masks(mask_kind):
    """Every edge input against every kept comparator, and a vref other than 1."""
    n_bits = 4
    x = np.concatenate([EDGES, np.arange(17, dtype=np.float32) / 16]).astype(np.float32)
    x = np.tile(x[:, None], (1, 11))
    _, mask = _inputs((1, 11), n_bits, seed=5, mask_kind=mask_kind)
    for vref in (1.0, 2.5):
        xs = x * np.float32(vref)
        want = np.asarray(jpq.pruned_quantize(jnp.asarray(xs), jnp.asarray(mask), n_bits, vref))
        got = pq.pruned_quantize(torch.from_numpy(xs), torch.from_numpy(mask), n_bits, vref)
        np.testing.assert_array_equal(got.numpy(), want)
    if mask_kind == "level0":
        assert not got.any()


def test_k1_cpu_tensor_launches_nothing():
    pq.reset_launch_counts()
    x, mask = _inputs((64, 21), 4, seed=1)
    pq.pruned_quantize(torch.from_numpy(x), torch.from_numpy(mask))
    f = fe.PrunedQuantFrontend(fe.FrontendConfig(21, use_pallas=True), torch.from_numpy(mask))
    f(torch.from_numpy(x))
    assert pq.LAUNCHES == {"pruned_quantize": 0}


def test_k1_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="does not fit"):
        pq.pruned_quantize(x, torch.ones(8, 8, dtype=torch.bool), 4)
    with pytest.raises(TypeError, match="float32"):
        pq.pruned_quantize(x.double(), torch.ones(8, 16, dtype=torch.bool), 4)


def _bits_equal(got: np.ndarray, want: np.ndarray):
    """Bit-for-bit equality, NaN where the reference is NaN (any NaN payload)."""
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.uint32), want[~nan].view(np.uint32))


@pytest.mark.parametrize("n_bits", [3, 4])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_frontend_output_bit_equal_reference(n_bits, use_pallas):
    x, mask = _inputs((5, 7, 13), n_bits, seed=20 + n_bits)
    port = fe.PrunedQuantFrontend(fe.FrontendConfig(13, n_bits, use_pallas=use_pallas),
                                  torch.from_numpy(mask))
    got = port(torch.from_numpy(x)).numpy()
    for jroute in (False, True):
        ref = jfe.PrunedQuantFrontend(jfe.FrontendConfig(13, n_bits, use_pallas=jroute), mask)
        _bits_equal(got, np.asarray(ref(jnp.asarray(x))))
    assert np.isnan(got[np.isinf(x)]).all()  # x + (v - x) at +-inf, as in the reference
    np.testing.assert_array_equal(
        port.kept_levels().numpy(), np.asarray(jfe.PrunedQuantFrontend(
            jfe.FrontendConfig(13, n_bits), mask).kept_levels()))


def test_frontend_routes_give_equal_levels_and_a_default_full_mask():
    x, _ = _inputs((40, 6), 4, seed=9)
    routes = [fe.PrunedQuantFrontend(fe.FrontendConfig(6, use_pallas=p)) for p in (False, True)]
    a, b = (r.levels(torch.from_numpy(x)) for r in routes)
    assert torch.equal(a, b)
    assert routes[0].mask.shape == (6, 16) and bool(routes[0].mask.all())
    assert "mask" in dict(routes[0].named_buffers())
    # grid values are fixed points of the frontend
    grid = torch.arange(16, dtype=torch.float32).repeat(6, 1).T / 16
    assert torch.equal(routes[1](grid), grid)


def test_frontend_gradient_is_straight_through():
    f = fe.PrunedQuantFrontend(fe.FrontendConfig(3, 4))
    x = torch.full((2, 3), 0.4, requires_grad=True)
    f(x).sum().backward()
    torch.testing.assert_close(x.grad, torch.ones(2, 3), rtol=0, atol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_kv_codebook_quantize_matches_reference(seed):
    rng = np.random.default_rng(seed)
    d, L = 8, 6
    levels = np.sort(rng.normal(size=(d, L)).astype(np.float32), axis=-1)
    kv = rng.normal(scale=1.5, size=(3, 5, d)).astype(np.float32)
    kv[0, 0] = levels[:, 2]  # exactly on a level
    kv[0, 1] = -9.0          # below every level
    codes, deq = fe.kv_codebook_quantize(torch.from_numpy(kv), torch.from_numpy(levels))
    jcodes, jdeq = jfe.kv_codebook_quantize(jnp.asarray(kv), jnp.asarray(levels))
    assert codes.dtype == torch.uint8
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    _bits_equal(deq.numpy(), np.asarray(jdeq))
