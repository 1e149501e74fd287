"""The port's QAT primitives and printed-MLP forward against the JAX reference.

Inputs come from a seed with numpy.  The quantizers are exact elementwise
arithmetic (``torch.round`` and ``jnp.round`` both round half to even), so
their values must be bit-equal.  The MLP forward and its gradients are fp32
sums in another order on each side (fixed pairwise sums in the port, XLA's
dot here), so they are held at a stated fp32 tolerance.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import qat as jqat  # noqa: E402
from repro.data import uci_synth  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import qat  # noqa: E402

# Logits: the reference's own 1-ulp fused-vs-unfused bound (measured on
# these inputs: bit-equal).  Gradients: the reference's fused-vs-unfused
# gradient bound; batch sums in pairwise vs XLA's order and a differently
# rounded softmax gradient (measured max gap 1.5e-8 absolute, gradients up
# to 0.1).
LOGIT_TOL = dict(rtol=1e-6, atol=1e-6)
GRAD_TOL = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are tiny, and the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pow2_oracle(w: np.ndarray, bits: int) -> np.ndarray:
    """sign(w) * 2^clip(round(log2|w|)) with exact powers (np.ldexp), pruned below range."""
    e_lo = -(2 ** (bits - 1)) + 1
    mag = np.abs(w).astype(np.float64)
    e = np.clip(np.round(np.log2(np.maximum(mag, 1e-12))), e_lo, 0).astype(int)
    q = np.where(mag < 2.0 ** (e_lo - 1), 0.0, np.sign(w) * np.ldexp(1.0, e))
    return (w + (q.astype(np.float32) - w)).astype(np.float32)


@pytest.mark.parametrize("bits", [4, 5, 6, 7, 8])
def test_quantize_pow2_matches_reference(bits):
    """Exact powers of two; equal to the reference wherever its exp2 is exact.

    XLA's CPU ``exp2`` misses exact powers of two below 2^-12 by up to
    1.01e-6 relative (measured over e in [-30, 0]: e = -13 and e <= -15),
    so the reference's tiny po2 weights carry that error; ``torch.exp2`` is
    exact.  Above 2^-12 the two must be bit-equal; below it they may differ
    by that measured gap and no more.
    """
    rng = np.random.default_rng(bits)
    w = np.concatenate([rng.normal(0, 0.5, 500), [0.0, -0.0, 1.0, -1.0, 3.0, 1e-6, 9e-5]])
    w = w.astype(np.float32)
    got = qat.quantize_pow2(torch.from_numpy(w), bits).numpy()
    np.testing.assert_array_equal(got, _pow2_oracle(w, bits))
    want = np.asarray(jqat.quantize_pow2(jnp.asarray(w), bits))
    big = np.abs(got) >= 2.0 ** -12
    np.testing.assert_array_equal(got[big], want[big])
    np.testing.assert_allclose(got[~big], want[~big], rtol=1.1e-6, atol=0)
    # per-row widths broadcast like the reference's traced scalars
    rows = torch.from_numpy(w[:500].reshape(5, 100))
    wb = torch.tensor([4.0, 5.0, 6.0, 7.0, 8.0])[:, None]
    want = [_pow2_oracle(w[i * 100:(i + 1) * 100], 4 + i) for i in range(5)]
    np.testing.assert_array_equal(qat.quantize_pow2(rows, wb).numpy(), np.stack(want))


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6])
@pytest.mark.parametrize("signed", [False, True])
def test_quantize_uniform_bit_equal(bits, signed):
    x = np.random.default_rng(bits).uniform(-1.2, 1.2, 400).astype(np.float32)
    got = qat.quantize_uniform(torch.from_numpy(x), bits, signed).numpy()
    want = np.asarray(jqat.quantize_uniform(jnp.asarray(x), bits, signed))
    np.testing.assert_array_equal(got, want)


def test_quantizers_pass_gradient_straight_through():
    w = torch.linspace(-1, 1, 33).requires_grad_(True)
    (qat.quantize_pow2(w, 6) * 3.0 + qat.quantize_uniform(w, 4)).sum().backward()
    torch.testing.assert_close(w.grad, torch.full_like(w, 4.0), rtol=0, atol=0)


def _seeds_rows():
    X, y, spec = uci_synth.load("seeds")
    cfg = jqat.MLPConfig((spec.n_features, spec.hidden, spec.n_classes))
    rng = np.random.default_rng(0)
    P, B = 2, 128
    idx = rng.integers(0, X.shape[0], (P, B))
    masks = rng.uniform(size=(P, spec.n_features, 16)) < 0.6
    masks[:, :, 0] = True
    keys = jax.random.split(jax.random.PRNGKey(3), P)
    jparams = jax.vmap(lambda k: jqat.init_mlp(k, cfg))(keys)
    return X[idx], y[idx], masks, cfg, jparams


def test_mlp_forward_and_gradients_match_reference():
    """seeds (7 -> 3 -> 3), P = 2 rows with their own masks and precisions."""
    x, y, masks, jcfg, jparams = _seeds_rows()
    wb, ab = np.asarray([8.0, 5.0], np.float32), np.asarray([4.0, 3.0], np.float32)
    cfg = qat.MLPConfig(jcfg.layer_sizes)
    params = params_from_jax({k: np.asarray(v) for k, v in jparams.items()}, "cpu")
    for v in params.values():
        v.requires_grad_(True)
    logits = qat.mlp_forward(params, torch.from_numpy(x), cfg, torch.from_numpy(masks), wb, ab)
    ce = qat.cross_entropy(logits, torch.from_numpy(y))
    ce.mean(-1).sum().backward()

    def jloss(p, xb, yb, m, wbi, abi):
        out = jqat.mlp_forward(p, xb, jcfg, m, wbi, abi)
        logp = jax.nn.log_softmax(out, axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, yb[:, None], axis=-1)), out

    for p in range(2):
        row = {k: v[p] for k, v in jparams.items()}
        args = (jnp.asarray(x[p]), jnp.asarray(y[p]), jnp.asarray(masks[p]), wb[p], ab[p])
        (jce, jout), jg = jax.value_and_grad(jloss, has_aux=True)(row, *args)
        np.testing.assert_allclose(logits[p].detach().numpy(), np.asarray(jout), **LOGIT_TOL)
        np.testing.assert_allclose(ce[p].mean().item(), float(jce), **LOGIT_TOL)
        for k in jg:
            np.testing.assert_allclose(params[k].grad[p].numpy(), np.asarray(jg[k]),
                                       err_msg=k, **GRAD_TOL)


def test_argmax_and_accuracy_follow_reference_ties():
    logits = np.asarray([[[1.0, 1.0, 0.0], [0.0, 2.0, 2.0], [3.0, 1.0, 3.0], [0.0, 0.0, 0.5]]],
                        np.float32)
    labels = np.asarray([[0, 1, 2, 2]])
    pred = qat.argmax(torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(pred, np.argmax(logits, -1))
    acc = qat.accuracy(torch.from_numpy(logits), torch.from_numpy(labels))
    assert acc.item() == float(jqat.accuracy(jnp.asarray(logits[0]), jnp.asarray(labels[0])))


def test_init_mlp_bounds_and_generator_determinism():
    cfg = qat.MLPConfig((21, 5, 3))
    a = qat.init_mlp(torch.Generator().manual_seed(4), cfg)
    b = qat.init_mlp(torch.Generator().manual_seed(4), cfg)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert a["w0"].shape == (1, 21, 5) and a["w1"].shape == (1, 5, 3)
    assert a["w0"].abs().max() <= 1 / 21 ** 0.5 and a["w1"].abs().max() <= 1 / 5 ** 0.5
    assert (a["b0"] == 0).all() and (a["b1"] == 0).all()
