"""The fused pruned-ADC QAT layer of the port against the reference's Pallas kernels.

On the CPU the port's wrappers run the kernels' plain PyTorch version; the
reference's Pallas kernels run in interpret mode, as the reference's own
tests run them.  Inputs come from a seed with numpy; P = 3 rows with
distinct masks, C = 7, F = 3 and B = 200 (a ragged edge for the reference's
64-sample tiles).

Tolerance: rtol = atol = 1e-6, the reference's own fused-vs-unfused bound
(``tests/test_kernels_fused_qat.py``).  The comparator/encoder levels are
exact; only the fp32 matmul and batch sums may round differently (an FMA,
or another summation order).
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.fused_qat import fused_qat as jfq  # noqa: E402
from repro.kernels.fused_qat import ref as jref  # noqa: E402
from repro.kernels.pruned_quant import ref as jpq  # noqa: E402
from repro_torch.core.sums import fixed_sum  # noqa: E402
from repro_torch.kernels.fused_qat import ops, ref  # noqa: E402
from repro_torch.kernels.pruned_quant.ref import make_tables  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)
P, B, C, F, N_BITS = 3, 200, 7, 3, 4
SCALE = 1.0 / (1 << N_BITS)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.1, 1.1, (P, B, C)).astype(np.float32)
    x[:, :16, 0] = np.arange(16) / 16  # exact thresholds must fire
    masks = rng.uniform(size=(P, C, 16)) < 0.5
    masks[0] = True  # full bank
    masks[1, 2, 1:] = False  # one all-pruned channel
    w = rng.normal(size=(P, C, F)).astype(np.float32)
    b = rng.normal(size=(P, F)).astype(np.float32)
    g = rng.normal(size=(P, B, F)).astype(np.float32)
    return x, masks, w, b, g


def _tables(masks):
    return make_tables(torch.from_numpy(masks), N_BITS)


def test_forward_matches_pallas_kernel_row_by_row():
    x, masks, w, b, _ = _inputs()
    thr, ids = _tables(masks)
    out = ops.fused_forward(torch.from_numpy(x), thr, ids, torch.from_numpy(w),
                            torch.from_numpy(b), SCALE).numpy()
    for p in range(P):
        jthr, jids = jpq.make_tables(jnp.asarray(masks[p]), N_BITS)
        want = jfq.fused_qat_forward_pallas(
            jnp.asarray(x[p]), jthr, jids, jnp.asarray(w[p]), jnp.asarray(b[p]),
            scale=SCALE, block_b=64, interpret=True,
        )
        np.testing.assert_allclose(out[p], np.asarray(want), **TOL)


def test_backward_matches_pallas_kernel_row_by_row():
    x, masks, w, _, g = _inputs(1)
    thr, ids = _tables(masks)
    dx, dw = ops.fused_backward(torch.from_numpy(x), thr, ids, torch.from_numpy(w),
                                torch.from_numpy(g), SCALE)
    for p in range(P):
        jthr, jids = jpq.make_tables(jnp.asarray(masks[p]), N_BITS)
        jdx, jdw = jfq.fused_qat_backward_pallas(
            jnp.asarray(x[p]), jthr, jids, jnp.asarray(w[p]), jnp.asarray(g[p]),
            scale=SCALE, block_b=64, interpret=True,
        )
        np.testing.assert_allclose(dx[p].numpy(), np.asarray(jdx), **TOL)
        np.testing.assert_allclose(dw[p].numpy(), np.asarray(jdw), **TOL)


def test_autograd_matches_jax_grad_of_reference():
    """dx, dw, db of a non-linear loss through the layer vs jax.grad of fused_qat_ref."""
    x, masks, w, b, _ = _inputs(2)
    xt, wt, bt = (torch.from_numpy(a).requires_grad_(True) for a in (x, w, b))
    out = ops.fused_qat_first_layer(xt, torch.from_numpy(masks), wt, bt, N_BITS)
    torch.sin(out).sum().backward()
    for p in range(P):
        m = jnp.asarray(masks[p])
        xp, wp, bp = jnp.asarray(x[p]), jnp.asarray(w[p]), jnp.asarray(b[p])
        jout = jref.fused_qat_ref(xp, m, wp, bp, N_BITS)
        np.testing.assert_allclose(out[p].detach().numpy(), np.asarray(jout), **TOL)
        grads = jax.grad(
            lambda xx, ww, bb: jnp.sum(jnp.sin(jref.fused_qat_ref(xx, m, ww, bb, N_BITS))),
            argnums=(0, 1, 2),
        )(xp, wp, bp)
        for got, want, name in zip((xt.grad, wt.grad, bt.grad), grads, ("dx", "dw", "db")):
            np.testing.assert_allclose(got[p].numpy(), np.asarray(want), err_msg=name, **TOL)


def test_function_on_cpu_equals_plain_autograd():
    """The autograd Function (K2/K3 plain path) vs autograd through fused_qat_ref."""
    x, masks, w, b, _ = _inputs(3)
    mt = torch.from_numpy(masks)
    grads = []
    for fn in (ops.fused_qat_first_layer, ref.fused_qat_ref):
        xt, wt, bt = (torch.from_numpy(a).requires_grad_(True) for a in (x, w, b))
        out = fn(xt, mt, wt, bt, N_BITS)
        torch.cos(out).sum().backward()
        grads.append((out.detach(), xt.grad, wt.grad, bt.grad))
    # the value and dx/dw are the same ops; db is fixed_sum vs torch.sum
    torch.testing.assert_close(grads[0][0], grads[1][0], rtol=0, atol=0)
    for a, c in zip(grads[0][1:], grads[1][1:]):
        torch.testing.assert_close(a, c, **TOL)


def test_wrappers_validate_inputs_and_count_only_launches():
    x, masks, w, b, g = _inputs()
    thr, ids = _tables(masks)
    xt, wt, bt = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)
    ops.reset_launch_counts()
    ops.fused_forward(xt, thr, ids, wt, bt, SCALE)
    ops.fused_backward(xt, thr, ids, wt, torch.from_numpy(g), SCALE)
    # the CPU launches none of K2, K3 or the training step's kernels
    assert ops.LAUNCHES == {"fused_qat_forward": 0, "fused_qat_backward": 0,
                            "qat_step_prep": 0, "qat_step_head": 0, "qat_step_update": 0}
    with pytest.raises(TypeError):
        ops.fused_forward(xt.double(), thr, ids, wt, bt, SCALE)
    with pytest.raises(TypeError):
        ops.fused_forward(xt, thr, ids.long(), wt, bt, SCALE)
    with pytest.raises(ValueError):
        ops.fused_forward(xt, thr[:, :3], ids, wt, bt, SCALE)
    with pytest.raises(ValueError):
        ops.fused_backward(xt, thr, ids, wt, torch.from_numpy(g)[:, :5], SCALE)
    # a tensor neither on the CPU nor on CUDA has no path: no fallback
    with pytest.raises(ValueError):
        ops.fused_forward(xt.to("meta"), thr.to("meta"), ids.to("meta"), wt.to("meta"),
                          bt.to("meta"), SCALE)


def test_fixed_sum_is_row_local():
    """A row's fixed-order sum is the same bits alone or among other rows."""
    rng = np.random.default_rng(9)
    many = torch.from_numpy(rng.normal(size=(5, 131, 3)).astype(np.float32))
    alone = fixed_sum(many[2:3], 1)
    torch.testing.assert_close(fixed_sum(many, 1)[2:3], alone, rtol=0, atol=0)
    torch.testing.assert_close(alone, many[2:3].sum(1), rtol=1e-6, atol=1e-6)
