"""The Hopper designs of K1 and K3, reached on the CPU through their plans and emulation.

K1 (``kernels/pruned_quant/csrc/pruned_quant.cu``) runs on a grid that
``pruned_quant.ops.launch_plan`` plans from shapes alone; the tests check
that every plan covers each (row, channel) exactly once, ragged shapes
included, as the kernel walks it.  Its levels are integers, equal to the
plain version bit for bit (``tests/test_torch_frontend.py``).

K3 (``kernels/fused_qat/csrc/fused_qat.cu``) sums dw over samples in a
fixed tree; ``fused_qat.ref.fused_backward_emulation`` repeats that order in
plain PyTorch.  The tests hold the emulation against a scalar walk of the
kernel's threads, warps and shuffles (bit for bit), against the JAX
package's Pallas ``_bwd_kernel`` in interpret mode (``block_b=64``, as
``tests/test_torch_fused_qat.py`` runs it), and check that a row's bits do
not depend on its batch or on the run.  Inputs come from a seed with numpy.

Tolerances against Pallas: dx within rtol = atol = 1e-6 (a 5-term fp32 sum,
the reference's own fused-vs-unfused bound); dw within B * 2^-23 *
sum_b |h||g| elementwise, the classic bound of a B-term fp32 sum in any
order (the Pallas kernel sums tile by tile, the Hopper kernel in a tree).
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.fused_qat import fused_qat as jfq  # noqa: E402
from repro.kernels.pruned_quant import ref as jpq  # noqa: E402
from repro_torch.kernels.fused_qat import ops, ref  # noqa: E402
from repro_torch.kernels.pruned_quant import ops as pq  # noqa: E402
from repro_torch.kernels.pruned_quant.ref import make_tables  # noqa: E402

C, F, N_BITS = 21, 5, 4
SCALE = 1.0 / (1 << N_BITS)
DX_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are tiny, and the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(P, B, seed):
    """x with every threshold and out-of-range inputs planted, banks with the edge masks."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.1, 1.1, (P, B, C)).astype(np.float32)
    k = min(B, 16)
    x[:, :k, 0] = np.arange(16)[:k] / 16    # exact thresholds must fire
    x[:, -1, :] = 7.0                        # far above vref
    masks = rng.uniform(size=(P, C, 16)) < rng.uniform(0.1, 1.0, (P, 1, 1))
    masks[0] = True                          # a full bank
    if P > 1:
        masks[1, 3, 1:] = False              # one all-pruned channel
    w = rng.normal(0, 0.3, (P, C, F)).astype(np.float32)
    g = rng.normal(size=(P, B, F)).astype(np.float32)
    return x, masks, w, g


def _torch(x, masks, w, g):
    thr, ids = make_tables(torch.from_numpy(masks), N_BITS)
    return torch.from_numpy(x), thr, ids, torch.from_numpy(w), torch.from_numpy(g)


# ---------------------------------------------------------------------------
# K3: the fixed order of dw's sums
# ---------------------------------------------------------------------------

def _kernel_walk(h, g):
    """dw (C, F) of one row as the K3 kernel adds it, scalar step by scalar step in fp32:
    per thread its samples in index order, then each warp's shuffle tree, then
    (w0 + w2) + (w1 + w3)."""
    h, g = h.astype(np.float32), g.astype(np.float32)
    B = h.shape[0]
    nt = ref.BWD_THREADS
    acc = np.zeros((nt, C, F), np.float32)
    for t in range(nt):
        for b in range(t, B, nt):
            acc[t] = acc[t] + h[b][:, None] * g[b][None, :]
    warps = []
    for wi in range(nt // 32):
        v = acc[32 * wi: 32 * wi + 32].copy()
        for off in (16, 8, 4, 2, 1):
            # __shfl_down_sync: lane i reads lane i + off, or itself past lane 31
            src = np.array([i + off if i + off < 32 else i for i in range(32)])
            v = v + v[src]
        warps.append(v[0])
    return (warps[0] + warps[2]) + (warps[1] + warps[3])


@pytest.mark.parametrize("B", [1, 7, 200, 1025])
def test_k3_emulation_sums_as_the_kernel_walks(B):
    x, masks, w, g = _inputs(2, B, seed=B)
    xt, thr, ids, wt, gt = _torch(x, masks, w, g)
    _, dw = ref.fused_backward_emulation(xt, thr, ids, wt, gt, SCALE)
    h = ref.dequant_ste_tables(xt, thr, ids, SCALE).numpy()
    for p in range(2):
        want = _kernel_walk(h[p], g[p])
        assert np.array_equal(dw[p].numpy().view(np.int32), want.view(np.int32)), p


@pytest.mark.parametrize("B", [200, 638])
def test_k3_emulation_matches_pallas(B):
    P = 3
    x, masks, w, g = _inputs(P, B, seed=10 + B)
    xt, thr, ids, wt, gt = _torch(x, masks, w, g)
    dx, dw = ref.fused_backward_emulation(xt, thr, ids, wt, gt, SCALE)
    h = ref.dequant_ste_tables(xt, thr, ids, SCALE)
    bound = (B * 2.0 ** -23 * torch.matmul(h.abs().transpose(1, 2), gt.abs())).numpy()
    for p in range(P):
        jthr, jids = jpq.make_tables(jnp.asarray(masks[p]), N_BITS)
        jdx, jdw = jfq.fused_qat_backward_pallas(
            jnp.asarray(x[p]), jthr, jids, jnp.asarray(w[p]), jnp.asarray(g[p]),
            scale=SCALE, block_b=64, interpret=True,
        )
        np.testing.assert_allclose(dx[p].numpy(), np.asarray(jdx), **DX_TOL)
        err = np.abs(dw[p].numpy() - np.asarray(jdw))
        assert (err <= bound[p]).all(), float((err / np.maximum(bound[p], 1e-30)).max())


@pytest.mark.parametrize("B", [128, 638])
def test_k3_emulation_row_independent_of_batch_and_run(B):
    P = 24
    xt, thr, ids, wt, gt = _torch(*_inputs(P, B, seed=3 * B))
    _, dw = ref.fused_backward_emulation(xt, thr, ids, wt, gt, SCALE)
    _, again = ref.fused_backward_emulation(xt, thr, ids, wt, gt, SCALE)
    assert torch.equal(dw, again)
    for p in (0, 11, P - 1):
        sl = slice(p, p + 1)
        _, alone = ref.fused_backward_emulation(xt[sl], thr[sl], ids[sl], wt[sl], gt[sl], SCALE)
        assert torch.equal(alone[0], dw[p]), p


def test_k3_emulation_agrees_with_plain_version():
    """The emulation's dw is the plain product's up to the summation bound; dx is the same."""
    B = 638
    xt, thr, ids, wt, gt = _torch(*_inputs(4, B, seed=5))
    dx, dw = ref.fused_backward_emulation(xt, thr, ids, wt, gt, SCALE)
    pdx, pdw = ops.fused_backward(xt, thr, ids, wt, gt, SCALE)
    assert torch.equal(dx, pdx)
    h = ref.dequant_ste_tables(xt, thr, ids, SCALE)
    bound = B * 2.0 ** -23 * torch.matmul(h.abs().transpose(1, 2), gt.abs())
    assert bool(((dw - pdw).abs() <= bound).all())


def test_k3_wrapper_without_dx_returns_only_dw():
    xt, thr, ids, wt, gt = _torch(*_inputs(2, 130, seed=8))
    ops.reset_launch_counts()
    dx, dw = ops.fused_backward(xt, thr, ids, wt, gt, SCALE, need_dx=False)
    assert dx is None and dw.shape == (2, C, F)
    assert torch.equal(dw, ops.fused_backward(xt, thr, ids, wt, gt, SCALE)[1])
    assert ops.LAUNCHES["fused_qat_backward"] == 0  # CPU tensors launch nothing


# ---------------------------------------------------------------------------
# K1: the grid plan
# ---------------------------------------------------------------------------

def _coverage(plan, B, Cc):
    """How often the kernel's threads write each row and each channel, walking
    the grid as pruned_quant.cu does (an unrolled run of ROWS_IN_FLIGHT rows,
    then a one-row tail)."""
    ch = np.zeros(Cc, np.int64)
    for bx in range(plan.grid_x):
        for tx in range(pq.THREADS):
            c0 = (bx * pq.THREADS + tx) * plan.width
            if c0 >= Cc:
                continue
            assert c0 + plan.width <= Cc, "a thread's channels run past C"
            ch[c0:c0 + plan.width] += 1
    rows = np.zeros(B, np.int64)
    U = pq.ROWS_IN_FLIGHT
    for by in range(plan.grid_y):
        r0 = by * plan.rows_per_block
        r1 = min(B, r0 + plan.rows_per_block)
        r = r0
        while r + U <= r1:
            rows[r:r + U] += 1
            r += U
        rows[r:r1] += 1
    return rows, ch


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("Cc", [21, 6143, 6144, 1024])
@pytest.mark.parametrize("B", [1, 7, 1025, 6000])
def test_k1_plan_covers_every_row_and_channel_once(B, Cc, aligned):
    plan = pq.launch_plan(B, Cc, aligned=aligned)
    rows, ch = _coverage(plan, B, Cc)
    # the (row, channel) coverage is the product of the two: each must be 1
    assert (rows == 1).all() and (ch == 1).all()
    assert plan.width == (2 if Cc % 2 == 0 and aligned else 1)
    assert plan.rows_per_block % pq.ROWS_IN_FLIGHT == 0
    assert 1 <= plan.grid_y <= 65535
    # no block without rows, none without channels
    assert (plan.grid_y - 1) * plan.rows_per_block < B
    assert (plan.grid_x - 1) * pq.THREADS * plan.width < Cc


@pytest.mark.parametrize("shape,blocks", [((1024, 6144), 528), ((6000, 1024), 500)])
def test_k1_plan_fills_the_card_at_the_served_shapes(shape, blocks):
    """internvl2-26b's patches and whisper-medium's frames: two channels a thread,
    about 4 blocks of 128 threads an SM on 132 SMs, tables read once a block."""
    plan = pq.launch_plan(*shape)
    assert plan.width == 2
    assert plan.grid_x * plan.grid_y == blocks
    assert plan.rows_per_block == 48


def test_k1_plan_follows_the_sm_count():
    assert pq.launch_plan(1024, 6144, sms=66).grid_y < pq.launch_plan(1024, 6144).grid_y
    with pytest.raises(ValueError):
        pq.launch_plan(0, 6144)


@pytest.mark.parametrize("n_bits", [1, 2, 3, 4, 5, 8])
def test_k1_every_bank_width_equals_reference_on_cpu(n_bits):
    """The widths the kernel takes on its register path (N <= 4) and its generic
    loop (N = 5..8) all pass through the wrapper; on the CPU, its plain version."""
    rng = np.random.default_rng(n_bits)
    n = 1 << n_bits
    x = rng.uniform(-0.1, 1.1, (7, 6143)).astype(np.float32)
    x[:min(7, n), 0] = (np.arange(n, dtype=np.float32) / n)[:7]
    mask = rng.uniform(size=(6143, n)) < 0.6
    out = pq.pruned_quantize(torch.from_numpy(x), torch.from_numpy(mask), n_bits)
    jout = jpq.pruned_quantize_ref(jnp.asarray(x), *jpq.make_tables(jnp.asarray(mask), n_bits))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
