"""The port's optimizers (``repro_torch.optim``) against the reference's, on the CPU.

Fixed NumPy trees (a matrix, a stacked 3-D tensor, a vector; fp32, and bf16
parameters) go through three updates of AdamW, Adafactor and SGD in both
packages, the reference jitted.  Tolerances:
* parameters, moments and factored statistics: rtol 1e-6 with atol 1e-6
  times the leaf's largest magnitude (fp32; XLA contracts some
  multiply-adds into FMAs, which moves a result by an ulp); bf16 parameters
  within one bf16 ulp (2^-8) of the reference's, since an ulp of fp32 can
  round the other way; Adafactor's bf16 momentum likewise, and so its
  parameters may move by lr x one bf16 ulp of the momentum an update more
  (measured: 2.1e-5 on one element of 60 after three fp32 updates).
* the schedules, clip and its norm: rtol 1e-6.
* ``compress`` -> ``decompress`` over three steps: the int8 codes, the scales
  and the error-feedback state exactly equal (the port folds the division
  by 127 into the fp32 reciprocal and rounds the residual once, as XLA
  does).
Then the reference's own properties (``tests/test_optim.py``,
``tests/test_optim_properties.py``) on the port: convergence on a
quadratic, the factored state's shapes, an unbiased residual.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.optim import compress as jcompress  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.optim import compress  # noqa: E402

SHAPES = {"w": (6, 10), "stack": (2, 5, 4), "b": (10,)}
BF16_ULP = 2.0 ** -8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are tiny, and the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed: int, scale: float = 1.0) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {k: (rng.normal(size=s) * scale).astype(np.float32) for k, s in SHAPES.items()}


def _j(tree, dtype=jnp.float32):
    return {k: jnp.asarray(v, dtype) for k, v in tree.items()}


def _t(tree, dtype=torch.float32):
    return {k: torch.from_numpy(np.asarray(v, np.float32)).to(dtype) for k, v in tree.items()}


def _f32(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, rel: float = 1e-6, what: str = "", atol: float = 0.0):
    got, want = _f32(got), _f32(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale + atol, err_msg=what)


def _state_close(got, want, rel: float):
    assert type(got).__name__ == type(want).__name__
    assert got._fields == want._fields
    for field in got._fields:
        g, w = getattr(got, field), getattr(want, field)
        if isinstance(w, dict):
            assert set(g) == set(w)
            for k in w:
                tol = BF16_ULP if w[k].dtype == jnp.bfloat16 else rel
                _close(g[k], w[k], tol, f"{field}/{k}")
        else:
            assert int(g) == int(w), field


PEAK_LR = 0.1  # the largest learning rate of OPTIMIZERS

OPTIMIZERS = {
    "adamw": lambda pkg: pkg.adamw(lr=pkg.cosine_warmup(0.1, 2, 10)),
    "adamw_const": lambda pkg: pkg.adamw(lr=0.05, weight_decay=0.1),
    "adafactor": lambda pkg: pkg.adafactor(lr=pkg.cosine_warmup(0.1, 2, 10)),
    "sgd": lambda pkg: pkg.sgd_momentum(lr=0.05),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_three_updates_match_reference(name, dtype):
    jopt, opt = OPTIMIZERS[name](joptim), OPTIMIZERS[name](optim)
    p0 = _tree(0)
    jp, tp = _j(p0, jnp.dtype(dtype)), _t(p0, getattr(torch, dtype))
    js, ts = jopt.init(jp), opt.init(tp)
    _state_close(ts, js, 0.0)
    update = jax.jit(jopt.update)
    for it in range(3):
        g = _tree(10 + it, scale=0.5)
        jp, js = update(_j(g, jnp.dtype(dtype)), js, jp)
        tp, ts = opt.update(_t(g, getattr(torch, dtype)), ts, tp)
        for k in p0:
            assert tp[k].dtype == getattr(torch, dtype)
            # a bf16 momentum one ulp apart moves the parameter by lr x that ulp
            slack = (it + 1) * PEAK_LR * BF16_ULP * float(np.abs(_f32(js.mu[k])).max()) \
                if name == "adafactor" else 0.0
            _close(tp[k], jp[k], BF16_ULP if dtype == "bfloat16" else 1e-6, f"{name} {k} {it}",
                   atol=slack)
        _state_close(ts, js, 1e-6)


@pytest.mark.parametrize("step", [0, 1, 3, 10, 57, 110, 200])
def test_schedules_match_reference(step):
    for make in (lambda pkg: pkg.cosine_warmup(0.3, 10, 110, floor=0.01),
                 lambda pkg: pkg.cosine_warmup(1.0, 0, 50),
                 lambda pkg: pkg.constant(3e-4)):
        want = float(make(joptim)(jnp.asarray(step, jnp.int32)))
        got = make(optim)(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(float(make(optim)(step)), want, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("scale", [0.01, 1.0, 30.0])
def test_clip_matches_reference(scale):
    g = _tree(3, scale)
    jc, jn = joptim.clip_by_global_norm(_j(g), 1.0)
    tc, tn = optim.clip_by_global_norm(_t(g), 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for k in g:
        _close(tc[k], jc[k], 1e-6, k)
    # bf16 leaves come back in bf16
    tc16, _ = optim.clip_by_global_norm(_t(g, torch.bfloat16), 1.0)
    assert all(v.dtype == torch.bfloat16 for v in tc16.values())


def test_compress_decompress_three_steps_exact():
    jstate = jcompress.init_state(_j(_tree(0)))
    tstate = compress.init_state(_t(_tree(0)))
    step = jax.jit(jcompress.compress_gradients)
    for it in range(3):
        g = _tree(20 + it, scale=[0.003, 1.0, 40.0][it])
        jcodes, jscales, jstate = step(_j(g), jstate)
        tcodes, tscales, tstate = compress.compress_gradients(_t(g), tstate)
        jdeq = jcompress.decompress_gradients(jcodes, jscales)
        tdeq = compress.decompress_gradients(tcodes, tscales)
        for k in g:
            assert tcodes[k].dtype == torch.int8
            np.testing.assert_array_equal(tcodes[k].numpy(), np.asarray(jcodes[k]))
            assert float(tscales[k]) == float(jscales[k])
            np.testing.assert_array_equal(tstate.error[k].numpy(), np.asarray(jstate.error[k]))
            np.testing.assert_array_equal(tdeq[k].numpy(), np.asarray(jdeq[k]))


# -- the reference's properties, on the port --------------------------------

def _quadratic_min(opt, steps=400, target=(1.0, -2.0, 0.5), shape=None):
    target = torch.tensor(target, dtype=torch.float32)
    if shape is not None:
        target = target.reshape(shape)
    params = {"w": torch.zeros_like(target)}
    state = opt.init(params)
    for _ in range(steps):
        grads = {"w": 2.0 * (params["w"] - target)}
        params, state = opt.update(grads, state, params)
    return params["w"].numpy(), target.numpy()


def test_adamw_converges():
    w, t = _quadratic_min(optim.adamw(lr=0.05, weight_decay=0.0))
    np.testing.assert_allclose(w, t, atol=1e-2)


def test_sgd_converges():
    w, t = _quadratic_min(optim.sgd_momentum(lr=0.05))
    np.testing.assert_allclose(w, t, atol=1e-2)


def test_adafactor_converges():
    target = tuple(np.linspace(-1, 1, 32).astype(np.float32))
    w, t = _quadratic_min(optim.adafactor(lr=0.1), steps=300, target=target, shape=(4, 8))
    np.testing.assert_allclose(w, t, atol=0.05)


def test_adafactor_state_is_factored():
    p = {"w": torch.zeros(64, 128), "b": torch.zeros(128), "s": torch.zeros(3, 16, 8)}
    s = optim.adafactor().init(p)
    assert s.row["w"].shape == (64,) and s.col["w"].shape == (128,)
    assert s.row["s"].shape == (3, 16) and s.col["s"].shape == (3, 8)
    assert s.row["b"].shape == (128,) and s.col["b"].shape == (1,)
    assert s.mu["w"].dtype == torch.bfloat16 and s.row["w"].dtype == torch.float32
    assert s.row["w"].numel() + s.col["w"].numel() < p["w"].numel() // 10


@pytest.mark.parametrize("lr,g", [(1e-4, -10.0), (0.05, 3.5), (0.5, 0.25)])
def test_sgd_first_step_direction(lr, g):
    opt = optim.sgd_momentum(lr=lr, momentum=0.9)
    p = {"w": torch.zeros(1)}
    p2, _ = opt.update({"w": torch.tensor([g])}, opt.init(p), p)
    np.testing.assert_allclose(float(p2["w"][0]), -lr * g, rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("scale", [0.1, 1.0, 100.0])
def test_clip_never_increases_norm(scale):
    clipped, norm = optim.clip_by_global_norm({"a": torch.tensor([3.0, 4.0]) * scale}, 1.0)
    np.testing.assert_allclose(float(norm), 5.0 * scale, rtol=1e-6)
    assert float(torch.linalg.norm(clipped["a"])) <= 1.0 + 1e-5


def test_grad_compression_error_feedback_is_unbiased_over_time():
    """Sum of dequantized grads + final residual == sum of true grads."""
    rng = np.random.default_rng(0)
    state = compress.init_state({"w": torch.zeros(64)})
    total_true, total_deq = np.zeros(64), np.zeros(64)
    for _ in range(30):
        g = {"w": torch.from_numpy(rng.normal(size=64).astype(np.float32))}
        codes, scales, state = compress.compress_gradients(g, state)
        total_true += g["w"].numpy()
        total_deq += compress.decompress_gradients(codes, scales)["w"].numpy()
    np.testing.assert_allclose(total_deq + state.error["w"].numpy(), total_true, atol=1e-3)


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_compression_residual_bounded_and_int8(seed):
    g = {"w": torch.from_numpy(np.random.default_rng(seed).normal(size=32).astype(np.float32))}
    codes, scales, state = compress.compress_gradients(g, compress.init_state(g))
    assert codes["w"].dtype == torch.int8 and codes["w"].element_size() * 4 == 4
    assert float(state.error["w"].abs().max()) <= float(scales["w"]) / 2 + 1e-6


def test_sgd_training_with_compression_converges():
    target = torch.from_numpy(np.linspace(-1, 1, 16).astype(np.float32))
    params = {"w": torch.zeros(16)}
    opt = optim.sgd_momentum(lr=0.05)
    ostate, cstate = opt.init(params), compress.init_state(params)
    for _ in range(300):
        grads = {"w": 2.0 * (params["w"] - target)}
        codes, scales, cstate = compress.compress_gradients(grads, cstate)
        params, ostate = opt.update(compress.decompress_gradients(codes, scales), ostate, params)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(), atol=5e-2)
