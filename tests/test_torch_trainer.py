"""The port's population QAT row program against the JAX reference.

The reference draws its initial weights and minibatch indices with JAX's
threefry; the port draws with ``torch.Generator``.  So these tests carry
the reference's draws across (``qat.init_mlp(fold_in(PRNGKey(seed0), s))``
and ``randint(fold_in(key, t), ...)``, as ``trainer.py:125-126,145-146``)
and run both step loops from the same state.  The reference oracle is
``jax.vmap`` of its row program, unsharded: its population evaluator
fails on JAX 0.9.0 (the ``jax.make_mesh`` axis-type fault), which is the
reference's, not the port's.

Run this file as a script to measure the port-vs-reference accuracy gap at
the full 600 steps (``python tests/test_torch_trainer.py``).
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import qat as jqat  # noqa: E402
from repro.core import trainer as jtrainer  # noqa: E402
from repro.data import uci_synth  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import qat, trainer  # noqa: E402

# Final parameters after 40 steps from the same state: the two step loops
# differ only in fp32 summation order and a differently rounded softmax
# gradient (<= 1.5e-8 a step, measured in test_torch_qat); over 40 momentum
# steps the measured max gap was 9.7e-8 absolute on parameters up to 1.04
# (seeds, the rows below).  Bound: 1e-6 absolute.
PARAM_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are tiny, and the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(name):
    X, y, spec = uci_synth.load(name)
    X_tr, y_tr, X_te, y_te = uci_synth.stratified_split(X, y, 0.7, 0)
    return X_tr, y_tr, X_te, y_te, (spec.n_features, spec.hidden, spec.n_classes)


def _jax_rows(X_tr, y_tr, X_te, y_te, layer_sizes, ecfg, rows):
    """The reference's draws, final params and accuracies for ``rows``.

    The step loop is the reference's (``trainer.py:125-163``, ADC-only
    genome) with its final params kept; its accuracies are checked equal
    to ``trainer._make_train_one``'s own, so the copy is the reference.
    """
    mcfg = jqat.MLPConfig(layer_sizes)
    n_train = X_tr.shape[0]
    Xtr, ytr = jnp.asarray(X_tr), jnp.asarray(y_tr, jnp.int32)
    Xte, yte = jnp.asarray(X_te), jnp.asarray(y_te, jnp.int32)

    def one(mask, wb, ab, bs, ep, lr, seed):
        key = jax.random.fold_in(jax.random.PRNGKey(ecfg.seed), seed)
        params0 = jqat.init_mlp(key, mcfg)
        steps = jnp.arange(ecfg.max_steps)
        idx = jax.vmap(
            lambda t: jax.random.randint(jax.random.fold_in(key, t), (ecfg.max_batch,), 0, n_train)
        )(steps)
        budget = jnp.minimum(
            jnp.maximum(ep.astype(jnp.float32) * jnp.ceil(n_train / bs.astype(jnp.float32))
                        * ecfg.step_scale, 1.0),
            float(ecfg.max_steps),
        )
        w = (jnp.arange(ecfg.max_batch) < bs).astype(jnp.float32)

        def loss_fn(p, xb, yb):
            logits = jqat.mlp_forward(p, xb, mcfg, mask, wb, ab)
            logp = jax.nn.log_softmax(logits, axis=-1)
            ce = -jnp.take_along_axis(logp, yb[:, None], axis=-1)[:, 0]
            return jnp.sum(w * ce) / jnp.maximum(jnp.sum(w), 1.0)

        def step(carry, t):
            p, v = carry
            i = idx[t]
            grads = jax.grad(loss_fn)(p, Xtr[i], ytr[i])
            frac = jnp.minimum(t.astype(jnp.float32) / budget, 1.0)
            lr_t = lr * 0.5 * (1.0 + jnp.cos(jnp.pi * frac))
            active = (t.astype(jnp.float32) < budget).astype(jnp.float32)
            v = jax.tree.map(lambda vi, g: ecfg.momentum * vi - lr_t * g, v, grads)
            p = jax.tree.map(lambda pi, vi: pi + active * vi, p, v)
            return (p, v), None

        zeros = jax.tree.map(jnp.zeros_like, params0)
        (params, _), _ = jax.lax.scan(step, (params0, zeros), steps)
        acc = jqat.accuracy(jqat.mlp_forward(params, Xte, mcfg, mask, wb, ab), yte)
        return params0, idx, params, acc

    args = [jnp.asarray(a) for a in rows]
    params0, idx, params, acc = jax.jit(jax.vmap(one))(*args)
    ref_acc = jax.jit(jax.vmap(
        jtrainer._make_train_one(X_tr, y_tr, X_te, y_te, mcfg, ecfg)
    ))(*args)
    np.testing.assert_array_equal(np.asarray(acc), np.asarray(ref_acc))
    as_np = lambda d: {k: np.asarray(v) for k, v in d.items()}  # noqa: E731
    return as_np(params0), np.asarray(idx), as_np(params), np.asarray(acc)


def _rows(n_features, P, seed, ep=None):
    """P chromosome rows (masks, wb, ab, bs, ep, lr, seeds) from a numpy seed."""
    rng = np.random.default_rng(seed)
    masks = rng.uniform(size=(P, n_features, 16)) < rng.uniform(0.2, 1.0, (P, 1, 1))
    masks[:, :, 0] = True
    return (
        masks,
        rng.choice([8.0, 6.0, 4.0], P).astype(np.float32),
        rng.choice([4.0, 3.0, 5.0], P).astype(np.float32),
        rng.choice([16, 64, 128], P).astype(np.int32),
        (rng.choice([60, 120], P) if ep is None else np.full(P, ep)).astype(np.int32),
        rng.choice([0.05, 0.1, 0.02], P).astype(np.float32),
        rng.integers(0, 2**31 - 1, P).astype(np.int32),
    )


def _port(data, ecfg, rows, params0, idx):
    X_tr, y_tr, X_te, y_te, layer_sizes = data
    run = trainer.make_row_program(
        X_tr, y_tr, X_te, y_te, qat.MLPConfig(layer_sizes),
        trainer.EvalConfig(max_steps=ecfg.max_steps, step_scale=ecfg.step_scale,
                           seed=ecfg.seed), device="cpu",
    )
    acc, params = run(*rows[:6], params_from_jax(params0, "cpu"), torch.from_numpy(idx.copy()))
    return acc.numpy(), {k: v.numpy() for k, v in params.items()}


def test_row_program_matches_reference_from_carried_state():
    data = _data("seeds")
    ecfg = jtrainer.EvalConfig(max_steps=40)
    rows = _rows(data[4][0], 3, seed=1)
    params0, idx, jparams, jacc = _jax_rows(*data, ecfg, rows)
    acc, params = _port(data, ecfg, rows, params0, idx)
    for k in jparams:
        np.testing.assert_allclose(params[k], jparams[k], rtol=0, atol=PARAM_ATOL, err_msg=k)
    np.testing.assert_array_equal(acc, jacc)


def test_budget_end_freezes_params():
    """A row whose budget ends before max_steps keeps the params of its last step."""
    data = _data("seeds")
    # ep=1, bs=64 on 147 training samples: budget = ceil(147/64) = 3 steps
    rows = _rows(data[4][0], 2, seed=2, ep=1)
    rows[3][:] = 64
    X_tr = data[0]
    ecfg = trainer.EvalConfig(max_steps=12)
    params0, idx = trainer.draw_rows(rows[6], ecfg, qat.MLPConfig(data[4]), X_tr.shape[0])
    outs = []
    for steps in (3, 12):
        run = trainer.make_row_program(*data[:4], qat.MLPConfig(data[4]),
                                       trainer.EvalConfig(max_steps=steps), device="cpu")
        outs.append(run(*rows[:6], params0, idx[:, :steps]))
    for k in outs[0][1]:
        torch.testing.assert_close(outs[1][1][k], outs[0][1][k], rtol=0, atol=0)
        assert not torch.equal(outs[0][1][k], params0[k]) or k.startswith("b")
    torch.testing.assert_close(outs[1][0], outs[0][0], rtol=0, atol=0)


def test_row_result_is_independent_of_its_batch():
    """A row alone and inside a batch of 5 (at every position) gives the same bits."""
    data = _data("seeds")
    ecfg = trainer.EvalConfig(max_steps=30)
    ev = trainer.make_population_evaluator(*data[:4], qat.MLPConfig(data[4]), ecfg, device="cpu")
    rows = _rows(data[4][0], 5, seed=3)
    together = ev(*rows)
    for p in range(5):
        alone = ev(*(a[p:p + 1] for a in rows))
        assert alone[0] == together[p], (p, alone, together)
    np.testing.assert_array_equal(ev(*rows), together)  # and run to run


def test_draw_rows_depends_on_seed_only():
    cfg, mcfg = trainer.EvalConfig(max_steps=5), qat.MLPConfig((7, 3, 3))
    p_all, i_all = trainer.draw_rows(np.asarray([5, 9, 11]), cfg, mcfg, 147)
    p_one, i_one = trainer.draw_rows(np.asarray([9]), cfg, mcfg, 147)
    assert i_all.shape == (3, 5, 128) and i_all.dtype == torch.int64
    assert 0 <= int(i_all.min()) and int(i_all.max()) < 147
    torch.testing.assert_close(i_all[1:2], i_one, rtol=0, atol=0)
    for k in p_one:
        torch.testing.assert_close(p_all[k][1:2], p_one[k], rtol=0, atol=0)
    assert not torch.equal(i_all[0], i_all[2])


def test_entry_points_default_to_cuda():
    """device=None means CUDA; without a card the entry point raises, never falls back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    data = _data("seeds")
    with pytest.raises(RuntimeError, match="CUDA"):
        trainer.make_population_evaluator(*data[:4], qat.MLPConfig(data[4]))


def measure_accuracy_gap(steps=600, n_rows=8, datasets=("seeds", "cardio"), seed=100) -> dict:
    """Per-row |acc_port - acc_reference| from carried state.

    The port runs its plain PyTorch path on the CPU; the reference runs its
    row program on the CPU (XLA).  Prints and returns the gaps.
    """
    out = {}
    for i, name in enumerate(datasets):
        data = _data(name)
        ecfg = jtrainer.EvalConfig(max_steps=steps)
        rows = _rows(data[4][0], n_rows, seed=seed + i)
        params0, idx, _, jacc = _jax_rows(*data, ecfg, rows)
        acc, _ = _port(data, ecfg, rows, params0, idx)
        gap = np.abs(acc - jacc)
        out[name] = {"n_test": int(data[3].shape[0]), "gap": gap.tolist(),
                     "port": acc.tolist(), "reference": jacc.tolist()}
        print(name, out[name], flush=True)
    return out


if __name__ == "__main__":
    # python tests/test_torch_trainer.py [--seed S] [n_rows [dataset ...]]
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=100)
    ap.add_argument("n_rows", type=int, nargs="?", default=8)
    ap.add_argument("datasets", nargs="*", default=["seeds", "cardio"])
    a = ap.parse_args()
    torch.set_num_threads(1)
    measure_accuracy_gap(n_rows=a.n_rows, datasets=tuple(a.datasets), seed=a.seed)
