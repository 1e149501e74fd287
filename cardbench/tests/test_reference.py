"""The plain references against the port at tiny sizes, on the CPU.

A test may import both sides; the reference modules import neither the port
nor the JAX package (``test_isolation.py``)."""

import numpy as np
import pytest
import torch

from cardbench.reference import internlm2, precision
from cardbench.reference import printed_mlp as ref


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(ref.DATASETS))
def test_data_and_split_match_the_port(name):
    from repro_torch.data import uci_synth

    X, y = ref.load(name)
    Xp, yp, _ = uci_synth.load(name)
    assert np.array_equal(X, Xp) and np.array_equal(y, yp)
    for a, b in zip(ref.stratified_split(X, y, 0.7, 1234),
                    uci_synth.stratified_split(Xp, yp, 0.7, 1234)):
        assert np.array_equal(a, b)


def test_draws_match_the_trainer():
    from repro_torch.core import qat, trainer

    cfg = trainer.EvalConfig(max_steps=7, seed=99)
    params, idx = trainer.draw_rows(np.array([5, 123456]), cfg, qat.MLPConfig((21, 5, 3)), 50)
    for r, s in enumerate((5, 123456)):
        p, i = ref.draw_row(99, s, (21, 5, 3), 50, 7, 128)
        assert torch.equal(i, idx[r])
        for k in p:
            assert torch.equal(p[k], params[k][r])


def _rows(n, axes, seed=0):
    from repro_torch.core import chromosome

    rng = np.random.default_rng(seed)
    cards = chromosome.cat_cardinalities(axes, 2)
    masks = rng.uniform(size=(n, 21 * 16)) < 0.6
    cats = np.stack([rng.integers(0, k, n) for k in cards], 1)
    return masks, cats, chromosome.decode_batch(masks, cats, 21, 4, axes=axes, n_layers=2)


@pytest.mark.parametrize("axes", [("adc",), ("adc", "act", "wprec")])
def test_decode_and_cost_match_the_port(axes):
    from repro_torch.core import area

    masks, cats, dec = _rows(16, axes)
    mine = ref.decode_cats(cats, axes, 2)
    for k, v in mine.items():
        assert np.array_equal(np.asarray(v, np.float64), np.asarray(dec[k], np.float64)), k
    if axes == ("adc",):
        want = area.adc_cost_batch(dec["masks"], 4)
        got = [ref.bank_cost(m, 4) for m in dec["masks"]]
    else:
        want = area.genome_area_batch(dec["masks"], 4, [21, 5, 3], dec["weight_bits"],
                                      dec["act_bits"], act_sel=dec["act_sel"],
                                      wprec=dec["wprec"])
        got = [ref.system_cost(dec["masks"][j], 4, [21, 5, 3], dec["weight_bits"][j],
                               dec["act_bits"][j], dec["act_sel"][j], dec["wprec"][j])
               for j in range(16)]
    assert np.allclose(np.asarray(got).T, np.asarray(want), rtol=1e-12, atol=0)


@pytest.mark.parametrize("axes", [("adc",), ("adc", "act", "wprec")])
def test_qat_training_matches_the_row_program(axes):
    """Accuracies after 40 steps: the fp32 reference and the port's row
    program from the same draws agree on every row but a few, by a test
    sample or two (the quantizers make rounding chaotic)."""
    from repro_torch.core import qat, trainer

    X, y = ref.load("cardio")
    X_tr, y_tr, X_te, y_te = ref.stratified_split(X, y, 0.7, 3)
    n = 12
    masks, cats, dec = _rows(n, axes, seed=1)
    cfg = trainer.EvalConfig(max_steps=40, seed=3, genome_axes=axes)
    mlp = qat.MLPConfig((21, 5, 3))
    seeds = np.arange(n, dtype=np.int32) + 70
    params0, idx = trainer.draw_rows(seeds, cfg, mlp, X_tr.shape[0])
    extra = [dec[k] for k in ("act_sel", "wprec") if k in dec]
    prog = trainer.make_row_program(X_tr, y_tr, X_te, y_te, mlp, cfg, device="cpu")
    acc_prog, _ = prog(dec["masks"], dec["weight_bits"], dec["act_bits"], dec["batch_size"],
                       dec["epochs"], dec["lr"], params0, idx, *extra)
    rows = {k: torch.as_tensor(np.asarray(v)) for k, v in dec.items()}
    rows["masks"] = rows["masks"].to(torch.bool)
    rows["data"] = torch.zeros(n, dtype=torch.int64)
    t = lambda a, dt: torch.as_tensor(a, dtype=dt)[None]  # noqa: E731
    acc_ref = ref.train_rows(t(X_tr, torch.float32), t(y_tr, torch.int64),
                             t(X_te, torch.float32), t(y_te, torch.int64), rows, params0, idx,
                             4, 40, 1.0)
    gap = (acc_prog.numpy() - acc_ref.numpy()) * X_te.shape[0]
    assert np.sum(np.abs(gap) > 0.5) <= 2 and np.abs(gap).max() <= 8


def test_internlm2_matches_the_port_forward():
    import dataclasses

    from repro_torch.configs import registry
    from repro_torch.models import transformer

    # rope_theta as the configuration file states it, not the program's default
    cfg = dataclasses.replace(registry.reduced(registry.get("internvl2-26b")), n_layers=2,
                              rope_theta=1e6)
    gen = torch.Generator().manual_seed(0)
    params = transformer.init_params(gen, cfg)
    sizes = dict(n_layers=2, d_model=cfg.d_model, n_heads=cfg.n_heads,
                 n_kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff, padded_vocab=cfg.padded_vocab,
                 rope_theta=cfg.rope_theta, rms_norm_eps=1e-6,
                 adc_bits=cfg.frontend_adc_bits)
    assert {k: tuple(v.shape) for k, v in params.items()} == internlm2.weight_shapes(sizes)
    tokens = torch.randint(0, cfg.vocab_size, (1, 11), generator=gen)
    patches = torch.rand((1, cfg.frontend_len, cfg.d_model), generator=gen)
    with torch.no_grad():
        want = transformer.forward(params, tokens, cfg, patches)[0]
    P = cfg.frontend_len
    got = internlm2.logits_at(params, sizes, [(tokens[0], patches[0])],
                              [list(range(P + 11))])[0]
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4)
    # the text-only path, as decode's check runs it
    with torch.no_grad():
        want = transformer.forward(params, tokens, cfg)[0]
    got = internlm2.logits_at(params, sizes, [(tokens[0], None)], [list(range(11))])[0]
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4)


def test_frontend_levels():
    x = torch.tensor([[0.0, 0.0624, 0.0625, 0.5, 0.9999, 0.9375]])
    assert internlm2.frontend(x).tolist() == [[0.0, 0.0, 0.0625, 0.5, 0.9375, 0.9375]]


def test_lower_precisions():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, 1.0 + 2 ** -10, 3.0])
    # ties to even at TF32's 10th mantissa bit
    assert precision.tf32(x).tolist() == [1.0, 1.0, 1.0 + 2 ** -9, 1.0 + 2 ** -10, 3.0]
    w = torch.randn(8, 16, generator=torch.Generator().manual_seed(1))
    q = precision.fp8(w, -1)
    assert (q - w).abs().max() <= w.abs().amax() / 16  # e4m3 keeps 3 mantissa bits
    assert not torch.equal(q, w)
    a, b = torch.randn(4, 8), torch.randn(8, 3)
    assert torch.equal(precision.matmul(a, b), a @ b)


def test_tf32_matmul_rounds_forward_and_backward():
    gen = torch.Generator().manual_seed(2)
    a = torch.randn(3, 5, 4, generator=gen, requires_grad=True)
    b = torch.randn(3, 4, 2, generator=gen, requires_grad=True)
    out = precision.matmul(a, b, "tf32")
    assert torch.equal(out, precision.tf32(a.detach()) @ precision.tf32(b.detach()))
    g = torch.randn(3, 5, 2, generator=gen)
    ga, gb = torch.autograd.grad(out, (a, b), g)
    tg = precision.tf32(g)
    assert torch.equal(ga, tg @ precision.tf32(b.detach()).transpose(1, 2))
    assert torch.equal(gb, precision.tf32(a.detach()).transpose(1, 2) @ tg)
    assert not torch.equal(ga, g @ b.detach().transpose(1, 2))
