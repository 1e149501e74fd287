"""The port's training loss against the reference's, on the CPU.

``layers.softmax_cross_entropy`` over a padded vocab, then ``loss_fn`` and
every gradient for the six reduced families (dense yi-9b, MoE phi3.5-moe,
VLM internvl2 with patches, ssm rwkv6, hybrid zamba2, audio whisper with
frames): the reference's parameters carried across
(``tests/_torch_lm.py``'s ``carried``), the reference's
``jax.value_and_grad(model.loss_fn)`` jitted outside a mesh.

Tolerances:
* the loss and the gradients: atol = rtol = 1e-4 (``REF``, fp32 summed in
  another order; measured: losses within 1.9e-6, gradients within 1.7e-6
  but for zamba2's embedding, 4.2e-4 on entries up to 19).
* rwkv6's gradients: 5e-4 of each leaf's largest magnitude.  At the first
  position the WKV output is exactly 0 (``u`` is 0 at init and there is no
  state), and the per-head RMS norm (eps 1e-6) scales its gradient by
  1e3, so any reordering shows: the reference's own jitted and op-by-op
  gradients of ``u`` part by 0.0196 (of 445), and a 1e-7 relative
  perturbation of its parameters moves its embedding gradient by 1.4e-4
  of its scale.  Measured port vs reference: 7.3e-5 (``u``), 9.0e-5
  (``embed``) of the scale.
* remat on and off: ``torch.equal`` losses and gradients (the recomputed
  forward is the same arithmetic).

Routing: the loss path never calls K4's wrapper, even on tensors that say
they are on CUDA (a subclass whose ``is_cuda`` is True, so ``attend``
takes its CUDA branch); the same parameters served under ``no_grad`` do
call it.  The guard that makes K4 and K5 refuse autograd on the card is
``kernels.refuse_autograd``, tested here directly.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_lm import REF, carried  # noqa: E402

from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels import refuse_autograd  # noqa: E402
from repro_torch.kernels.decode_attn import ops as decode_ops  # noqa: E402
from repro_torch.kernels.flash_attn import ops as flash_ops  # noqa: E402
from repro_torch.models import build_model, hybrid, transformer, whisper  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402

FAMILIES = {
    "dense": "yi-9b",
    "moe": "phi3.5-moe-42b-a6.6b",
    "vlm": "internvl2-26b",
    "ssm": "rwkv6-1.6b",
    "hybrid": "zamba2-2.7b",
    "audio": "whisper-medium",
}
RWKV_GRAD_REL = 5e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tensors are tiny, and the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, seed: int = 1, B: int = 2, S: int = 16) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.uniform(0, 1, (B, cfg.frontend_len, cfg.d_model)
                                            ).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.uniform(0, 1, (B, 2 * S, cfg.d_model)).astype(np.float32)
    return batch


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _loss_and_grads(model, params, batch):
    leaves = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    loss = model.loss_fn(leaves, _tb(batch))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def test_softmax_cross_entropy_over_padded_vocab():
    rng = np.random.default_rng(0)
    vocab, padded = 503, 512
    logits = (rng.normal(size=(3, 7, padded)) * 4).astype(np.float32)
    logits[..., vocab:] = 50.0  # padding columns that would dominate if not masked
    labels = rng.integers(0, vocab, (3, 7)).astype(np.int32)
    jl, jg = jax.value_and_grad(jlayers.softmax_cross_entropy)(
        jnp.asarray(logits), jnp.asarray(labels), vocab)
    t = torch.from_numpy(logits).requires_grad_()
    loss = L.softmax_cross_entropy(t, torch.from_numpy(labels), vocab)
    (g,) = torch.autograd.grad(loss, [t])
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-9)
    assert torch.count_nonzero(g[..., vocab:]) == 0
    # a bf16 input is summed in fp32
    l16 = L.softmax_cross_entropy(t.detach().to(torch.bfloat16), torch.from_numpy(labels), vocab)
    assert l16.dtype == torch.float32


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loss_and_gradients_match_reference(family):
    jmodel, jparams, model, params = carried(FAMILIES[family], seed=0)
    batch = _batch(model.cfg)
    jl, jg = jax.jit(jax.value_and_grad(jmodel.loss_fn))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = _loss_and_grads(model, params, batch)
    np.testing.assert_allclose(float(loss), float(jl), **REF)
    assert set(grads) == set(jg)
    for k, want in jg.items():
        want = np.asarray(want)
        got = grads[k].numpy()
        assert got.shape == want.shape, k
        if family == "ssm":
            atol = RWKV_GRAD_REL * float(np.abs(want).max())
            np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, err_msg=k, **REF)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_remat_gives_the_same_bits(family):
    _, _, model, params = carried(FAMILIES[family], seed=2)
    assert model.cfg.remat
    batch = _batch(model.cfg, seed=3)
    loss, grads = _loss_and_grads(model, params, batch)
    plain = build_model(dataclasses.replace(model.cfg, remat=False))
    loss2, grads2 = _loss_and_grads(plain, params, batch)
    assert torch.equal(loss, loss2)
    for k in grads:
        assert torch.equal(grads[k], grads2[k]), k


def test_moe_dropped_pairs_get_no_gradient():
    """A capacity of 1 drops most (token, k) pairs; the gradient still
    reaches the router and the experts, and the dropped pairs give none."""
    _, _, model, params = carried(FAMILIES["moe"], seed=0, capacity_factor=0.05)
    h = torch.randn(1, 16, model.cfg.d_model, requires_grad=True)
    lp = {k: v[0].detach().clone().requires_grad_() for k, v in params.items()
          if k in ("router", "we_gate", "we_up", "we_down")}
    out = transformer._moe_block(h, lp, model.cfg)
    topv, topi, pos, keep, C = transformer._moe_route(h.detach(), lp, model.cfg)
    assert C == 1 and 0 < int(keep.sum()) < keep.numel()
    gh, *gw = torch.autograd.grad(out.square().sum(), [h] + list(lp.values()))
    assert all(float(g.abs().sum()) > 0 for g in gw)
    dropped_everywhere = ~keep.any(-1)[0]  # tokens whose every pair was dropped
    assert bool(dropped_everywhere.any())
    assert torch.count_nonzero(gh[0, dropped_everywhere]) == 0


class _CudaLooking(torch.Tensor):
    """A CPU tensor that says it is on CUDA, so ``attend`` takes its CUDA branch."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("family", ["dense", "moe", "vlm", "hybrid", "audio"])
def test_loss_path_never_calls_k4(family, monkeypatch):
    _, _, model, params = carried(FAMILIES[family], seed=0)
    calls = []

    def sentinel(q, k, v, causal=True):
        calls.append(q.shape)
        return flash_ops.ref.flash_attention_ref(q, k, v, causal)

    monkeypatch.setattr(flash_ops, "flash_attention", sentinel)
    looks = {k: v.as_subclass(_CudaLooking) for k, v in params.items()}
    batch = _tb(_batch(model.cfg))
    leaves = {k: v.detach().requires_grad_() for k, v in looks.items()}
    loss = model.loss_fn(leaves, batch)
    torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    assert calls == []
    # the same parameters served: K4's wrapper is called
    with torch.no_grad():
        cfg = model.cfg
        if family == "audio":
            whisper.encode(looks, batch["frames"], cfg)
        elif family == "hybrid":
            hybrid.forward(looks, batch["tokens"], cfg)
        else:
            transformer.forward(looks, batch["tokens"], cfg, batch.get("patch_embeds"))
    assert calls


def test_refuse_autograd_guard():
    q = torch.randn(2, 3, requires_grad=True)
    k = torch.randn(2, 3)
    with pytest.raises(RuntimeError, match="no backward.*plain_attention"):
        refuse_autograd("K4", "layers.plain_attention", q, k)
    refuse_autograd("K4", "plain", k, None)  # nothing requires grad
    with torch.no_grad():
        refuse_autograd("K4", "plain", q, k)
    with torch.inference_mode():
        refuse_autograd("K4", "plain", q, k)


def test_wrappers_on_cpu_stay_differentiable():
    """On the CPU the wrappers take their plain versions, which autograd
    differentiates; the guard is for the CUDA kernels alone."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(1, 8, 4, 16)).astype(np.float32)).requires_grad_()
    kv = torch.from_numpy(rng.normal(size=(2, 1, 8, 2, 16)).astype(np.float32))
    out = flash_ops.flash_attention(q, kv[0], kv[1], causal=True)
    (g,) = torch.autograd.grad(out.sum(), [q])
    (g_plain,) = torch.autograd.grad(L.plain_attention(q, kv[0], kv[1]).sum(), [q])
    torch.testing.assert_close(g, g_plain, atol=1e-5, rtol=1e-5)
    qd = q[:, 0].detach().requires_grad_()
    od = decode_ops.decode_attention(qd, kv[0], kv[1], torch.full((1,), 8, dtype=torch.int32))
    assert torch.autograd.grad(od.sum(), [qd])[0].shape == qd.shape
