"""Shared inputs of the fused QAT step's tests (CPU and card): a bucket's
buffers (``trainer._Slots``) filled from a seed, copies of them, and the
population step as ``core.trainer._train_block`` ran it before the fused
step (the masks' tables made inside every step)."""

import copy

import torch

from repro_torch.core import qat, trainer
from repro_torch.data import uci_synth
from repro_torch.kernels.pruned_quant.ref import make_tables

STEPS = 10  # a block of the default EvalConfig.block_steps


def dataset(name: str, device="cpu"):
    """(X_tr, y_tr, layer sizes) of one dataset's training split."""
    X, y, spec = uci_synth.load(name)
    X_tr, y_tr, _, _ = uci_synth.stratified_split(X, y, 0.7, 0)
    return (torch.from_numpy(X_tr).float().to(device), torch.from_numpy(y_tr).long().to(device),
            (spec.n_features, spec.hidden, spec.n_classes))


def bucket(sizes, P: int, n_train: int, seed: int, device="cpu", max_batch: int = 128):
    """``(mlp_cfg, slots)``: a bucket of P rows of an MLP of ``sizes``, every
    buffer drawn from ``seed`` (random parameters, masks, widths, batch
    sizes up to ``max_batch``, a block's indices, rates and gates) and the
    masks' tables made."""
    mcfg = qat.MLPConfig(tuple(sizes))
    s = trainer._Slots(P, mcfg, trainer.EvalConfig(max_steps=STEPS, max_batch=max_batch),
                       torch.device(device))
    g = torch.Generator().manual_seed(seed)

    def put(dst, src):
        dst.copy_(src.to(dst.device))

    with torch.no_grad():
        for k, v in s.params.items():
            put(v, (torch.rand(v.shape, generator=g) * 2 - 1) * (0.3 if k[0] == "b" else 1.0))
    masks = torch.rand(s.masks.shape, generator=g) < torch.rand((P, 1, 1), generator=g)
    masks[:, :, 0] = True
    put(s.masks, masks)
    put(s.wb, torch.tensor([8.0, 6.0, 4.0])[torch.randint(0, 3, (P,), generator=g)])
    put(s.ab, torch.tensor([4.0, 3.0, 5.0])[torch.randint(0, 3, (P,), generator=g)])
    bs = torch.tensor([16, 64, 128]).clamp(max=max_batch)[torch.randint(0, 3, (P,), generator=g)]
    w = (torch.arange(s.w.shape[1]) < bs[:, None]).float()
    put(s.w, w)
    put(s.denom, w.sum(-1).clamp(min=1.0))
    put(s.idx, torch.randint(0, n_train, s.idx.shape, generator=g))
    put(s.lr, torch.rand(s.lr.shape, generator=g) * 0.1)
    put(s.gate, (torch.rand(s.gate.shape, generator=g) < 0.8).float())
    thr, ids = make_tables(s.masks, mcfg.adc_bits)
    s.thr.copy_(thr)
    s.ids.copy_(ids)
    return mcfg, s


def clone(s):
    """A copy of the buffers a step writes (parameters, velocities); the rest shared."""
    t = copy.copy(s)
    t.params = {k: v.detach().clone().requires_grad_(True) for k, v in s.params.items()}
    t.vel = {k: v.clone() for k, v in s.vel.items()}
    return t


def rows(s, sl):
    """The rows ``sl`` of a bucket, as a bucket of their own (copies)."""
    t = copy.copy(s)
    for k in ("masks", "thr", "ids", "wb", "ab", "w", "denom", "idx", "lr", "gate"):
        setattr(t, k, getattr(s, k)[sl].clone())
    t.params = {k: v.detach()[sl].clone().requires_grad_(True) for k, v in s.params.items()}
    t.vel = {k: v[sl].clone() for k, v in s.vel.items()}
    return t


def same(a, b) -> bool:
    """Parameters and velocities of two buckets, the same bits."""
    return all(torch.equal(a.params[k], b.params[k]) and torch.equal(a.vel[k], b.vel[k])
               for k in a.params)


def todays_chain(X_tr, y_tr, mlp_cfg, momentum, s, n_steps) -> None:
    """The population step before the fused step, as ``_train_block`` wrote it."""
    P = s.masks.shape[0]
    params = list(s.params.values())
    for j in range(n_steps):
        it = s.idx[:, j]
        logits = qat.mlp_forward(s.params, X_tr[it], mlp_cfg, s.masks, s.wb, s.ab,
                                 act_sel=s.act_sel, layer_weight_bits=s.wprec)
        loss = ((s.w * qat.cross_entropy(logits, y_tr[it])) / s.denom[:, None]).sum()
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            lr_t, on = s.lr[:, j], s.gate[:, j]
            for (k, p), g in zip(s.params.items(), grads):
                shape = (P,) + (1,) * (p.ndim - 1)
                v = s.vel[k]
                v.copy_(momentum * v - lr_t.view(shape) * g)
                p.add_(on.view(shape) * v)
