"""Plain reference of the printed-MLP co-design: data, QAT training, area proxy.

Written from the paper's training flow (arXiv:2411.08674, section II) and
the repository's documented rules, in plain PyTorch and NumPy, fp32, with
no kernel, graph or batching trick of the program:

* the data: the seeded synthetic replica of the UCI table (a per-class
  Gaussian mixture, min-max normalised and warped per feature) and its
  stratified 70/30 split, seeded by the search;
* a row's initial weights (uniform +-1/sqrt(fan_in), zero biases) and its
  minibatch indices, drawn from a CPU ``torch.Generator`` seeded with
  ``(search seed << 32) + row seed``, in that order;
* the QAT forward: the pruned flash ADC (level = the highest kept
  comparator the input reaches), power-of-2 or ternary weights, hidden
  activations (exact ReLU or a printed approximation) clipped to [0, 1]
  and re-digitised at ``act_bits``, every quantizer with a straight-through
  gradient; the loss is the batch-weighted cross-entropy;
* SGD with momentum 0.9 under a cosine schedule over the row's budget of
  steps, the parameters frozen once it is spent;
* the area/power proxy of the pruned comparator bank and, beyond ADC
  genes, of the whole printed system.

Matmuls go through ``precision.matmul``, so the control computes the same
training with TF32 inputs.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cardbench.reference.precision import matmul

__all__ = [
    "DATASETS", "load", "stratified_split", "draw_row", "decode_cats", "train_rows",
    "bank_cost", "system_cost", "conventional_cost",
]

# name: (n_features, n_classes, n_samples, generator seed, hidden units)
DATASETS = {
    "balance": (4, 3, 625, 101, 3),
    "breast_cancer": (9, 2, 699, 102, 3),
    "cardio": (21, 3, 2126, 103, 5),
    "mammographic": (5, 2, 961, 104, 3),
    "seeds": (7, 3, 210, 105, 3),
    "vertebral3": (6, 3, 310, 106, 3),
}


def load(name: str) -> tuple[np.ndarray, np.ndarray]:
    """(X in [0, 1]^(n, f) fp32, y int64) of the dataset's replica."""
    n_features, n_classes, n_samples, seed, _ = DATASETS[name]
    rng = np.random.default_rng(seed)
    per_class = np.full(n_classes, n_samples // n_classes)
    per_class[: n_samples - per_class.sum()] += 1
    means = rng.uniform(0.2, 0.8, size=(n_classes, n_features))
    means += 0.35 * np.eye(n_classes, n_features)
    Xs, ys = [], []
    for c in range(n_classes):
        A = rng.normal(size=(n_features, n_features))
        cov = 0.045 * (A @ A.T / n_features + 0.6 * np.eye(n_features))
        Xs.append(rng.multivariate_normal(means[c], cov, size=per_class[c]))
        ys.append(np.full(per_class[c], c, dtype=np.int64))
    X, y = np.concatenate(Xs), np.concatenate(ys)
    X = (X - X.min(0)) / (X.max(0) - X.min(0) + 1e-12)
    out = np.empty_like(X)
    for f in range(X.shape[1]):  # one monotone warp a feature
        mode, col = rng.integers(0, 4), X[:, f]
        if mode == 0:
            out[:, f] = col ** (1.0 + 1.5 * rng.uniform())
        elif mode == 1:
            out[:, f] = col ** (1.0 / (1.0 + 1.5 * rng.uniform()))
        elif mode == 2:
            out[:, f] = 0.5 + 0.5 * np.tanh(3.0 * (col - 0.5)) / np.tanh(1.5)
        else:
            out[:, f] = col
    perm = rng.permutation(out.shape[0])
    return out[perm].astype(np.float32), y[perm]


def stratified_split(X, y, train_frac: float, seed: int):
    """(X_tr, y_tr, X_te, y_te): per class a shuffled ``train_frac`` cut."""
    rng = np.random.default_rng(seed)
    tr, te = [], []
    for c in np.unique(y):
        idx = np.where(y == c)[0]
        rng.shuffle(idx)
        k = int(round(train_frac * idx.size))
        tr.extend(idx[:k].tolist())
        te.extend(idx[k:].tolist())
    tr, te = np.asarray(tr), np.asarray(te)
    rng.shuffle(tr)
    rng.shuffle(te)
    return X[tr], y[tr], X[te], y[te]


def draw_row(search_seed: int, row_seed: int, layer_sizes, n_train: int, max_steps: int,
             max_batch: int):
    """One row's initial parameters {w_i: (f_in, f_out), b_i} and its
    (max_steps, max_batch) minibatch indices."""
    gen = torch.Generator().manual_seed((int(search_seed) << 32) + int(row_seed))
    params = {}
    for i, (fi, fo) in enumerate(zip(layer_sizes[:-1], layer_sizes[1:])):
        bound = 1.0 / float(fi) ** 0.5
        u = torch.rand((1, fi, fo), generator=gen, dtype=torch.float32)
        params[f"w{i}"] = (u * (2.0 * bound) - bound)[0]
        params[f"b{i}"] = torch.zeros(fo, dtype=torch.float32)
    idx = torch.randint(0, n_train, (max_steps, max_batch), generator=gen)
    return params, idx


# the categorical genes' choice tables, in gene order
WEIGHT_BITS = (8, 7, 6, 5, 4)
ACT_BITS = (4, 3, 2, 5, 6)
BATCH = (64, 32, 16, 128)
EPOCHS = (120, 80, 160, 60)
LR = (0.05, 0.02, 0.1, 0.01)
WPREC = (8.0, 6.0, 4.0, 0.0)  # po2-8, po2-6, po2-4, ternary (0.0)
ACT_AREA_SCALE = (1.0, 0.75, 0.6, 0.25)  # relu, sat01, pwl2, step


def decode_cats(cats: np.ndarray, axes, n_layers: int) -> dict:
    """The rows a genome's categorical genes select: base genes, then one
    activation gene a hidden layer ("act"), then one precision gene a layer
    ("wprec")."""
    cats = np.asarray(cats, np.int64)
    out = {
        "weight_bits": np.asarray(WEIGHT_BITS, np.float32)[cats[:, 0]],
        "act_bits": np.asarray(ACT_BITS, np.float32)[cats[:, 1]],
        "batch_size": np.asarray(BATCH, np.int64)[cats[:, 2]],
        "epochs": np.asarray(EPOCHS, np.int64)[cats[:, 3]],
        "lr": np.asarray(LR, np.float32)[cats[:, 4]],
    }
    at = 5
    if "act" in axes:
        out["act_sel"] = cats[:, at:at + n_layers - 1]
        at += n_layers - 1
    if "wprec" in axes:
        out["wprec"] = np.asarray(WPREC, np.float32)[cats[:, at:at + n_layers]]
    return out


# ---------------------------------------------------------------------------
# QAT
# ---------------------------------------------------------------------------

def _ste(x, q):
    return x + (q - x).detach()


def _clip01(x):
    # min(max(x, 0), 1): at a rail the gradient splits, as the clip is defined
    return torch.minimum(torch.maximum(x, torch.zeros_like(x)), torch.ones_like(x))


def _adc(x, masks, n_bits: int):
    """(P, B, C) inputs through each row's pruned banks (P, C, 2^N): the
    value of the highest kept level whose threshold the input reaches."""
    n = 1 << n_bits
    lvl = torch.arange(1, n, dtype=torch.float32, device=x.device)
    fired = (x[..., None] >= lvl / n) & masks[:, None, :, 1:]
    level = torch.where(fired, lvl, torch.zeros_like(lvl)).amax(-1)
    return level / n


def _pow2(w, bits):
    e_lo = -torch.exp2(bits - 1.0) + 1.0
    mag = w.abs()
    e = torch.round(torch.log2(mag.clamp(min=1e-12)))
    e = torch.clamp(torch.maximum(e, e_lo), max=0.0)
    q = torch.sign(w) * torch.exp2(e)
    q = torch.where(mag < torch.exp2(e_lo - 1.0), torch.zeros_like(q), q)
    return _ste(w, q)


def _ternary(w):
    P = w.shape[0]
    mag = w.abs()
    flat = mag.reshape(P, -1)
    shape = (P,) + (1,) * (w.ndim - 1)
    live = mag > (0.7 * flat.mean(1)).view(shape)
    count = live.reshape(P, -1).sum(1).clamp(min=1).to(w.dtype)
    scale = torch.where(live, mag, torch.zeros_like(mag)).reshape(P, -1).sum(1) / count
    q = torch.where(live, torch.sign(w) * scale.view(shape), torch.zeros_like(w))
    return _ste(w, q)


def _weights(w, bits):
    """Per-row weights: po2 at ``bits`` (P,), ternary where bits == 0."""
    b = bits.view((-1,) + (1,) * (w.ndim - 1))
    return torch.where(b > 0, _pow2(w, b.clamp(min=1.0)), _ternary(w))


def _uniform(x, bits):
    scale = torch.exp2(bits) - 1.0
    q = torch.minimum(torch.maximum(torch.round(x * scale), torch.zeros_like(scale)), scale)
    return _ste(x, q / scale)


def _act(h, sel):
    """Each row's hidden activation: 0 ReLU, 1 clip to [0, 1], 2 a two-slope
    PWL, 3 a mid-rail comparator (with the clip's gradient)."""
    sel = sel.view((-1,) + (1,) * (h.ndim - 1))
    step = _ste(_clip01(h), (h > 0.5).to(h.dtype))
    pwl = torch.relu(h) - 0.5 * torch.relu(h - 0.5)
    out = torch.where(sel == 0, torch.relu(h), step)
    out = torch.where(sel == 1, _clip01(h), out)
    return torch.where(sel == 2, pwl, out)


def _forward(params, x, masks, wb, ab, act_sel, wprec, n_bits, precision):
    n_layers = len(params) // 2
    h = _adc(x, masks, n_bits)
    for i in range(n_layers):
        bits = wprec[:, i] if wprec is not None else wb
        if i:
            sel = act_sel[:, i - 1] if act_sel is not None else torch.zeros_like(ab)
            h = _uniform(_clip01(_act(h, sel)), ab.view(-1, 1, 1))
        h = matmul(h, _weights(params[f"w{i}"], bits), precision) + params[f"b{i}"][:, None]
    return h


def train_rows(X_tr, y_tr, X_te, y_te, rows: dict, params0: dict, idx: torch.Tensor,
               n_bits: int, max_steps: int, step_scale: float, momentum: float = 0.9,
               precision: str = "fp32", on_step=None) -> torch.Tensor:
    """Test-set accuracies (P,) of P rows after their QAT runs.

    ``X_tr`` (D, n_train, C) and ``y_tr`` hold one split a dataset index;
    ``rows["data"]`` (P,) picks each row's.  ``rows`` holds masks (P, C, 2^N)
    bool, weight_bits, act_bits, lr (P,) fp32, batch_size, epochs (P,) int and
    optionally act_sel (P, n_hidden) and wprec (P, n_layers); ``params0`` the
    stacked initial parameters and ``idx`` (P, max_steps, B) the minibatch
    indices.  Everything on one device.  ``on_step(t, params, vel)``, if
    given, sees each step's parameters and velocities once it has updated
    them."""
    dev = X_tr.device
    P, B = idx.shape[0], idx.shape[2]
    n_train, n_test = X_tr.shape[1], X_te.shape[1]
    data = rows["data"]
    masks = rows["masks"]
    wb, ab, lr0 = rows["weight_bits"], rows["act_bits"], rows["lr"]
    act_sel, wprec = rows.get("act_sel"), rows.get("wprec")
    bs = rows["batch_size"].to(torch.float32)
    budget = torch.clamp(torch.clamp(rows["epochs"].to(torch.float32)
                                     * torch.ceil(n_train / bs) * step_scale, min=1.0),
                         max=float(max_steps))
    weight = (torch.arange(B, device=dev)[None] < bs[:, None]).to(torch.float32)
    denom = weight.sum(1).clamp(min=1.0)
    params = {k: v.clone().requires_grad_(True) for k, v in params0.items()}
    vel = {k: torch.zeros_like(v) for k, v in params.items()}
    for t in range(max_steps):
        it = idx[:, t]
        x = X_tr[data[:, None], it]
        y = y_tr[data[:, None], it]
        logits = _forward(params, x, masks, wb, ab, act_sel, wprec, n_bits, precision)
        ce = torch.logsumexp(logits, -1) - logits.gather(-1, y[..., None])[..., 0]
        loss = ((weight * ce).sum(1) / denom).sum()
        grads = torch.autograd.grad(loss, list(params.values()))
        frac = torch.clamp(t / budget, max=1.0)
        lr_t = lr0 * 0.5 * (1.0 + torch.cos(math.pi * frac))
        on = (t < budget).to(torch.float32)
        with torch.no_grad():
            for (k, p), g in zip(params.items(), grads):
                shape = (P,) + (1,) * (p.ndim - 1)
                vel[k] = momentum * vel[k] - lr_t.view(shape) * g
                p.add_(on.view(shape) * vel[k])
        if on_step is not None:
            on_step(t, params, vel)
    with torch.no_grad():
        logits = _forward(params, X_te[data], masks, wb, ab, act_sel, wprec, n_bits, precision)
        # the first largest logit, as argmax takes ties
        pred = logits.argmax(-1)
        return (pred == y_te[data]).to(torch.float32).sum(1) / n_test


# ---------------------------------------------------------------------------
# area / power proxy (EGFET gate costs: area cm^2, power mW)
# ---------------------------------------------------------------------------

A_COMP, A_OR, A_AND = 0.0095, 0.0008, 0.0006
P_COMP, P_OR, P_AND = 0.075, 0.004, 0.003
A_ADD_BIT, P_ADD_BIT, A_RELU_BIT, P_RELU_BIT = 0.004, 0.010, 0.0006, 0.002


def _channel_gates(mask, n_bits: int) -> tuple[int, int, int]:
    """(comparators, OR gates, AND gates) of one channel's pruned ADC: a
    comparator a kept level above 0, an OR tree an output bit over the kept
    levels whose code sets it, an AND a kept level but the topmost."""
    kept = [i for i in range(1, 1 << n_bits) if mask[i]]
    n_or = sum(max(sum((i >> b) & 1 for i in kept) - 1, 0) for b in range(n_bits))
    return len(kept), n_or, max(len(kept) - 1, 0)


def bank_cost(mask: np.ndarray, n_bits: int) -> tuple[float, float]:
    """(area, power) of one pruned bank (C, 2^N): the sum of its channels."""
    area = power = 0.0
    for ch in np.asarray(mask, bool):
        n_cmp, n_or, n_and = _channel_gates(ch, n_bits)
        area += n_cmp * A_COMP + n_or * A_OR + n_and * A_AND
        power += n_cmp * P_COMP + n_or * P_OR + n_and * P_AND
    return area, power


def conventional_cost(n_channels: int, n_bits: int) -> tuple[float, float]:
    return bank_cost(np.ones((n_channels, 1 << n_bits), bool), n_bits)


def system_cost(mask, n_bits: int, layer_sizes, weight_bits: float, act_bits: float,
                act_sel=None, wprec=None) -> tuple[float, float]:
    """(area, power) of the bank plus the bespoke MLP's adder trees and
    activation stages: a neuron of fan-in f has f adders (the bias one of
    them) of ``act_bits + w // 2`` bits (a ternary layer: ``act_bits + 1``),
    and an output stage scaled by its activation's circuit."""
    area, power = bank_cost(mask, n_bits)
    n_layers = len(layer_sizes) - 1
    for i, (fan_in, n_out) in enumerate(zip(layer_sizes[:-1], layer_sizes[1:])):
        w = float(weight_bits) if wprec is None else float(wprec[i])
        acc = float(act_bits) + (w // 2 if w > 0 else 1.0)
        area += fan_in * n_out * acc * A_ADD_BIT
        power += fan_in * n_out * acc * P_ADD_BIT
        s = ACT_AREA_SCALE[int(act_sel[i])] if act_sel is not None and i < n_layers - 1 else 1.0
        area += s * n_out * acc * A_RELU_BIT
        power += s * n_out * acc * P_RELU_BIT
    return area, power
