"""Synthetic statistical replicas of the paper's six UCI datasets.

The container is offline, so the real UCI tables (Balance, Breast Cancer,
Cardiotocography, Mammographic, Seeds, Vertebral Column 3) cannot be
downloaded.  Each replica preserves the published feature count, class
count and sample count, and is generated as a per-class anisotropic
Gaussian mixture whose components are placed to give a linearly-nontrivial
but learnable problem (printed-MLP accuracy targets in the paper are
80–95%).  Feature marginals are min-max normalised to [0, 1] exactly as
the paper does, and — importantly for the ADC-pruning story — each feature
is pushed through a dataset-seeded monotone warp so different channels
occupy *different sub-ranges* of [0, 1]: this is the distribution
non-uniformity the paper exploits ("not all the representations are
required").

Splits follow the paper: stratified random 70 / 30 train / test.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["DATASETS", "DatasetSpec", "load", "stratified_split"]


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    short: str
    n_features: int
    n_classes: int
    n_samples: int
    seed: int
    # published topology family for the bespoke MLP ([3]-[7] use one hidden
    # layer; sizes follow the MICRO'20 / DATE'23 printed-MLP settings)
    hidden: int


DATASETS: dict[str, DatasetSpec] = {
    "balance": DatasetSpec("Balance", "Ba", 4, 3, 625, 101, 3),
    "breast_cancer": DatasetSpec("Breast Cancer", "BC", 9, 2, 699, 102, 3),
    "cardio": DatasetSpec("Cardiotocography", "Ca", 21, 3, 2126, 103, 5),
    "mammographic": DatasetSpec("Mammographic", "Ma", 5, 2, 961, 104, 3),
    "seeds": DatasetSpec("Seeds", "Se", 7, 3, 210, 105, 3),
    "vertebral3": DatasetSpec("Vertebral Column 3", "V3", 6, 3, 310, 106, 3),
}


def _monotone_warp(x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Feature-wise monotone warp so channels use uneven level subsets."""
    out = np.empty_like(x)
    for f in range(x.shape[1]):
        mode = rng.integers(0, 4)
        c = x[:, f]
        if mode == 0:  # compress into lower range
            out[:, f] = c ** (1.0 + 1.5 * rng.uniform())
        elif mode == 1:  # compress into upper range
            out[:, f] = c ** (1.0 / (1.0 + 1.5 * rng.uniform()))
        elif mode == 2:  # mid-heavy (sigmoid-ish)
            out[:, f] = 0.5 + 0.5 * np.tanh(3.0 * (c - 0.5)) / np.tanh(1.5)
        else:  # leave near-uniform
            out[:, f] = c
    return out


def load(name: str) -> tuple[np.ndarray, np.ndarray, DatasetSpec]:
    """Returns (X in [0,1]^(n,f), y int labels, spec)."""
    spec = DATASETS[name]
    rng = np.random.default_rng(spec.seed)
    per_class = np.full(spec.n_classes, spec.n_samples // spec.n_classes)
    per_class[: spec.n_samples - per_class.sum()] += 1
    Xs, ys = [], []
    # class means spread on a simplex-ish layout with shared covariance
    means = rng.uniform(0.2, 0.8, size=(spec.n_classes, spec.n_features))
    # partial separation: printed-MLP accuracy targets in the paper are 80-95%
    means += 0.35 * np.eye(spec.n_classes, spec.n_features)
    for c in range(spec.n_classes):
        A = rng.normal(size=(spec.n_features, spec.n_features))
        cov = 0.045 * (A @ A.T / spec.n_features + 0.6 * np.eye(spec.n_features))
        Xs.append(rng.multivariate_normal(means[c], cov, size=per_class[c]))
        ys.append(np.full(per_class[c], c, dtype=np.int64))
    X = np.concatenate(Xs)
    y = np.concatenate(ys)
    # min-max normalise to [0,1], then warp marginals (see module docstring)
    X = (X - X.min(0)) / (X.max(0) - X.min(0) + 1e-12)
    X = _monotone_warp(X, rng)
    perm = rng.permutation(X.shape[0])
    return X[perm].astype(np.float32), y[perm], spec


def stratified_split(
    X: np.ndarray, y: np.ndarray, train_frac: float = 0.7, seed: int = 0
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Random stratified split (paper: 70/30)."""
    rng = np.random.default_rng(seed)
    tr_idx, te_idx = [], []
    for c in np.unique(y):
        idx = np.where(y == c)[0]
        rng.shuffle(idx)
        k = int(round(train_frac * idx.size))
        tr_idx.extend(idx[:k].tolist())
        te_idx.extend(idx[k:].tolist())
    tr = np.asarray(tr_idx)
    te = np.asarray(te_idx)
    rng.shuffle(tr)
    rng.shuffle(te)
    return X[tr], y[tr], X[te], y[te]
