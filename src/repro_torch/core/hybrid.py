"""Gradient/GA hybrid search (port of ``repro.core.hybrid``): relaxed warm starts, refinement.

``core.relaxed`` holds the differentiable formulation of the genome; this
module lets the discrete NSGA-II search use it at two points:

* **Warm start** (:func:`warm_start_genomes`): ``n_restarts`` seeded
  relaxed descents, one batch over restarts, whose intermediate and final
  states are argmax-hardened (:func:`harden`) into genomes.  The caller
  re-scores them exactly (``NSGA2.score_pool``) and seeds the populations
  with them (``NSGA2.seed_warm``).
* **Refinement** (:func:`make_refiner`): a mutation operator for
  ``NSGA2.set_refiner`` that relaxes front-0 members (logits from their
  one-hot genes), runs a few annealed gradient steps and hardens the
  result.  It is a pure function of the genomes: each member's MLP draw
  is seeded from its genome bytes, and host RNG is never touched, so the
  engine's variation stream survives, and a refined child equal to its
  parent costs no training row.

Nothing the relaxed objective computes is reported: every genome made
here is re-scored by the exact QAT evaluator before the search sees it.
The descents run batched on the device (``device``, None = the card); the
initial draws come from CPU ``torch.Generator``\\ s (:func:`_restart_draws`,
:func:`_member_params`; the parity tests substitute the reference's).
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch

from repro_torch.core import chromosome, qat, relaxed
from repro_torch.device import resolve_device

__all__ = [
    "HybridConfig",
    "harden",
    "warm_start_genomes",
    "make_refiner",
]

# Refinement-descent initialisation: mask logits start at +/- this (soft
# at tau_start so marginal bits can flip, saturating as tau anneals), and
# selector logits at this scale times the parent's one-hot genes.
_INIT_THETA = 1.0
_INIT_LOGIT = 1.5


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Knobs of both hybrid descents (warm start and refinement).

    ``grad_steps`` is the per-descent step count (the anneal reaches
    ``tau_end`` at the final step); ``n_restarts`` x ``n_snapshots`` bounds
    how many warm genomes a warm start can yield before dedupe.  Restart
    ``b`` of ``B`` minimises CE + ``lambda_b`` x area with ``lambda_b``
    logspaced over ``[lambda_area / lambda_spread, lambda_area *
    lambda_spread]``, so the hardened states spread along the
    accuracy/area trade-off; refinement uses ``lambda_area`` itself.
    """

    n_restarts: int = 4
    grad_steps: int = 30
    n_snapshots: int = 4
    lr: float = 0.05
    mask_lr: float = 2.0
    lambda_area: float = 1.0
    lambda_spread: float = 10.0
    tau_start: float = 2.0
    tau_end: float = 0.2
    seed: int = 0

    def restart_lambdas(self) -> np.ndarray:
        """Per-restart area weights (logspaced; see class docstring)."""
        if self.n_restarts == 1:
            return np.asarray([self.lambda_area], np.float32)
        span = np.log10(self.lambda_spread)
        return (self.lambda_area * np.logspace(-span, span, self.n_restarts)).astype(np.float32)


def _genome_bytes(masks: np.ndarray, cats: np.ndarray) -> list[bytes]:
    """Canonical genome bytes (dedupe / deterministic seed derivation)."""
    masks = np.asarray(masks, bool)
    cats = np.asarray(cats, np.int64)
    return [m.tobytes() + c.tobytes() for m, c in zip(masks, cats)]


def _descend(X, y, params, theta, phi, psi, lam, mlp_cfg, axes, cfg: HybridConfig):
    """The shared relaxed descent of the warm start and the refiner: its trajectory."""
    return relaxed.descend(params, theta, phi, psi, X, y, lam, mlp_cfg, axes, cfg.grad_steps,
                           cfg.lr, cfg.mask_lr, cfg.tau_start, cfg.tau_end)[1]


def harden(
    theta,
    phi,
    psi,
    axes=("adc",),
    n_layers: int = 2,
    base_cats: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Argmax-harden one relaxed state into discrete genome gene arrays.

    ``theta`` is the ``(C, 2^N - 1)`` mask-logit matrix (level 0 is
    implicit and forced kept); ``phi`` / ``psi`` are the selector-logit
    matrices, ignored for disabled axes (may be None then).  The descents
    do not relax the 5 base QAT genes, so ``base_cats`` supplies them,
    default all-zero (the exact defaults).  Returns ``(mask_genes,
    cat_genes)`` in the canonical ``core.chromosome`` layout.  NumPy,
    copied from the reference: the same logits give the same genomes.
    """
    axes = chromosome.normalize_axes(axes)
    theta = np.asarray(theta)
    C = theta.shape[0]
    mask = np.concatenate([np.ones((C, 1), bool), theta > 0.0], axis=1)
    if base_cats is None:
        base = np.zeros(chromosome.N_BASE_CATS, np.int64)
    else:
        base = np.asarray(base_cats, np.int64).reshape(-1)
        if base.shape[0] != chromosome.N_BASE_CATS:
            raise ValueError(
                f"base_cats has {base.shape[0]} genes, expected {chromosome.N_BASE_CATS}"
            )
    groups = [base]
    if "act" in axes:
        act = np.argmax(np.asarray(phi), axis=-1).astype(np.int64).reshape(-1)
        groups.append(act[: n_layers - 1])
    if "wprec" in axes:
        wp = np.argmax(np.asarray(psi), axis=-1).astype(np.int64).reshape(-1)
        if wp.shape[0] != n_layers:
            raise ValueError(f"psi has {wp.shape[0]} rows, expected {n_layers}")
        groups.append(wp)
    return mask.reshape(-1), np.concatenate(groups)


def _restart_draws(cfg: HybridConfig, mlp_cfg: qat.MLPConfig, C: int):
    """The warm start's initial state of every restart, from ``cfg.seed``.

    Returns ``(params, theta, phi, psi)`` stacked over ``cfg.n_restarts``:
    MLP draws as ``qat.init_mlp``; mask logits ``0.5 * normal`` (gates
    near 0.5, undecided); selector logits the tilt toward choice 0 plus
    ``0.25 * normal``, the reference's distributions (its threefry bits
    are not reproduced).
    """
    n = 1 << mlp_cfg.adc_bits
    nl = len(mlp_cfg.layer_sizes) - 1
    gen = torch.Generator().manual_seed(int(cfg.seed))
    rows = [qat.init_mlp(gen, mlp_cfg) for _ in range(cfg.n_restarts)]
    params = {k: torch.cat([r[k] for r in rows]) for k in rows[0]}
    R = cfg.n_restarts
    theta = 0.5 * torch.randn((R, C, n - 1), generator=gen)
    _, phi, psi = relaxed.init_genes(C, n, nl, R)
    phi = phi + 0.25 * torch.randn(phi.shape, generator=gen)
    psi = psi + 0.25 * torch.randn(psi.shape, generator=gen)
    return params, theta, phi, psi


def _member_params(seeds: np.ndarray, mlp_cfg: qat.MLPConfig) -> dict[str, torch.Tensor]:
    """The refiner's MLP draw of each member, from its genome-derived seed alone."""
    rows = [qat.init_mlp(torch.Generator().manual_seed(int(s)), mlp_cfg) for s in seeds]
    return {k: torch.cat([r[k] for r in rows]) for k in rows[0]}


def _device_data(X, y, dev):
    X = torch.as_tensor(np.asarray(X), dtype=torch.float32).to(dev)
    return X, torch.as_tensor(np.asarray(y), dtype=torch.int64).to(dev)


def warm_start_genomes(
    X_tr,
    y_tr,
    layer_sizes,
    adc_bits: int,
    axes=("adc",),
    cfg: HybridConfig = HybridConfig(),
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Run ``cfg.n_restarts`` seeded relaxed descents and harden their trajectories.

    Each descent contributes ``cfg.n_snapshots`` states evenly spaced over
    the second half of the anneal, the final step included, each hardened
    into a genome.  Duplicates (by genome bytes) are dropped, first
    occurrence wins, restart-major / early-snapshot-minor order.  Returns
    ``(masks, cats)`` gene arrays; the caller re-scores and seeds them.
    """
    axes = chromosome.normalize_axes(axes)
    dev = resolve_device(device)
    n = 1 << adc_bits
    C = int(np.asarray(X_tr).shape[1])
    nl = len(layer_sizes) - 1
    mlp_cfg = qat.MLPConfig(tuple(layer_sizes), adc_bits=adc_bits)
    X, y = _device_data(X_tr, y_tr, dev)
    params, theta, phi, psi = _restart_draws(cfg, mlp_cfg, C)
    traj = _descend(X, y, {k: v.to(dev) for k, v in params.items()}, theta.to(dev),
                    phi.to(dev), psi.to(dev), torch.from_numpy(cfg.restart_lambdas()).to(dev),
                    mlp_cfg, axes, cfg)
    steps = cfg.grad_steps
    k = max(1, min(cfg.n_snapshots, steps))
    # skip the (k+1)-point grid's t=0 entry: the un-annealed start is noise
    snap = np.unique(np.round(np.linspace(0, steps - 1, k + 1))[1:]).astype(int)
    states = {int(t): [a.cpu().numpy() for a in traj[int(t)]] for t in snap}
    seen: set[bytes] = set()
    out_m: list[np.ndarray] = []
    out_c: list[np.ndarray] = []
    for b in range(cfg.n_restarts):
        for t in snap:
            th, ph, ps = states[int(t)]
            mg, cg = harden(th[b], ph[b], ps[b], axes=axes, n_layers=nl)
            key = mg.tobytes() + cg.tobytes()
            if key in seen:
                continue
            seen.add(key)
            out_m.append(mg)
            out_c.append(cg)
    if not out_m:
        n_cats = len(chromosome.cat_cardinalities(axes, nl))
        return np.zeros((0, C * n), bool), np.zeros((0, n_cats), np.int64)
    return np.asarray(out_m, bool), np.asarray(out_c, np.int64)


def make_refiner(
    X_tr,
    y_tr,
    layer_sizes,
    adc_bits: int,
    axes=("adc",),
    cfg: HybridConfig = HybridConfig(),
    device=None,
):
    """Build the front-0 refinement operator for ``NSGA2.set_refiner``.

    The returned ``refine(masks, cats) -> (masks, cats)`` relaxes each
    genome (mask logits at ``+/-_INIT_THETA`` from its mask bits, selector
    logits at ``_INIT_LOGIT`` times its one-hot genes), runs
    ``cfg.grad_steps`` annealed gradient steps, all members in one batch,
    and hardens the final state, keeping each parent's base QAT genes.
    A pure function of its inputs: each member's MLP draw is seeded from
    ``(crc32(genome bytes) + cfg.seed) & 0x7FFFFFFF``, and every member's
    sums run in its own fixed order, so a genome refines to the same genome
    in any batch.
    """
    axes = chromosome.normalize_axes(axes)
    has_act = "act" in axes
    has_wprec = "wprec" in axes
    dev = resolve_device(device)
    n = 1 << adc_bits
    nl = len(layer_sizes) - 1
    A = len(chromosome.ACT_APPROX_CHOICES)
    W = len(chromosome.WPREC_CHOICES)
    mlp_cfg = qat.MLPConfig(tuple(layer_sizes), adc_bits=adc_bits)
    X, y = _device_data(X_tr, y_tr, dev)

    def refine(masks: np.ndarray, cats: np.ndarray):
        masks = np.asarray(masks, bool)
        cats = np.asarray(cats, np.int64)
        P = masks.shape[0]
        if P == 0:
            return masks.copy(), cats.copy()
        m = masks.reshape(P, -1, n)
        th0 = np.where(m[:, :, 1:], _INIT_THETA, -_INIT_THETA).astype(np.float32)
        groups = chromosome.split_cats(cats, axes, nl)
        ph0 = np.zeros((P, max(nl - 1, 1), A), np.float32)
        if has_act and nl > 1:
            ph0[:, : nl - 1] = _INIT_LOGIT * np.eye(A, dtype=np.float32)[groups["act"]]
        ps0 = np.zeros((P, nl, W), np.float32)
        if has_wprec:
            ps0 = _INIT_LOGIT * np.eye(W, dtype=np.float32)[groups["wprec"]]
        seeds = np.asarray(
            [(zlib.crc32(k) + cfg.seed) & 0x7FFFFFFF for k in _genome_bytes(masks, cats)],
            np.int64,
        )
        params = {k: v.to(dev) for k, v in _member_params(seeds, mlp_cfg).items()}
        th, ph, ps = (a.cpu().numpy() for a in _descend(
            X, y, params, *(torch.from_numpy(a).to(dev) for a in (th0, ph0, ps0)),
            cfg.lambda_area, mlp_cfg, axes, cfg)[-1])
        base = groups["base"]
        out_m: list[np.ndarray] = []
        out_c: list[np.ndarray] = []
        for i in range(P):
            mg, cg = harden(th[i], ph[i], ps[i], axes=axes, n_layers=nl, base_cats=base[i])
            out_m.append(mg)
            out_c.append(cg)
        return np.asarray(out_m, bool), np.asarray(out_c, np.int64)

    return refine
