"""Memo-trained surrogate pre-screening (port of ``repro.core.surrogate``).

:class:`SurrogateScreen` is a ``core.evalpipe.ScreenStage``: a small MLP
*ensemble* over raw genome features (mask bits + cardinality-normalised
categorical genes) is refit from the memo every time it grows, ranks each
generation's planned-unseen children, and spends QAT rows only on

* the **predicted-undominated subset**: the non-dominated front of the
  ensemble-mean predictions, judged against the memo's exact rows too;
* a seeded **random exploration slice** (``explore_frac``), so the model
  keeps receiving labels off its own preferred region;
* every row whose **ensemble disagreement** exceeds ``std_gate``
  standard-score units.

Everything else is *deferred*: answered with the ensemble-mean
prediction, parked in the engine's deferred side table, and force-trained
the next time the genome is planned (``core.evalpipe``'s honesty rules,
which also make the reported front exact).  Below ``min_rows`` memo rows
the screen trains everything, so a cold search is bit for bit the
unscreened one.

The ensemble is one batched module over a leading member axis (the
reference's ``vmap``), fitted full-batch on ``cfg.device`` with Adam
written out as the reference writes it.  Initialisation draws from a CPU
``torch.Generator`` seeded with ``cfg.seed`` (:meth:`SurrogateScreen.init_ensemble`;
the parity tests hand it the reference's draws instead).  The exploration
slice is seeded from ``(cfg.seed, plan ordinal)``, never from an engine's
stream, so screening perturbs no variation draw.  Training rows are padded
to ``pad_rows`` buckets (weight-masked), as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import evalpipe
from repro_torch.core.nsga2 import fast_non_dominated_sort
from repro_torch.device import resolve_device

__all__ = ["SurrogateConfig", "SurrogateScreen"]


@dataclasses.dataclass(frozen=True)
class SurrogateConfig:
    # confidence gate: exact fallback (train everything) below this many
    # memo rows
    min_rows: int = 32
    # always-train slice of the planned rows, drawn with a seeded RNG
    # independent of the engine streams
    explore_frac: float = 0.15
    # ensemble size: disagreement across members is the uncertainty signal
    ensemble: int = 4
    hidden: int = 24
    train_steps: int = 150
    lr: float = 0.01
    # rows whose mean per-objective ensemble std exceeds this many
    # standard-score units always train (the model's own "don't know")
    std_gate: float = 0.65
    seed: int = 0
    # training rows are padded to multiples of this (weight-masked)
    pad_rows: int = 64
    device: str | None = None  # where the ensemble fits: None = "cuda"


def _forward(params: list[dict], x: torch.Tensor) -> torch.Tensor:
    """(E, N, n_out) outputs of every member: tanh hidden layers, linear output.

    ``x`` is (N, F), shared by the members, or (E, N, F).
    """
    for layer in params[:-1]:
        x = torch.tanh(torch.matmul(x, layer["w"]) + layer["b"].unsqueeze(1))
    last = params[-1]
    return torch.matmul(x, last["w"]) + last["b"].unsqueeze(1)


class SurrogateScreen:
    """The memo-trained screen stage (see module docstring).

    One instance may serve one engine or be shared across an island
    driver's engines, which share the memo the model learns from.
    """

    def __init__(
        self,
        n_mask_bits: int,
        cat_cardinalities: Sequence[int] = (),
        cfg: SurrogateConfig = SurrogateConfig(),
    ):
        self.n_mask_bits = int(n_mask_bits)
        self.cat_card = np.asarray(cat_cardinalities, dtype=np.int64)
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self._params: list[dict] | None = None  # fitted ensemble (E-stacked)
        self._fit_rows = -1  # memo size the ensemble was fitted on
        self._y_mean: np.ndarray | None = None
        self._y_std: np.ndarray | None = None
        self._n_plans = 0  # plan ordinal: seeds the exploration slice
        self.telemetry: list[dict] = []  # one record per screen call

    # -- features ------------------------------------------------------------

    def features(self, masks: np.ndarray, cats: np.ndarray) -> np.ndarray:
        """Raw genome -> float feature rows (masks ++ normalised cats)."""
        out = [np.asarray(masks, np.float32).reshape(masks.shape[0], -1)]
        cats = np.asarray(cats, np.int64).reshape(masks.shape[0], -1)
        if cats.shape[1]:
            out.append(
                cats.astype(np.float32)
                / np.maximum(self.cat_card, 1).astype(np.float32)
            )
        return np.concatenate(out, axis=1)

    def features_from_keys(self, keys: Sequence[bytes]) -> np.ndarray:
        """Unpack raw genome-bytes memo keys back into feature rows."""
        arr = np.frombuffer(b"".join(keys), dtype=np.uint8).reshape(len(keys), -1)
        masks = arr[:, : self.n_mask_bits].astype(bool)
        catb = np.ascontiguousarray(arr[:, self.n_mask_bits :])
        if catb.shape[1]:
            cats = catb.view(np.int64).reshape(len(keys), -1)
        else:
            cats = np.zeros((len(keys), 0), np.int64)
        return self.features(masks, cats)

    # -- model ---------------------------------------------------------------

    def init_ensemble(self, n_out: int) -> list[dict]:
        """Every member's initial parameters, stacked on a leading member axis.

        Layers ``(n_feat, hidden, hidden, n_out)``: weights normal times
        ``sqrt(2 / fan_in)``, biases zero, as the reference's
        ``_init_params``; drawn on the CPU from ``cfg.seed`` (the
        reference draws with threefry, so only the distribution is shared).
        """
        cfg = self.cfg
        sizes = (self.n_mask_bits + len(self.cat_card), cfg.hidden, cfg.hidden, n_out)
        gen = torch.Generator().manual_seed(int(cfg.seed))
        params = []
        for a, b in zip(sizes[:-1], sizes[1:]):
            w = torch.randn((cfg.ensemble, a, b), generator=gen) * float(np.sqrt(2.0 / a))
            params.append({"w": w, "b": torch.zeros((cfg.ensemble, b))})
        return params

    def _fit(self, X: np.ndarray, Y: np.ndarray, w: np.ndarray) -> list[dict]:
        """``train_steps`` full-batch Adam steps of every member on (X, Y, w).

        The update is the reference's: ``m = 0.9 m + 0.1 g``, ``v = 0.999 v
        + 0.001 g^2``, bias-corrected ``mh``/``vh`` at step t (from 1), and
        ``p - lr * mh / (sqrt(vh) + 1e-8)``.
        """
        cfg, dev = self.cfg, self.device
        X_t, Y_t, w_t = (torch.from_numpy(a).to(dev) for a in (X, Y, w))
        params = [{k: v.to(dev, torch.float32).clone().requires_grad_(True)
                   for k, v in layer.items()} for layer in self.init_ensemble(Y.shape[1])]
        flat = [v for layer in params for v in layer.values()]
        m = [torch.zeros_like(p) for p in flat]
        v = [torch.zeros_like(p) for p in flat]
        denom = torch.clamp(w_t.sum(), min=1.0)
        for t in range(1, cfg.train_steps + 1):
            err = (_forward(params, X_t) - Y_t) ** 2
            # each member's loss; they add up independently
            loss = ((w_t[:, None] * err).sum((1, 2)) / denom).sum()
            grads = torch.autograd.grad(loss, flat)
            c1 = 1.0 - 0.9 ** float(t)
            c2 = 1.0 - 0.999 ** float(t)
            with torch.no_grad():
                for p, g, m_, v_ in zip(flat, grads, m, v):
                    m_.copy_(0.9 * m_ + 0.1 * g)
                    v_.copy_(0.999 * v_ + 0.001 * g * g)
                    p.sub_(cfg.lr * (m_ / c1) / (torch.sqrt(v_ / c2) + 1e-8))
        return [{k: t.detach() for k, t in layer.items()} for layer in params]

    def _refit(self, memo) -> None:
        """Refit the ensemble on the full memo (skipped if unchanged)."""
        if len(memo) == self._fit_rows:
            return
        keys = list(memo)
        X = self.features_from_keys(keys)
        Y = np.stack([np.asarray(memo[k], np.float64) for k in keys])
        self._y_mean = Y.mean(axis=0)
        self._y_std = np.maximum(Y.std(axis=0), 1e-6)
        Yn = (Y - self._y_mean) / self._y_std
        pad = self.cfg.pad_rows
        n = len(keys)
        n_pad = ((n + pad - 1) // pad) * pad
        Xp = np.zeros((n_pad, X.shape[1]), np.float32)
        Yp = np.zeros((n_pad, Y.shape[1]), np.float32)
        w = np.zeros((n_pad,), np.float32)
        Xp[:n], Yp[:n], w[:n] = X, Yn, 1.0
        self._params = self._fit(Xp, Yp, w)
        self._fit_rows = len(memo)

    def predict(self, masks: np.ndarray, cats: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Ensemble (mean, std) objective predictions, de-normalised."""
        if self._params is None:
            raise RuntimeError("predict() before the first refit")
        X = torch.from_numpy(self.features(masks, cats)).to(self.device)
        with torch.no_grad():
            preds = _forward(self._params, X).cpu().numpy().astype(np.float64)
        mean = preds.mean(axis=0) * self._y_std + self._y_mean
        std = preds.std(axis=0) * self._y_std
        return mean, std

    # -- the screen stage ----------------------------------------------------

    def __call__(self, ctx: evalpipe.ScreenContext) -> evalpipe.ScreenDecision:
        ordinal = self._n_plans
        self._n_plans += 1  # advances on EVERY call: slice seeds replay
        unseen = ctx.unseen

        def passthrough(gate: str) -> evalpipe.ScreenDecision:
            rec = {
                "gate": gate,
                "planned": len(unseen),
                "trained": len(unseen),
                "deferred": 0,
            }
            self.telemetry.append(rec)
            return evalpipe.ScreenDecision(train=dict(unseen), telemetry=rec)

        if ctx.final:
            return passthrough("final")
        if len(ctx.memo) < self.cfg.min_rows:
            return passthrough("cold")
        if len(unseen) <= 1:
            return passthrough("tiny")

        self._refit(ctx.memo)
        rows = list(unseen.items())  # (key, pool row), plan order
        idx = np.fromiter((r for _, r in rows), np.int64, count=len(rows))
        mean, std = self.predict(ctx.masks[idx], ctx.cats[idx])

        train = set(k for k in unseen if k in ctx.must_train)
        n_must = len(train)
        # predicted-undominated subset, judged against the children AND the
        # memo's exact rows: a child predicted dominated by a trained genome
        # cannot advance the front even when the prediction is right
        memo_objs = np.stack([np.asarray(v, np.float64) for v in ctx.memo.values()])
        dominated = (
            (memo_objs[None, :, :] <= mean[:, None, :]).all(axis=2)
            & (memo_objs[None, :, :] < mean[:, None, :]).any(axis=2)
        ).any(axis=1)
        front0 = [i for i in fast_non_dominated_sort(mean)[0] if not dominated[int(i)]]
        for i in front0:
            train.add(rows[int(i)][0])
        # the model's own uncertainty, in standard-score units
        disagreement = (std / self._y_std).mean(axis=1)
        uncertain = np.where(disagreement > self.cfg.std_gate)[0]
        for i in uncertain:
            train.add(rows[int(i)][0])
        # seeded exploration slice, independent of every engine stream
        rng = np.random.default_rng((self.cfg.seed, ordinal))
        n_explore = max(1, round(self.cfg.explore_frac * len(rows)))
        for i in rng.choice(len(rows), size=min(n_explore, len(rows)), replace=False):
            train.add(rows[int(i)][0])

        deferred = {k: mean[i] for i, (k, _) in enumerate(rows) if k not in train}
        rec = {
            "gate": None,
            "planned": len(rows),
            "trained": len(rows) - len(deferred),
            "deferred": len(deferred),
            "fit_rows": self._fit_rows,
            # contributor sizes (overlapping): why each row trained
            "must": n_must,
            "front0": len(front0),
            "uncertain": int(uncertain.size),
            "explore": n_explore,
        }
        self.telemetry.append(rec)
        return evalpipe.ScreenDecision(
            train={k: unseen[k] for k in unseen if k in train},
            deferred=deferred,
            telemetry=rec,
        )
