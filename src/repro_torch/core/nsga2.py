"""NSGA-II (Deb et al., 2002), the paper's multi-objective search (port of ``repro.core.nsga2``).

Population genetics run on the host in NumPy as batch array programs:
binary tournament on (rank, crowding), uniform crossover, bit-flip and
categorical-resample mutation touch the whole population at once.
Objectives come from a callback, in the co-design the population QAT
evaluator on the card.

With ``NSGA2Config.memoize`` (default) objective vectors are cached under
the raw genome bytes: every generation the full parent+child pool goes
through the memo and only genomes never seen before are evaluated.  With
``memoize=False`` every pool is evaluated in full (the paper-style naive
flow).

This is the single-population engine the co-design's default path runs,
copied from the reference with the same RNG draws in the same order, so
the same objectives give the same fronts, memo and counters.  The island
model, the async and stacked drivers, checkpoint state, warm seeding and
the refiner hooks wait for later slices of the port.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np

from repro_torch.core import evalpipe

__all__ = [
    "fast_non_dominated_sort",
    "crowding_distance",
    "hypervolume_2d",
    "batch_tournament",
    "uniform_crossover",
    "mutate_masks",
    "mutate_cats",
    "genome_keys",
    "NSGA2Config",
    "NSGA2",
]


def fast_non_dominated_sort(objs: np.ndarray) -> list[np.ndarray]:
    """Partition population into Pareto fronts (minimisation).

    Args: objs (P, M). Returns list of index arrays, front 0 first.
    """
    P = objs.shape[0]
    # dominated[i, j] = i dominates j  (<= on all objs, < on at least one)
    le = np.all(objs[:, None, :] <= objs[None, :, :], axis=-1)
    lt = np.any(objs[:, None, :] < objs[None, :, :], axis=-1)
    dom = le & lt
    n_dominators = dom.sum(axis=0)  # how many dominate column j
    fronts: list[np.ndarray] = []
    remaining = np.ones(P, dtype=bool)
    while remaining.any():
        front = np.where(remaining & (n_dominators == 0))[0]
        if front.size == 0:  # numerical ties: flush the rest as one front
            front = np.where(remaining)[0]
        fronts.append(front)
        remaining[front] = False
        n_dominators = n_dominators - dom[front].sum(axis=0)
    return fronts


def crowding_distance(objs: np.ndarray) -> np.ndarray:
    """Crowding distance within ONE front. objs (F, M) -> (F,)."""
    F, M = objs.shape
    if F <= 2:
        return np.full(F, np.inf)
    d = np.zeros(F)
    for m in range(M):
        order = np.argsort(objs[:, m], kind="stable")
        span = objs[order[-1], m] - objs[order[0], m]
        d[order[0]] = d[order[-1]] = np.inf
        if span > 0:
            d[order[1:-1]] += (objs[order[2:], m] - objs[order[:-2], m]) / span
    return d


def hypervolume_2d(objs: np.ndarray, ref: tuple[float, float]) -> float:
    """Dominated hypervolume of a 2-objective minimisation set w.r.t. ``ref``.

    Standard sweep: points at or beyond the reference point contribute
    nothing; the rest are reduced to their non-dominated subset, sorted by
    obj0, and summed as the union of rectangles against ``ref``.  Used to
    compare island-merged fronts against the single-population front at
    equal evaluation budget (``benchmarks/ga_runtime.run_islands``).
    """
    pts = np.asarray(objs, dtype=np.float64).reshape(-1, 2)
    pts = pts[np.all(pts < np.asarray(ref, np.float64), axis=1)]
    if pts.shape[0] == 0:
        return 0.0
    front = pts[fast_non_dominated_sort(pts)[0]]
    front = front[np.argsort(front[:, 0], kind="stable")]
    hv, prev1 = 0.0, float(ref[1])
    for x0, x1 in front:
        if x1 < prev1:
            hv += (ref[0] - x0) * (prev1 - x1)
            prev1 = float(x1)
    return float(hv)


# ---------------------------------------------------------------------------
# Vectorized variation operators.  Pure functions of pre-drawn randomness so
# tests can prove them equivalent to a per-individual reference loop under
# the exact same random draws (tests/test_nsga2_vectorized.py).
# ---------------------------------------------------------------------------

def batch_tournament(
    rank: np.ndarray, crowd: np.ndarray, cand: np.ndarray
) -> np.ndarray:
    """Binary tournaments for a whole mating pool at once.

    ``cand`` is (n, 2) pre-drawn candidate index pairs; the winner of row t
    is ``cand[t, 0]`` unless ``cand[t, 1]`` has strictly lower rank, or
    equal rank and strictly larger crowding (ties keep the first candidate,
    matching the scalar tournament).  Returns (n,) winner indices.
    """
    i, j = cand[:, 0], cand[:, 1]
    j_wins = (rank[j] < rank[i]) | ((rank[j] == rank[i]) & (crowd[j] > crowd[i]))
    return np.where(j_wins, j, i)


def uniform_crossover(
    ga: np.ndarray, gb: np.ndarray, do_cross: np.ndarray, swap: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Batched uniform crossover.

    ``ga``/``gb`` are (n, L) parent gene rows, ``do_cross`` (n,) pair-level
    gates, ``swap`` (n, L) per-gene swap coins.  Gene positions where both
    the pair gate and the coin are set are exchanged between the children.
    """
    sw = swap & do_cross[:, None]
    return np.where(sw, gb, ga), np.where(sw, ga, gb)


def mutate_masks(masks: np.ndarray, flip: np.ndarray) -> np.ndarray:
    """Bit-flip mutation of the boolean mask genes (batched XOR)."""
    return masks ^ flip


def mutate_cats(
    cats: np.ndarray, resample: np.ndarray, new_vals: np.ndarray
) -> np.ndarray:
    """Discrete resampling mutation of the categorical genes (batched)."""
    if cats.size == 0:
        return cats
    return np.where(resample, new_vals, cats)


def genome_keys(masks: np.ndarray, cats: np.ndarray) -> list[bytes]:
    """Canonical per-individual memo keys: the raw genome bytes."""
    mk = np.ascontiguousarray(np.asarray(masks, dtype=bool))
    ck = np.ascontiguousarray(np.asarray(cats, dtype=np.int64))
    return [mk[i].tobytes() + ck[i].tobytes() for i in range(mk.shape[0])]


@dataclasses.dataclass
class NSGA2Config:
    pop_size: int = 24
    n_generations: int = 12
    crossover_rate: float = 0.7  # paper §III-A
    mutation_rate: float = 0.02  # paper's "0.2%" operator scaled per-gene
    seed: int = 0
    memoize: bool = True  # cache objective vectors by genome bytes


# seed-population mask-density band: individuals draw their keep
# probability uniformly from this range, the whole useful spectrum
INIT_DENSITY = (0.12, 1.0)


@dataclasses.dataclass
class Genome:
    """Split genome: boolean mask genes + integer categorical genes."""

    masks: np.ndarray  # (P, n_mask_bits) bool
    cats: np.ndarray  # (P, n_cat) int, gene g in [0, cat_card[g])


class NSGA2:
    """Generic NSGA-II loop over a (bool-mask, categorical) genome."""

    def __init__(
        self,
        n_mask_bits: int,
        cat_cardinalities: Sequence[int],
        evaluate: Callable[[np.ndarray, np.ndarray], np.ndarray],
        cfg: NSGA2Config = NSGA2Config(),
    ):
        """``evaluate(masks, cats) -> (P, M) objectives`` (minimised).

        With ``cfg.memoize`` the callback must be deterministic per genome
        (derive any training seed from the genome itself, not the row
        position): the memo returns the first-seen objective vector for a
        repeated genome.
        """
        self.n_mask_bits = n_mask_bits
        self.cat_card = np.asarray(cat_cardinalities, dtype=np.int64)
        self.evaluate = evaluate
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self.history: list[dict] = []
        self._memo: dict[bytes, np.ndarray] = {}
        self.n_evaluations = 0  # rows actually sent to the evaluator
        self.n_memo_hits = 0
        self.pop: Genome | None = None
        self.objs: np.ndarray | None = None
        self.rank: np.ndarray | None = None
        self.crowd: np.ndarray | None = None
        self.gen = 0

    @property
    def memo(self) -> dict[bytes, np.ndarray]:
        """The live genome-bytes -> objective cache, in insertion order."""
        return self._memo

    # -- memoized evaluation -------------------------------------------------
    def _evaluate(self, masks: np.ndarray, cats: np.ndarray) -> np.ndarray:
        """Evaluate a pool, training only genomes never seen before."""
        if not self.cfg.memoize:
            self.n_evaluations += masks.shape[0]
            return np.asarray(self.evaluate(masks, cats), dtype=np.float64)
        keys = genome_keys(masks, cats)
        plan = evalpipe.PoolPlan(keys=keys, train=evalpipe.plan_rows(self._memo, keys))
        objs = self.evaluate(*plan.take(masks, cats)) if plan.train else None
        evalpipe.commit_rows(self._memo, plan.train, objs)
        self.n_evaluations += len(plan.train)
        self.n_memo_hits += len(plan.keys) - len(plan.train)
        return evalpipe.gather_rows(plan.keys, self._memo)

    # -- initialisation ----------------------------------------------------
    def _init_population(self) -> Genome:
        P = self.cfg.pop_size
        # Spread the seed population across mask densities: the conventional
        # ADC (all-ones) anchors the accuracy end of the front while sparse
        # individuals anchor the area end.
        lo, hi = INIT_DENSITY
        probs = self.rng.uniform(lo, hi, size=(P, 1))
        masks = self.rng.uniform(size=(P, self.n_mask_bits)) < probs
        masks[0] = True  # chromosome 0 == conventional ADC baseline
        cats = np.stack(
            [self.rng.integers(0, c, size=P) for c in self.cat_card], axis=1
        ) if len(self.cat_card) else np.zeros((P, 0), np.int64)
        if cats.shape[1]:
            cats[0] = 0  # baseline defaults
        return Genome(masks, cats)

    # -- variation operators -----------------------------------------------
    def _make_children(self, pop: Genome, rank: np.ndarray, crowd: np.ndarray) -> Genome:
        """One whole child generation as a batch array program."""
        P = self.cfg.pop_size
        n_pairs = (P + 1) // 2
        cand = self.rng.integers(0, rank.shape[0], size=(2 * n_pairs, 2))
        parents = batch_tournament(rank, crowd, cand)
        a, b = parents[:n_pairs], parents[n_pairs:]

        do_cross = self.rng.uniform(size=n_pairs) < self.cfg.crossover_rate
        swap_m = self.rng.uniform(size=(n_pairs, self.n_mask_bits)) < 0.5
        ma, mb = uniform_crossover(pop.masks[a], pop.masks[b], do_cross, swap_m)
        ca, cb = pop.cats[a], pop.cats[b]
        if ca.shape[1]:
            swap_c = self.rng.uniform(size=ca.shape) < 0.5
            ca, cb = uniform_crossover(ca, cb, do_cross, swap_c)

        cm = np.concatenate([ma, mb])[:P]
        cc = np.concatenate([ca, cb])[:P]
        flips = self.rng.uniform(size=cm.shape) < self.cfg.mutation_rate
        cm = mutate_masks(cm, flips)
        if cc.shape[1]:
            resample = self.rng.uniform(size=cc.shape) < self.cfg.mutation_rate * 4
            new_vals = self.rng.integers(0, self.cat_card, size=cc.shape)
            cc = mutate_cats(cc, resample, new_vals)
        return Genome(cm, cc)

    # -- environmental selection -------------------------------------------
    @staticmethod
    def _select(objs: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Pick n survivors; returns (indices, rank, crowding)."""
        fronts = fast_non_dominated_sort(objs)
        chosen: list[int] = []
        rank = np.zeros(objs.shape[0], np.int64)
        crowd = np.zeros(objs.shape[0])
        for fi, front in enumerate(fronts):
            rank[front] = fi
            crowd[front] = crowding_distance(objs[front])
            if len(chosen) + front.size <= n:
                chosen.extend(front.tolist())
            else:
                need = n - len(chosen)
                order = front[np.argsort(-crowd[front], kind="stable")]
                chosen.extend(order[:need].tolist())
            if len(chosen) >= n:
                break
        idx = np.asarray(chosen[:n])
        return idx, rank[idx], crowd[idx]

    # -- main loop -----------------------------------------------------------

    def setup(self) -> None:
        """Draw and evaluate generation 0, establish rank/crowding."""
        pop = self._init_population()
        objs = np.asarray(self._evaluate(pop.masks, pop.cats), np.float64)
        idx, self.rank, self.crowd = self._select(objs, self.cfg.pop_size)
        self.pop = Genome(pop.masks[idx], pop.cats[idx])
        self.objs = objs[idx]
        self.gen = 0

    def step(self) -> dict:
        """Advance one generation; returns the telemetry record."""
        t_gen = time.perf_counter()
        evals_before, hits_before = self.n_evaluations, self.n_memo_hits
        kids = self._make_children(self.pop, self.rank, self.crowd)
        allm = np.concatenate([self.pop.masks, kids.masks])
        allc = np.concatenate([self.pop.cats, kids.cats])
        t_eval = time.perf_counter()
        # the full parent+child pool goes through the memo: survivors and
        # duplicate children cost nothing, only new genomes are trained
        allo = np.asarray(self._evaluate(allm, allc), np.float64)
        eval_s = time.perf_counter() - t_eval
        idx, rank, crowd = self._select(allo, self.cfg.pop_size)
        self.pop, self.objs = Genome(allm[idx], allc[idx]), allo[idx]
        self.rank, self.crowd = rank, crowd
        front0 = fast_non_dominated_sort(self.objs)[0]
        rec = {
            "gen": self.gen,
            "front_size": int(front0.size),
            "best_obj0": float(self.objs[:, 0].min()),
            "best_obj1": float(self.objs[:, 1].min()) if self.objs.shape[1] > 1 else None,
            "n_evals": int(self.n_evaluations - evals_before),
            "memo_hits": int(self.n_memo_hits - hits_before),
            "eval_s": round(eval_s, 4),
            "gen_s": round(time.perf_counter() - t_gen, 4),
        }
        self.history.append(rec)
        self.gen += 1
        return rec

    def result(self) -> dict:
        """Final Pareto front + telemetry of the current population."""
        front0 = fast_non_dominated_sort(self.objs)[0]
        return {
            "masks": self.pop.masks[front0],
            "cats": self.pop.cats[front0],
            "objs": self.objs[front0],
            "population": self.pop,
            "all_objs": self.objs,
            "history": self.history,
            "n_evaluations": self.n_evaluations,
            "n_memo_hits": self.n_memo_hits,
        }

    def run(self) -> dict:
        """Run the full loop: setup, then ``n_generations`` steps."""
        self.setup()
        for _ in range(self.cfg.n_generations):
            self.step()
        return self.result()
