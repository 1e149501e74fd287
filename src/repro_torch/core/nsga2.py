"""NSGA-II (Deb et al., 2002), the paper's multi-objective search (port of ``repro.core.nsga2``).

The reference's engine is NumPy only, so the port keeps its own copy, with
the same RNG draws in the same order: the same objectives give the same
fronts, memo contents and insertion order, counters, histories and
migration logs, bit for bit (``tests/test_torch_islands.py``,
``tests/test_torch_campaign.py``).

Population genetics run on the host as batch array programs: binary
tournament on (rank, crowding), uniform crossover, bit-flip and
categorical-resample mutation touch the whole population at once.
Objectives come from a callback, in the co-design the population QAT
evaluator on the card (``core.trainer``).

With ``NSGA2Config.memoize`` (default) objective vectors are cached under
the raw genome bytes: every generation the full parent+child pool goes
through the memo and only genomes never seen before are evaluated.  With
``memoize=False`` every pool is evaluated in full (the paper-style naive
flow).  ``history`` records per generation the front size, the best
objectives, the rows evaluated, the memo hits, and the evaluation and
generation wall-clock.

Begin/commit phase contract, which every driver below relies on:

* ``setup_begin`` / ``step_begin`` consume ALL of the generation's host
  RNG and return the pool to evaluate, so a driver may reorder *when*
  pools are evaluated without perturbing any stream;
* ``plan_pool`` / ``commit_pool`` are the two halves of the memoized
  ``_evaluate`` (``plan_unseen`` / ``commit_plan`` their pair spellings):
  planning reads the memo (plus an optional cross-island ``claimed`` set)
  and picks the first-seen rows; committing writes the memo in plan order
  and settles the counters.  Plan order == commit order == memo
  insertion order;
* ``setup_commit`` / ``step_commit`` run environmental selection and
  telemetry and are the only phases that mutate the population.

Any driver that calls begins, plans and commits in the same per-engine
order as the plain loop is the plain loop, bit for bit, however it
batches, stacks or overlaps the evaluations in between.  The async
drivers (``NSGA2.run_async``, ``IslandConfig.async_pipeline``) take a
``dispatch_evaluate`` callback that launches a batch and returns a
``resolve()``; on the card that is the evaluator's CUDA-event handshake
(``core.trainer``), so the host varies and plans island i+1 while island
i trains.

Island model (:class:`IslandNSGA2`): K engines with their own RNG streams
and ONE shared memo advance in lock-step, with ring migration of
top-crowding Pareto members every ``migration_interval`` generations.
Its sequential, stacked (one cross-island population call a generation,
``core.trainer.make_island_evaluator``) and async drivers give identical
results.  ``state_dict`` / ``set_state`` snapshot an engine or a driver
at a generation boundary (``runtime.elastic``, ``checkpoint``).

An optional screen stage (``screen=``, ``core.surrogate``) splits each
planned pool into rows to train and rows answered by a prediction, kept in
a deferred side table beside the memo and trained the next time they are
planned; the gradient/GA hybrid (``core.hybrid``) enters through
``seed_warm``, ``set_refiner`` and ``score_pool``.  With neither, every
driver is bit for bit the plain loop.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Sequence

import numpy as np

from repro_torch import spans
from repro_torch.core import evalpipe

# the spans of an engine's phases (``repro_torch.spans``): variation, the
# memo plan (and screen), the memo commit and selection
SPAN_VARIATION, SPAN_PLAN, SPAN_COMMIT = "ga.variation", "ga.plan", "ga.commit"

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
    "IslandConfig",
    "IslandNSGA2",
]


def _pack_memo(memo: dict[bytes, np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """Pack the genome->objective memo into two dense arrays.

    Keys are fixed-length (same genome shape), so the whole dict becomes
    ``keys (K, L) uint8`` + ``objs (K, M) float64`` in insertion order —
    the order :func:`_unpack_memo` rebuilds, which is what keeps a
    restored engine's memo insertion order identical to the uninterrupted
    run's (the bit-for-bit resume property rests on it).
    """
    if memo:
        keys = np.stack([np.frombuffer(k, dtype=np.uint8) for k in memo])
        objs = np.stack([np.asarray(v, np.float64) for v in memo.values()])
    else:
        keys = np.zeros((0, 0), np.uint8)
        objs = np.zeros((0, 0), np.float64)
    return keys, objs


def _unpack_memo(keys: np.ndarray, objs: np.ndarray) -> dict[bytes, np.ndarray]:
    """Inverse of :func:`_pack_memo`, preserving row (= insertion) order."""
    keys = np.asarray(keys, np.uint8)
    objs = np.asarray(objs, np.float64)
    return {keys[i].tobytes(): objs[i] for i in range(keys.shape[0])}


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
    # probability uniformly from this range.  The default spans the whole
    # useful spectrum; the island driver hands each island a contiguous
    # slice so the merged initial coverage matches one large population's
    # spread (stratified/heterogeneous islands)
    init_density: tuple[float, float] = (0.12, 1.0)


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
        memo: dict[bytes, np.ndarray] | None = None,
        memo_lock: "threading.RLock | None" = None,
        screen: "evalpipe.ScreenStage | None" = None,
    ):
        """``evaluate(masks, cats) -> (P, M) objectives`` (minimised).

        With ``cfg.memoize`` the callback must be deterministic per genome
        (derive any training seed from the genome itself, not the row
        position): the memo returns the first-seen objective vector for a
        repeated genome.

        ``memo`` pre-seeds the evaluation cache with genome-bytes ->
        objective entries from an earlier run (see ``core.memo_store`` for
        the persistence helpers); preloaded genomes count as memo hits and
        are never re-trained.  The caller owns key compatibility — entries
        must come from the same (dataset, evaluator config) or the cached
        objectives are silently wrong.

        ``memo_lock`` guards the memo dict and its counters: each of the
        plan/commit halves (:meth:`plan_unseen`, :meth:`commit_plan`) runs
        under it, and it is NEVER held across an evaluation, so engines
        driven from different threads against one aliased memo dict (the
        evaluation service) interleave at batch granularity without
        corrupting the dict or losing counter updates.  Drivers that alias
        one memo across engines must share ONE lock (``IslandNSGA2`` does;
        so must any caller passing the same ``memo`` dict object to
        several engines).  Defaults to a private re-entrant lock — free
        when uncontended, so single-threaded use is unchanged.

        ``screen`` plugs a ``core.evalpipe.ScreenStage`` into the plan
        half: planned rows the screen defers are answered with its
        predicted objectives (kept in a side table next to the memo,
        flagged, and force-trained on their next plan) instead of being
        evaluated.  ``None`` (default) keeps the exact screen-less pipeline —
        bit-for-bit, counters included.  Requires ``cfg.memoize``.
        """
        if screen is not None and not cfg.memoize:
            raise ValueError(
                "a screen stage needs the memo pipeline (its deferred "
                "side table rides next to the memo); set memoize=True"
            )
        self.n_mask_bits = n_mask_bits
        self.cat_card = np.asarray(cat_cardinalities, dtype=np.int64)
        self.evaluate = evaluate
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self.history: list[dict] = []
        self._memo: dict[bytes, np.ndarray] = dict(memo) if memo else {}
        self._memo_lock = memo_lock if memo_lock is not None else threading.RLock()
        # deferred side table: screen-predicted objectives for rows the
        # pipeline chose not to train (aliased across islands exactly
        # like the memo); empty whenever screen is None
        self._deferred: dict[bytes, np.ndarray] = {}
        self._screen = screen
        # gradient/GA hybrid hooks (core.hybrid): warm genomes spliced into
        # the setup pool (seed_warm) and an optional refinement operator
        # injected into step_begin (set_refiner).  Both default off, which
        # keeps the engine bit-for-bit the plain loop.
        self._warm: tuple[np.ndarray, np.ndarray] | None = None
        self._refine: Callable[
            [np.ndarray, np.ndarray], tuple[np.ndarray, np.ndarray]
        ] | None = None
        self._refine_every = 0
        self._refine_top_k = 0
        self.n_evaluations = 0  # rows actually sent to the evaluator
        self.n_memo_hits = 0
        self.n_deferred = 0  # rows answered by this engine's screen
        # live loop state, established by setup() and advanced by step()
        self.pop: Genome | None = None
        self.objs: np.ndarray | None = None
        self.rank: np.ndarray | None = None
        self.crowd: np.ndarray | None = None
        self.gen = 0
        # in-flight pool between a *_begin and its *_commit (lock-step mode)
        self._pending: tuple[np.ndarray, np.ndarray] | None = None
        self._t_gen = 0.0
        self._evals_before = 0
        self._hits_before = 0
        self._deferred_before = 0

    @property
    def memo(self) -> dict[bytes, np.ndarray]:
        """The live genome-bytes -> objective cache (persistable snapshot)."""
        return self._memo

    # -- memoized evaluation -------------------------------------------------
    def _evaluate(self, masks: np.ndarray, cats: np.ndarray) -> np.ndarray:
        """Evaluate a pool, training only genomes never seen before.

        The blocking schedule over the evaluation pipeline: plan (+
        screen) via :meth:`plan_pool`, dispatch the train rows through
        the synchronous callback, commit via :meth:`commit_pool` — the
        same stages every other driver (stacked, async, service wave)
        reorders but never re-implements.
        """
        if not self.cfg.memoize:
            self.n_evaluations += masks.shape[0]
            return np.asarray(self.evaluate(masks, cats), dtype=np.float64)
        plan = self.plan_pool(masks, cats)
        objs = None
        if plan.train:
            objs = self.evaluate(*plan.take(masks, cats))
        return self.commit_pool(plan, objs)

    # -- initialisation ----------------------------------------------------
    def _init_population(self) -> Genome:
        P = self.cfg.pop_size
        # Spread the seed population across mask densities: the conventional
        # ADC (all-ones) anchors the accuracy end of the front while sparse
        # individuals anchor the area end.
        lo, hi = self.cfg.init_density
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
    #
    # The loop is decomposed twice.  ``setup`` / ``step`` / ``result`` let
    # an outer driver (IslandNSGA2) interleave generations of several
    # engines and splice migrants in between steps.  ``setup`` and ``step``
    # are themselves each split into a ``*_begin`` phase (variation — all
    # host-side RNG consumption) and a ``*_commit`` phase (environmental
    # selection + telemetry), with the evaluation in between, so the
    # stacked island driver can gather every island's pool, dedupe the
    # unseen genomes across islands against the ONE shared memo, submit a
    # single cross-island batch, and only then commit each island.
    # ``run``/``step``/``setup`` are the exact compositions of their
    # phases — the RNG stream is consumed in the same order as the
    # original monolithic loop, so results are bit-for-bit unchanged.

    @spans.spanned(SPAN_VARIATION)
    def setup_begin(self) -> tuple[np.ndarray, np.ndarray]:
        """Draw the generation-0 pool; returns its (masks, cats)."""
        pop = self._init_population()
        if self._warm is not None:
            wm, wc = self._warm
            k = min(wm.shape[0], self.cfg.pop_size - 1)
            # rows 1..k: row 0 stays the conventional-ADC baseline.  The
            # displaced random rows were already drawn by _init_population,
            # so the host RNG stream — and every later variation draw — is
            # exactly the warm-less run's.
            if k > 0:
                pop.masks[1 : 1 + k] = wm[:k]
                pop.cats[1 : 1 + k] = wc[:k]
        self._pending = (pop.masks, pop.cats)
        return pop.masks, pop.cats

    @spans.spanned(SPAN_COMMIT)
    def setup_commit(self, objs: np.ndarray) -> None:
        """Select generation 0 from the evaluated seed pool."""
        masks, cats = self._pending
        self._pending = None
        objs = np.asarray(objs, np.float64)
        idx, rank, crowd = self._select(objs, self.cfg.pop_size)
        self.pop = Genome(masks[idx], cats[idx])
        self.objs = objs[idx]
        self.rank, self.crowd = rank, crowd
        self.gen = 0

    def setup(self) -> None:
        """Draw and evaluate generation 0, establish rank/crowding."""
        masks, cats = self.setup_begin()
        self.setup_commit(self._evaluate(masks, cats))

    @spans.spanned(SPAN_VARIATION)
    def step_begin(self) -> tuple[np.ndarray, np.ndarray]:
        """Variation phase: returns the parent+child pool to evaluate."""
        self._t_gen = time.perf_counter()
        self._evals_before = self.n_evaluations
        self._hits_before = self.n_memo_hits
        self._deferred_before = self.n_deferred
        kids = self._make_children(self.pop, self.rank, self.crowd)
        allm = np.concatenate([self.pop.masks, kids.masks])
        allc = np.concatenate([self.pop.cats, kids.cats])
        if (
            self._refine is not None
            and (self.gen + 1) % self._refine_every == 0
        ):
            # refinement wave: gradient-polish the top-crowding front-0
            # members (the emigrant pick — deterministic, no host RNG) and
            # append the results as extra children.  _select handles the
            # larger pool; the plan/dedupe path prices a refined child
            # equal to its parent (or to any resident) at zero rows.
            em, ec, _ = self.emigrants(self._refine_top_k)
            rm, rc = self._refine(em, ec)
            allm = np.concatenate([allm, np.asarray(rm, bool)])
            allc = np.concatenate([allc, np.asarray(rc, np.int64)])
        self._pending = (allm, allc)
        return allm, allc

    @spans.spanned(SPAN_COMMIT)
    def step_commit(self, allo: np.ndarray, eval_s: float) -> dict:
        """Selection + telemetry on the evaluated pool from step_begin."""
        allm, allc = self._pending
        self._pending = None
        allo = np.asarray(allo, np.float64)
        idx, rank, crowd = self._select(allo, self.cfg.pop_size)
        self.pop, self.objs = Genome(allm[idx], allc[idx]), allo[idx]
        self.rank, self.crowd = rank, crowd
        front0 = fast_non_dominated_sort(self.objs)[0]
        rec = {
            "gen": self.gen,
            "front_size": int(front0.size),
            "best_obj0": float(self.objs[:, 0].min()),
            "best_obj1": float(self.objs[:, 1].min()) if self.objs.shape[1] > 1 else None,
            "n_evals": int(self.n_evaluations - self._evals_before),
            "memo_hits": int(self.n_memo_hits - self._hits_before),
            "deferred": int(self.n_deferred - self._deferred_before),
            "eval_s": round(eval_s, 4),
            "gen_s": round(time.perf_counter() - self._t_gen, 4),
        }
        self.history.append(rec)
        self.gen += 1
        return rec

    def step(self) -> dict:
        """Advance one generation; returns the telemetry record."""
        allm, allc = self.step_begin()
        t_eval = time.perf_counter()
        # the full parent+child pool goes through the memo: survivors and
        # duplicate children cost nothing, only new genomes are trained
        allo = self._evaluate(allm, allc)
        return self.step_commit(allo, time.perf_counter() - t_eval)

    # -- the pipeline halves (every driver schedules over these) -------------

    def _screen_final(self) -> bool:
        """Is the pool being planned the search's LAST evaluation?

        The screen trains everything in the final generation so the
        reported front is built from exact objectives only (the honesty
        contract in ``core.evalpipe``).
        """
        if self.pop is None:  # setup pool: final only for a 0-generation run
            return self.cfg.n_generations <= 0
        return self.gen >= self.cfg.n_generations - 1

    @spans.spanned(SPAN_PLAN)
    def plan_pool(
        self,
        masks: np.ndarray,
        cats: np.ndarray,
        claimed: set[bytes] | None = None,
        force_train: "frozenset[bytes] | None" = None,
    ) -> "evalpipe.PoolPlan":
        """Plan (+ screen) one pool: the pipeline's first two stages.

        The dedupe walk (``evalpipe.plan_rows``) picks the first-seen
        rows that are neither in the memo nor in ``claimed`` — keys
        another island owns this generation because it planned first;
        the claimed set is what preserves the sequential loop's
        guarantee that a child genome born on two islands in the same
        generation trains exactly once.  The screen stage (when
        configured) then splits those rows into train-now and deferred,
        parking the deferred predictions in the shared side table so any
        pool gathering them later — this island's commit or another
        island's — answers consistently.

        The whole plan runs under the engine's memo lock: a concurrent
        commit from another thread can land before or after this plan,
        but never interleave with the key walk — so a planned-unseen row
        is unseen w.r.t. one consistent memo state.

        ``force_train`` keys (hybrid warm-start rows — exactness is their
        whole point) are added to the screen's ``must_train`` set, so the
        honesty contract in ``evalpipe.resolve_decision`` guarantees they
        are never answered by a surrogate prediction.
        """
        keys = genome_keys(masks, cats)
        with self._memo_lock:
            unseen = evalpipe.plan_rows(self._memo, keys, claimed)
            if self._screen is None or not unseen:
                return evalpipe.PoolPlan(keys=keys, train=unseen)
            must = frozenset(k for k in unseen if k in self._deferred)
            if force_train is not None:
                must = must | frozenset(k for k in unseen if k in force_train)
            ctx = evalpipe.ScreenContext(
                masks=masks,
                cats=cats,
                keys=keys,
                unseen=dict(unseen),
                memo=self._memo,
                must_train=must,
                final=self._screen_final(),
            )
            decision = evalpipe.resolve_decision(ctx, self._screen(ctx))
            self._deferred.update(decision.deferred)
            return evalpipe.PoolPlan(
                keys=keys,
                train=decision.train,
                deferred={k: unseen[k] for k in decision.deferred},
                screen_info=decision.telemetry,
            )

    @spans.spanned(SPAN_COMMIT)
    def commit_pool(
        self, plan: "evalpipe.PoolPlan", objs: np.ndarray | None
    ) -> np.ndarray:
        """Commit one pool: memo writes, counters, full-pool gather.

        ``objs`` rows correspond 1:1 (in order) to ``plan.train`` keys;
        it may be ``None`` when the plan had nothing to train.  Counter
        semantics are identical to the sequential ``_evaluate``: rows
        this island owns and trains count as evaluations, rows its
        screen deferred count as ``n_deferred``, everything else in the
        pool — memo entries, keys claimed by earlier islands, and other
        pools' deferred rows — as memo hits.

        Memo writes, counter updates, and the full-pool gather all
        happen under the memo lock, so commits racing from two request
        threads each settle atomically (no lost counter increments, no
        partially-written batch visible to a concurrent plan).
        """
        with self._memo_lock:
            evalpipe.commit_rows(self._memo, plan.train, objs, self._deferred)
            self.n_evaluations += len(plan.train)
            self.n_deferred += len(plan.deferred)
            self.n_memo_hits += (
                len(plan.keys) - len(plan.train) - len(plan.deferred)
            )
            return evalpipe.gather_rows(plan.keys, self._memo, self._deferred)

    # -- compatibility spellings of the two halves (screen-less) -------------

    def plan_unseen(
        self,
        masks: np.ndarray,
        cats: np.ndarray,
        claimed: set[bytes] | None = None,
    ) -> tuple[list[bytes], dict[bytes, int]]:
        """The screen-less plan half as a ``(keys, unseen)`` pair."""
        keys = genome_keys(masks, cats)
        with self._memo_lock:
            unseen = evalpipe.plan_rows(self._memo, keys, claimed)
        return keys, unseen

    def commit_plan(
        self,
        keys: list[bytes],
        unseen: dict[bytes, int],
        objs: np.ndarray | None,
    ) -> np.ndarray:
        """The screen-less commit half (see :meth:`commit_pool`)."""
        return self.commit_pool(
            evalpipe.PoolPlan(keys=keys, train=dict(unseen)), objs
        )

    # -- async dispatch (pipelined drivers) ----------------------------------

    def dispatch_pool(
        self,
        masks: np.ndarray,
        cats: np.ndarray,
        dispatch_evaluate: Callable[
            [np.ndarray, np.ndarray], Callable[[], np.ndarray]
        ],
        claimed: set[bytes] | None = None,
    ) -> Callable[[], np.ndarray]:
        """Plan + launch a pool's evaluation without blocking on it.

        The non-blocking twin of :meth:`_evaluate`: planning (memo reads,
        optional cross-island ``claimed`` dedupe) happens NOW, the device
        program for the unseen rows is dispatched NOW via
        ``dispatch_evaluate`` — which must launch and return a zero-arg
        ``resolve()`` instead of waiting — and everything with a data
        dependency on the results (memo writes, counters) is deferred
        into the returned closure.  Calling the closure blocks until the
        objectives are ready and returns the full-pool ``(P, M)`` matrix,
        exactly what ``_evaluate`` would have returned.  ``claimed`` is
        updated in place at plan time, so a driver can dispatch several
        engines' pools back to back before resolving any of them.
        """
        if not self.cfg.memoize:
            n = int(masks.shape[0])
            resolve_rows = dispatch_evaluate(masks, cats)

            def resolve_naive() -> np.ndarray:
                self.n_evaluations += n
                return np.asarray(resolve_rows(), dtype=np.float64)

            return resolve_naive
        with self._memo_lock:
            # plan + claim atomically: a driver dispatching several engines'
            # pools from different threads must not let two pools claim the
            # same first-seen genome between the plan and the claimed update
            plan = self.plan_pool(masks, cats, claimed)
            if claimed is not None:
                claimed.update(plan.first_seen)
        resolve_rows = None
        if plan.train:
            resolve_rows = dispatch_evaluate(*plan.take(masks, cats))

        def resolve() -> np.ndarray:
            objs = resolve_rows() if resolve_rows is not None else None
            return self.commit_pool(plan, objs)

        return resolve

    def run_async(
        self,
        dispatch_evaluate: Callable[
            [np.ndarray, np.ndarray], Callable[[], np.ndarray]
        ],
        checkpoint_hook: Callable | None = None,
    ) -> dict:
        """The async-dispatch single-population driver.

        Structurally :meth:`run` with ``_evaluate`` split into dispatch
        (non-blocking launch) and resolve (block at commit time): the
        host-side tail of the objective — whatever ``dispatch_evaluate``
        computes after launching the device program, e.g. the codesign
        area pass — overlaps the device compute instead of serialising
        behind it.  A single population has no other host work to hide
        (generation g+1's variation needs generation g's selection), so
        the begin → dispatch → resolve → commit order — and therefore the
        result, bit for bit — is exactly the synchronous loop's; the
        cross-engine overlap lives in :meth:`IslandNSGA2._run_async`.
        """
        if self.pop is None:
            masks, cats = self.setup_begin()
            self.setup_commit(
                self.dispatch_pool(masks, cats, dispatch_evaluate)()
            )
            if checkpoint_hook is not None:
                checkpoint_hook(self, 0)
        for _ in range(self.gen, self.cfg.n_generations):
            allm, allc = self.step_begin()
            t_eval = time.perf_counter()
            resolve = self.dispatch_pool(allm, allc, dispatch_evaluate)
            allo = resolve()
            self.step_commit(allo, time.perf_counter() - t_eval)
            if checkpoint_hook is not None:
                checkpoint_hook(self, self.gen)
        return self.result()

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
            "n_deferred": self.n_deferred,
        }

    def run(self, checkpoint_hook: Callable | None = None) -> dict:
        """Run (or resume) the full loop.

        ``checkpoint_hook(engine, gens_done)`` fires at every generation
        boundary — after setup (``gens_done=0``) and after each completed
        generation — the only points where :meth:`state_dict` is legal.
        On an engine restored mid-campaign (``pop`` established, ``gen`` >
        0) the loop continues from the recorded generation instead of
        re-running setup; a fresh engine is bit-for-bit the original loop.
        """
        if self.pop is None:
            self.setup()
            if checkpoint_hook is not None:
                checkpoint_hook(self, 0)
        for _ in range(self.gen, self.cfg.n_generations):
            self.step()
            if checkpoint_hook is not None:
                checkpoint_hook(self, self.gen)
        return self.result()

    # -- state snapshot / restore (fault tolerance) ---------------------------

    @property
    def gens_done(self) -> int:
        """Completed generations (0 right after setup)."""
        return self.gen

    def state_dict(self, include_memo: bool = True) -> dict:
        """Snapshot the engine at a generation boundary.

        Returns ``{"arrays": {...}, "meta": {...}}`` — arrays are the
        checkpointable pytree (population genome, objectives, rank,
        crowding, optionally the packed memo), meta is JSON-able (RNG
        bit-generator state, history, counters).  Only legal at the
        begin/commit phase boundary: an in-flight pool between a
        ``*_begin`` and its ``*_commit`` cannot be represented, so the
        snapshot refuses rather than silently dropping it.  The restored
        engine (:meth:`set_state`) continues bit-for-bit: the RNG stream
        resumes mid-sequence and the memo keeps its insertion order.
        """
        if self._pending is not None:
            raise RuntimeError(
                "state_dict() between a *_begin and its *_commit: the "
                "in-flight pool is not checkpointable; snapshot only at "
                "generation boundaries"
            )
        arrays: dict[str, np.ndarray] = {}
        if self.pop is not None:
            arrays = {
                "masks": self.pop.masks.copy(),
                "cats": self.pop.cats.copy(),
                "objs": self.objs.copy(),
                "rank": self.rank.copy(),
                "crowd": self.crowd.copy(),
            }
        if include_memo and self.cfg.memoize:
            arrays["memo_keys"], arrays["memo_objs"] = _pack_memo(self._memo)
            if self._deferred:
                # the deferred side table rides with the memo so a cold
                # restore of a screened search keeps its must-train flags
                # (absent for screen-less runs: old checkpoints stay valid)
                arrays["deferred_keys"], arrays["deferred_objs"] = _pack_memo(
                    self._deferred
                )
        meta = {
            "initialized": self.pop is not None,
            "gen": int(self.gen),
            "rng_state": self.rng.bit_generator.state,
            "history": [dict(r) for r in self.history],
            "n_evaluations": int(self.n_evaluations),
            "n_memo_hits": int(self.n_memo_hits),
            "n_deferred": int(self.n_deferred),
        }
        return {"arrays": arrays, "meta": meta}

    def set_state(self, state: dict, keep_memo: bool = False) -> None:
        """Restore a :meth:`state_dict` snapshot (post-JSON-round-trip OK).

        ``keep_memo=True`` leaves the live memo untouched — the in-process
        device-loss rollback path: memo entries are pure functions of the
        genome, so results committed after the snapshot stay valid and
        replaying the interrupted generation hits them instead of
        re-training (zero duplicate rows).  The default replaces the memo
        with the snapshot's copy (the cold-restore path); either way the
        dict is mutated in place so island aliases keep seeing it.
        """
        arrays, meta = state["arrays"], state["meta"]
        if meta["initialized"]:
            masks = np.asarray(arrays["masks"], bool)
            if masks.shape[1] != self.n_mask_bits:
                raise ValueError(
                    f"snapshot has {masks.shape[1]} mask bits, engine "
                    f"expects {self.n_mask_bits}: wrong search config"
                )
            self.pop = Genome(
                masks.copy(), np.asarray(arrays["cats"], np.int64).copy()
            )
            self.objs = np.asarray(arrays["objs"], np.float64).copy()
            self.rank = np.asarray(arrays["rank"], np.int64).copy()
            self.crowd = np.asarray(arrays["crowd"], np.float64).copy()
        else:
            self.pop = self.objs = self.rank = self.crowd = None
        self.gen = int(meta["gen"])
        rng = np.random.default_rng()
        rng.bit_generator.state = meta["rng_state"]
        self.rng = rng
        self.history = [dict(r) for r in meta["history"]]
        self.n_evaluations = int(meta["n_evaluations"])
        self.n_memo_hits = int(meta["n_memo_hits"])
        self.n_deferred = int(meta.get("n_deferred", 0))
        self._pending = None
        if not keep_memo:
            self._memo.clear()
            if "memo_keys" in arrays:
                self._memo.update(
                    _unpack_memo(arrays["memo_keys"], arrays["memo_objs"])
                )
            self._deferred.clear()
            if "deferred_keys" in arrays:
                self._deferred.update(
                    _unpack_memo(arrays["deferred_keys"], arrays["deferred_objs"])
                )

    # -- gradient/GA hybrid hooks (core.hybrid) -------------------------------

    def seed_warm(self, masks: np.ndarray, cats: np.ndarray) -> int:
        """Seed the generation-0 population with warm-start genomes.

        Rows ``1..k`` of the setup pool (row 0 stays the conventional-ADC
        baseline) are replaced by the first ``k = min(len(masks),
        pop_size - 1)`` genomes; the displaced random rows are still
        *drawn* by ``_init_population``, so the host RNG stream — and
        therefore every later variation draw — is bit-for-bit the
        warm-less run's.  Only legal before setup (warm genomes shape the
        initial population, nothing else).  Returns ``k``.
        """
        if self.pop is not None:
            raise RuntimeError(
                "seed_warm() after setup: warm genomes only shape the "
                "initial population"
            )
        masks = np.asarray(masks, bool)
        cats = np.asarray(cats, np.int64)
        k = min(masks.shape[0], self.cfg.pop_size - 1)
        self._warm = (masks[:k].copy(), cats[:k].copy())
        return k

    def set_refiner(
        self,
        refine: Callable[[np.ndarray, np.ndarray], tuple[np.ndarray, np.ndarray]],
        every: int,
        top_k: int = 4,
    ) -> None:
        """Install the gradient refinement operator.

        Every ``every`` generations, ``refine(masks, cats) -> (masks,
        cats)`` runs on the ``top_k`` top-crowding front-0 members (the
        :meth:`emigrants` pick — deterministic, no host RNG) and its
        outputs join the parent+child pool as extra children.  ``refine``
        MUST NOT consume host RNG (derive any stochasticity from the
        genomes themselves) or the bit-for-bit variation stream breaks.
        ``every <= 0`` disables the operator — the engine is then
        bit-for-bit the plain loop.
        """
        self._refine = refine if every > 0 else None
        self._refine_every = max(int(every), 0)
        self._refine_top_k = int(top_k)

    def score_pool(self, masks: np.ndarray, cats: np.ndarray) -> np.ndarray:
        """Exactly score out-of-band genomes through the standard pipeline.

        The entry point for hybrid warm-start rows: the pool flows
        through the same :meth:`plan_pool` / :meth:`commit_pool` halves
        as a generation pool — memo keys, insertion order, and counter
        semantics follow the standard contract, so later generations see
        these rows as ordinary memo hits — but every unseen row is
        force-trained past the screen (warm genomes must be exact, never
        surrogate-predicted).  Returns the full-pool objective matrix.
        """
        if not self.cfg.memoize:
            raise ValueError(
                "score_pool needs the memo pipeline (its results must be "
                "memo hits for the upcoming generations); set memoize=True"
            )
        masks = np.asarray(masks, bool)
        cats = np.asarray(cats, np.int64)
        plan = self.plan_pool(
            masks, cats, force_train=frozenset(genome_keys(masks, cats))
        )
        objs = None
        if plan.train:
            objs = self.evaluate(*plan.take(masks, cats))
        return self.commit_pool(plan, objs)

    # -- island-model migration hooks ----------------------------------------

    def emigrants(self, k: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The ``k`` top-crowding-distance Pareto-front members.

        Crowding is recomputed within front 0 so the pick favours spread
        along the front (boundary members carry infinite distance and
        always travel first).  Returns copies of (masks, cats, objs) — the
        emigrants also stay in the source population (pollination, not
        displacement, the standard island-model choice).
        """
        front0 = fast_non_dominated_sort(self.objs)[0]
        crowd = crowding_distance(self.objs[front0])
        sel = front0[np.argsort(-crowd, kind="stable")][:k]
        return (
            self.pop.masks[sel].copy(),
            self.pop.cats[sel].copy(),
            self.objs[sel].copy(),
        )

    def immigrate(
        self, masks: np.ndarray, cats: np.ndarray, objs: np.ndarray
    ) -> int:
        """Splice migrants into the population; returns how many landed.

        Migrants whose genome bytes already exist in the resident
        population (or earlier in the same migrant batch) are dropped —
        the same canonical keys the evaluation memo uses, so a duplicate
        can neither crowd the island nor re-enter training.  Survivors of
        the dedupe replace the residents worst under (rank asc, crowding
        desc); rank/crowding are then recomputed so the next tournament
        sees the merged population.  Objectives ride along with the
        migrants (they were evaluated on the source island), so no
        evaluator call happens here even with ``memoize=False``.
        """
        have = set(genome_keys(self.pop.masks, self.pop.cats))
        keep: list[int] = []
        for i, key in enumerate(genome_keys(masks, cats)):
            if key not in have:
                keep.append(i)
                have.add(key)
        if not keep:
            return 0
        # a migrant batch larger than the island itself (tiny islands, or a
        # caller-assembled batch) can at most replace the whole population:
        # clamp to pop_size, first-come priority matching the dedupe order
        kept = np.asarray(keep, dtype=np.int64)[: self.cfg.pop_size]
        best_first = np.lexsort((-self.crowd, self.rank))
        victims = best_first[::-1][: kept.size]
        self.pop.masks[victims] = masks[kept]
        self.pop.cats[victims] = cats[kept]
        self.objs[victims] = np.asarray(objs, np.float64)[kept]
        idx, rank, crowd = self._select(self.objs, self.cfg.pop_size)
        self.pop = Genome(self.pop.masks[idx], self.pop.cats[idx])
        self.objs = self.objs[idx]
        self.rank, self.crowd = rank, crowd
        return int(kept.size)


# ---------------------------------------------------------------------------
# Island model: K independent NSGA2 engines + periodic Pareto migration.
# ---------------------------------------------------------------------------

# Seed stride between islands: island i runs on cfg.seed + i * stride, so
# island 0 consumes the exact same RNG stream as a plain NSGA2(cfg) — that
# is what makes num_islands=1 bit-for-bit equal to the single-population
# engine.  A large prime keeps nearby base seeds from colliding streams.
ISLAND_SEED_STRIDE = 1_000_003

TOPOLOGIES = ("ring", "none")


@dataclasses.dataclass(frozen=True)
class IslandConfig:
    """Island-model knobs layered on top of one shared ``NSGA2Config``.

    ``num_islands`` sub-populations (each of ``NSGA2Config.pop_size``
    chromosomes — budgets are per island) advance in lock-step; every
    ``migration_interval`` generations each island's ``migration_size``
    top-crowding Pareto members are copied to its neighbour.  Topologies:
    ``"ring"`` (island i sends to (i+1) % K, the paper-lineage default) or
    ``"none"`` (fully independent islands — the diversity baseline).
    """

    num_islands: int = 4
    migration_interval: int = 3
    migration_size: int = 2
    topology: str = "ring"
    # stacked=True evaluates all K islands' unseen genomes as ONE
    # cross-island population call per generation (lock-step driver) instead of
    # stepping the islands sequentially; requires NSGA2Config.memoize.
    # Results are bit-for-bit identical to the sequential loop — which
    # stays the reference implementation and single-device fallback.
    stacked: bool = False
    # async_pipeline=True overlaps host-side variation with device-side
    # evaluation: island i's unseen batch is dispatched as a non-blocking
    # device program and island i+1's variation/planning runs while it
    # evaluates; the host blocks (the resolve's CUDA event) only at commit
    # time.  Requires NSGA2Config.memoize (same cross-island claimed-set
    # dedupe as stacked) and is mutually exclusive with stacked: stacked
    # fills the device with one wave, async hides host latency behind
    # in-flight per-island programs — two answers to device idleness that
    # cannot both govern when a wave is submitted.  Results are bit-for-bit
    # identical to the sequential reference either way.
    async_pipeline: bool = False
    # stratify_init hands each island a contiguous slice of the seed
    # mask-density band instead of the full spectrum (heterogeneous
    # islands).  Off by default: measured on the co-design workload the
    # full-band seed + migration explores better than hard density
    # niching (benchmarks/ga_runtime.run_islands sweeps both)
    stratify_init: bool = False

    def __post_init__(self):
        if self.num_islands < 1:
            raise ValueError(f"num_islands must be >= 1, got {self.num_islands}")
        if self.migration_interval < 1:
            raise ValueError(
                f"migration_interval must be >= 1, got {self.migration_interval}"
            )
        if self.migration_size < 0:
            raise ValueError(f"migration_size must be >= 0, got {self.migration_size}")
        if self.topology not in TOPOLOGIES:
            raise ValueError(
                f"unknown topology {self.topology!r}; choose from {TOPOLOGIES}"
            )
        if self.stacked and self.async_pipeline:
            raise ValueError(
                "stacked and async_pipeline are mutually exclusive drivers: "
                "stacked submits one cross-island wave per generation, "
                "async_pipeline keeps per-island programs in flight"
            )


class IslandNSGA2:
    """Island-model NSGA-II: K engines, ring migration, ONE shared memo.

    Each island is a plain :class:`NSGA2` seeded ``cfg.seed + i *
    ISLAND_SEED_STRIDE`` so the streams are independent but reproducible.
    When ``cfg.memoize`` is set every island aliases the same genome-bytes
    -> objective dict: a chromosome trained anywhere is free everywhere —
    in particular a migrant arrives as a pure memo hit on its destination
    island (zero QAT rows), and the merged memo is what
    ``core.memo_store`` persists.

    Three drivers share the same migration machinery.  The sequential
    reference (``IslandConfig.stacked=False``) steps islands one after
    another through the population evaluator.  The stacked driver
    (``stacked=True``) runs every island's variation phase, dedupes the
    unseen genomes ACROSS islands against the shared memo (island order —
    the same order the sequential loop trains them in), and submits one
    cross-island batch per generation through ``stacked_evaluate``
    (``core.trainer.make_island_evaluator`` trains it as one population
    call).
    The async pipeline driver (``async_pipeline=True``) keeps per-island
    programs but launches each without blocking via ``dispatch_evaluate``
    and overlaps the next island's host-side variation/planning with the
    in-flight device work, blocking only at commit time
    (:meth:`_run_async`).  All three drivers produce bit-for-bit
    identical results — RNG streams, memo contents and insertion order,
    per-island counters, merged front.

    ``run()`` returns the merged, genome-deduplicated Pareto front over
    the final island populations (symmetric with the single-population
    ``NSGA2.run`` front — see :meth:`_merged_result`), per-island
    ``history`` lists, an aggregated per-generation ``history``, and the
    migration log.
    """

    def __init__(
        self,
        n_mask_bits: int,
        cat_cardinalities: Sequence[int],
        evaluate: Callable[[np.ndarray, np.ndarray], np.ndarray],
        cfg: NSGA2Config = NSGA2Config(),
        island_cfg: IslandConfig = IslandConfig(),
        memo: dict[bytes, np.ndarray] | None = None,
        stacked_evaluate: Callable[
            [list[tuple[np.ndarray, np.ndarray]]], list[np.ndarray | None]
        ]
        | None = None,
        dispatch_evaluate: Callable[
            [np.ndarray, np.ndarray], Callable[[], np.ndarray]
        ]
        | None = None,
        screen: "evalpipe.ScreenStage | None" = None,
    ):
        """``stacked_evaluate`` (used when ``island_cfg.stacked``) receives
        the per-island unseen-genome batches — a list of ``num_islands``
        ``(masks, cats)`` tuples, some possibly zero-row — and returns one
        ``(B_i, M)`` objective array per island (anything falsy for empty
        batches).  ``core.trainer.make_island_evaluator`` is the device
        implementation; when omitted, a per-island loop fallback keeps the
        lock-step semantics without a stacked program (analytic tests).

        ``dispatch_evaluate`` (used when ``island_cfg.async_pipeline``)
        receives ONE island's unseen ``(masks, cats)`` batch, launches its
        device program without blocking, and returns a zero-arg
        ``resolve()`` yielding the ``(B, M)`` objectives
        (``core.codesign`` builds it over the population evaluator's
        ``.dispatch`` hook).  When omitted, an eager fallback evaluates at
        dispatch time — same results in the same order, zero overlap
        (analytic tests).

        ``screen`` is ONE shared ``core.evalpipe.ScreenStage`` instance
        plugged into every island's plan half (a surrogate fitted on the
        shared memo screens for all islands); its deferred side table is
        aliased across islands exactly like the memo.  Requires
        ``cfg.memoize``.
        """
        if screen is not None and not cfg.memoize:
            raise ValueError(
                "a screen stage needs the shared memo pipeline; set "
                "NSGA2Config.memoize=True"
            )
        if island_cfg.stacked and not cfg.memoize:
            raise ValueError(
                "stacked island evaluation needs the shared memo for its "
                "cross-island dedupe; set NSGA2Config.memoize=True"
            )
        if island_cfg.async_pipeline and not cfg.memoize:
            raise ValueError(
                "async generation pipelining needs the shared memo for its "
                "cross-island dedupe; set NSGA2Config.memoize=True"
            )
        self.cfg = cfg
        self.island_cfg = island_cfg
        self._memo: dict[bytes, np.ndarray] = dict(memo) if memo else {}
        # ONE lock for the ONE shared memo: every island's plan/commit
        # halves serialise on it, so the aliased dict stays coherent even
        # when an outer driver steps islands from several threads
        self._memo_lock = threading.RLock()
        # ONE deferred side table next to the ONE memo: an island
        # gathering a key another island's screen deferred this wave
        # answers from here (counts as a memo hit — it cost no training)
        self._deferred: dict[bytes, np.ndarray] = {}
        self._screen = screen
        self.islands: list[NSGA2] = []
        K = island_cfg.num_islands
        lo, hi = cfg.init_density
        for i in range(K):
            # optional stratified initialization: island i seeds its
            # population in the i-th contiguous slice of the mask-density
            # band (heterogeneous islands).  K=1 or stratify_init=False
            # keeps the full band — bit-for-bit the single engine's init.
            if island_cfg.stratify_init:
                band = (lo + (hi - lo) * i / K, lo + (hi - lo) * (i + 1) / K)
            else:
                band = (lo, hi)
            isl = NSGA2(
                n_mask_bits,
                cat_cardinalities,
                evaluate,
                cfg=dataclasses.replace(
                    cfg,
                    seed=cfg.seed + i * ISLAND_SEED_STRIDE,
                    init_density=band,
                ),
            )
            if cfg.memoize:
                isl._memo = self._memo  # alias, not copy: one global cache
                isl._memo_lock = self._memo_lock  # aliased dict, shared lock
                isl._deferred = self._deferred  # one side table, like the memo
                isl._screen = screen  # one shared screen stage (may be None)
            self.islands.append(isl)
        self.migrations: list[dict] = []
        # aggregated per-generation telemetry — instance state (not a
        # driver-local list) so a restored driver resumes it mid-campaign
        self.agg_history: list[dict] = []
        if stacked_evaluate is not None:
            self._stacked_evaluate_fn = stacked_evaluate
        else:
            # fallback: same lock-step planning/commit, per-island batches
            # submitted one at a time through the row evaluator
            def _loop(batches):
                return [
                    np.asarray(evaluate(m, c), np.float64) if m.shape[0] else None
                    for m, c in batches
                ]

            self._stacked_evaluate_fn = _loop
        if dispatch_evaluate is not None:
            self._dispatch_fn = dispatch_evaluate
        else:
            # eager fallback: evaluate at dispatch time.  Dispatches happen
            # in island order — exactly the order the sequential loop
            # trains — so results are identical; only the overlap is lost.
            def _eager(m, c):
                objs = np.asarray(evaluate(m, c), np.float64)
                return lambda: objs

            self._dispatch_fn = _eager

    # -- aggregated telemetry (mirrors the NSGA2 attributes) ----------------
    @property
    def memo(self) -> dict[bytes, np.ndarray]:
        """The shared genome-bytes -> objective cache (persistable)."""
        return self._memo

    @property
    def n_evaluations(self) -> int:
        return sum(isl.n_evaluations for isl in self.islands)

    @property
    def n_memo_hits(self) -> int:
        return sum(isl.n_memo_hits for isl in self.islands)

    @property
    def n_deferred(self) -> int:
        return sum(isl.n_deferred for isl in self.islands)

    # -- state snapshot / restore (fault tolerance) ---------------------------

    @property
    def gens_done(self) -> int:
        """Completed generations (islands advance in lock-step)."""
        return self.islands[0].gen

    def state_dict(self, include_memo: bool = True) -> dict:
        """Snapshot all islands + migration log at a generation boundary.

        Island snapshots are packed memo-free (every island aliases the
        ONE shared dict — delegating naively would checkpoint it K times);
        the shared memo is packed exactly once at this level.  Same
        ``{"arrays", "meta"}`` split as :meth:`NSGA2.state_dict`.
        """
        arrays: dict = {}
        metas: list[dict] = []
        for i, isl in enumerate(self.islands):
            st = isl.state_dict(include_memo=False)
            arrays[f"island_{i:03d}"] = st["arrays"]
            metas.append(st["meta"])
        if include_memo and self.cfg.memoize:
            arrays["memo_keys"], arrays["memo_objs"] = _pack_memo(self._memo)
            if self._deferred:
                arrays["deferred_keys"], arrays["deferred_objs"] = _pack_memo(
                    self._deferred
                )
        meta = {
            "islands": metas,
            "migrations": [dict(m) for m in self.migrations],
            "agg_history": [dict(r) for r in self.agg_history],
        }
        return {"arrays": arrays, "meta": meta}

    def set_state(self, state: dict, keep_memo: bool = False) -> None:
        """Restore a :meth:`state_dict` snapshot onto this driver.

        ``keep_memo`` has the same rollback-vs-cold-restore semantics as
        :meth:`NSGA2.set_state`; the shared dict is mutated in place so
        every island's alias stays live.
        """
        arrays, meta = state["arrays"], state["meta"]
        metas = meta["islands"]
        if len(metas) != len(self.islands):
            raise ValueError(
                f"snapshot has {len(metas)} islands, driver has "
                f"{len(self.islands)}: wrong island config"
            )
        for i, (isl, m) in enumerate(zip(self.islands, metas)):
            isl.set_state(
                {"arrays": arrays.get(f"island_{i:03d}", {}), "meta": m},
                keep_memo=True,  # shared memo is restored once, below
            )
        self.migrations = [dict(m) for m in meta["migrations"]]
        self.agg_history = [dict(r) for r in meta["agg_history"]]
        if not keep_memo:
            self._memo.clear()
            if "memo_keys" in arrays:
                self._memo.update(
                    _unpack_memo(arrays["memo_keys"], arrays["memo_objs"])
                )
            self._deferred.clear()
            if "deferred_keys" in arrays:
                self._deferred.update(
                    _unpack_memo(arrays["deferred_keys"], arrays["deferred_objs"])
                )

    # -- migration -----------------------------------------------------------
    def _migrate(self, gen: int) -> None:
        k = self.island_cfg.migration_size
        K = len(self.islands)
        if self.island_cfg.topology != "ring" or K == 1 or k == 0:
            return
        # collect all outbound sets BEFORE any island mutates its
        # population, so a migrant cannot hop two islands in one wave
        outbound = [isl.emigrants(k) for isl in self.islands]
        accepted = []
        for src in range(K):
            dst = (src + 1) % K  # ring: island i pollinates island i+1
            masks, cats, objs = outbound[src]
            accepted.append(self.islands[dst].immigrate(masks, cats, objs))
        # "sent" records what each island ACTUALLY shipped — a front
        # smaller than migration_size sends fewer than requested
        self.migrations.append(
            {
                "gen": gen,
                "sent": [out[0].shape[0] for out in outbound],
                "accepted": accepted,
            }
        )

    # -- main loop -----------------------------------------------------------
    @staticmethod
    def _aggregate(gen: int, recs: list[dict]) -> dict:
        """Sum/min island telemetry records into one per-generation row."""
        return {
            "gen": gen,
            "front_size": sum(r["front_size"] for r in recs),
            "best_obj0": min(r["best_obj0"] for r in recs),
            "best_obj1": (
                min(r["best_obj1"] for r in recs)
                if recs[0]["best_obj1"] is not None
                else None
            ),
            "n_evals": sum(r["n_evals"] for r in recs),
            "memo_hits": sum(r["memo_hits"] for r in recs),
            "deferred": sum(r.get("deferred", 0) for r in recs),
            "eval_s": round(sum(r["eval_s"] for r in recs), 4),
            "gen_s": round(sum(r["gen_s"] for r in recs), 4),
        }

    def run(self, checkpoint_hook: Callable | None = None) -> dict:
        """Run (or resume) the configured driver.

        ``checkpoint_hook(driver, gens_done)`` fires at every generation
        boundary — after setup (``gens_done=0``) and after each completed
        generation's migration + aggregation — the only points where
        :meth:`state_dict` is legal.  A driver restored via
        :meth:`set_state` continues from the recorded generation; a fresh
        driver is bit-for-bit the original loop.
        """
        if self.island_cfg.async_pipeline:
            return self._run_async(checkpoint_hook)
        if self.island_cfg.stacked:
            return self._run_stacked(checkpoint_hook)
        return self._run_sequential(checkpoint_hook)

    def _run_sequential(self, checkpoint_hook: Callable | None = None) -> dict:
        """Reference driver: islands step one after another.

        Single-device fallback and the ground truth the stacked driver is
        tested bit-for-bit against.
        """
        icfg = self.island_cfg
        if self.islands[0].pop is None:
            for isl in self.islands:
                isl.setup()
            if checkpoint_hook is not None:
                checkpoint_hook(self, 0)
        for gen in range(self.gens_done, self.cfg.n_generations):
            recs = [isl.step() for isl in self.islands]
            if (gen + 1) % icfg.migration_interval == 0 and (
                gen + 1
            ) < self.cfg.n_generations:
                self._migrate(gen)
            self.agg_history.append(self._aggregate(gen, recs))
            if checkpoint_hook is not None:
                checkpoint_hook(self, gen + 1)
        out = self._merged_result()
        out["history"] = self.agg_history
        return out

    def _run_stacked(self, checkpoint_hook: Callable | None = None) -> dict:
        """Lock-step driver: ONE cross-island evaluation per generation.

        Every island runs its variation phase first, then the driver plans
        the unseen genomes of all K pools against the shared memo (in
        island order, so a genome born on two islands this generation is
        owned by the lower-indexed one — exactly the order the sequential
        loop trains it in), submits a single stacked batch, and commits
        each island.  RNG streams, memo contents/insertion order, counters
        and the merged front are bit-for-bit the sequential driver's.
        """
        icfg = self.island_cfg
        if self.islands[0].pop is None:
            pools = [isl.setup_begin() for isl in self.islands]
            allos, _ = self._evaluate_stacked(pools)
            for isl, allo in zip(self.islands, allos):
                isl.setup_commit(allo)
            if checkpoint_hook is not None:
                checkpoint_hook(self, 0)
        for gen in range(self.gens_done, self.cfg.n_generations):
            t_wave = time.perf_counter()
            pools = [isl.step_begin() for isl in self.islands]
            allos, eval_s = self._evaluate_stacked(pools)
            # the K islands share ONE stacked program: attribute an equal
            # share to each so aggregated eval_s sums to the true wall time
            share = eval_s / len(self.islands)
            recs = [
                isl.step_commit(allo, share)
                for isl, allo in zip(self.islands, allos)
            ]
            # same correction for gen_s: each island's _t_gen spans the
            # whole K-island wave (every begin phase, the shared program,
            # the earlier commits), so the raw per-island number is ~K x
            # the truth and their sum ~K^2 x.  Overwrite with an equal
            # share of the measured wave so the aggregated history's
            # gen_s — what run_islands compares drivers by — sums to the
            # actual generation wall clock, exactly like eval_s.
            wave_share = (time.perf_counter() - t_wave) / len(self.islands)
            for rec in recs:
                rec["gen_s"] = round(wave_share, 4)
            if (gen + 1) % icfg.migration_interval == 0 and (
                gen + 1
            ) < self.cfg.n_generations:
                self._migrate(gen)
            self.agg_history.append(self._aggregate(gen, recs))
            if checkpoint_hook is not None:
                checkpoint_hook(self, gen + 1)
        out = self._merged_result()
        out["history"] = self.agg_history
        return out

    def _run_async(self, checkpoint_hook: Callable | None = None) -> dict:
        """Pipelined driver: host variation overlaps device evaluation.

        Per generation, islands are walked in index order; each island
        runs its variation phase (host RNG) and memo planning, then its
        unseen batch is *launched* through ``dispatch_evaluate`` without
        waiting — so while the devices evaluate islands ``0..i``, the
        host is already varying and planning island ``i+1``.  Commits
        then run in island order, each blocking only until its own batch
        is ready (the CUDA event inside the resolve closure).

        Bit-for-bit identity with the sequential reference holds by the
        begin/commit contract (module docstring): per-island RNG streams
        are independent, so interleaving begins across islands changes no
        draws; planning walks islands in index order against the shared
        memo + the ``claimed`` set (a genome born on two islands this
        wave is owned by the lower-indexed one — the exact row the
        sequential loop trains); and commits run in the same island
        order, so memo contents, insertion order, and per-island counters
        all match.  Only *when the host blocks* moves.

        Telemetry: each island's ``eval_s`` is the time its commit
        actually spent blocked+settling (island 0 absorbs most of the
        wave; later islands resolve nearly free), so the aggregated
        ``eval_s`` sums to the host's true blocked time — the number the
        pipeline shrinks.  ``gen_s`` gets the same equal-share-of-wave
        correction as the stacked driver so the aggregated history sums
        to real wall clock.
        """
        icfg = self.island_cfg

        def dispatch_wave(begin):
            claimed: set[bytes] = set()
            pending = []
            for isl in self.islands:
                masks, cats = begin(isl)  # host variation, own RNG stream
                pending.append(
                    isl.dispatch_pool(masks, cats, self._dispatch_fn, claimed)
                )
            return pending

        if self.islands[0].pop is None:
            for isl, resolve in zip(
                self.islands, dispatch_wave(lambda isl: isl.setup_begin())
            ):
                isl.setup_commit(resolve())
            if checkpoint_hook is not None:
                checkpoint_hook(self, 0)
        for gen in range(self.gens_done, self.cfg.n_generations):
            t_wave = time.perf_counter()
            pending = dispatch_wave(lambda isl: isl.step_begin())
            recs = []
            for isl, resolve in zip(self.islands, pending):
                t0 = time.perf_counter()
                allo = resolve()  # blocks iff this batch is still in flight
                recs.append(isl.step_commit(allo, time.perf_counter() - t0))
            wave_share = (time.perf_counter() - t_wave) / len(self.islands)
            for rec in recs:
                rec["gen_s"] = round(wave_share, 4)
            if (gen + 1) % icfg.migration_interval == 0 and (
                gen + 1
            ) < self.cfg.n_generations:
                self._migrate(gen)
            self.agg_history.append(self._aggregate(gen, recs))
            if checkpoint_hook is not None:
                checkpoint_hook(self, gen + 1)
        out = self._merged_result()
        out["history"] = self.agg_history
        return out

    def _evaluate_stacked(
        self, pools: list[tuple[np.ndarray, np.ndarray]]
    ) -> tuple[list[np.ndarray], float]:
        """Plan → submit one stacked batch → commit, in island order.

        Returns each island's full-pool objective matrix plus the
        evaluation wall time.  Planning walks the islands in index order
        against the shared memo and a ``claimed`` set, so duplicate
        genomes across islands train once; commits happen in the same
        order, so memo insertion order matches the sequential loop's.
        """
        claimed: set[bytes] = set()
        plans: list[evalpipe.PoolPlan] = []
        for isl, (m, c) in zip(self.islands, pools):
            plan = isl.plan_pool(m, c, claimed)
            claimed.update(plan.first_seen)
            plans.append(plan)
        t0 = time.perf_counter()
        if any(plan.train for plan in plans):
            batches = [
                plan.take(m, c) for (m, c), plan in zip(pools, plans)
            ]
            objs = self._stacked_evaluate_fn(batches)
        else:
            objs = [None] * len(self.islands)
        eval_s = time.perf_counter() - t0
        allos = [
            isl.commit_pool(plan, o)
            for isl, plan, o in zip(self.islands, plans, objs)
        ]
        return allos, eval_s

    def _merged_result(self) -> dict:
        """Merged cross-island Pareto front + per-island telemetry.

        The merge is over the FINAL island populations only — symmetric
        with what ``NSGA2.run`` reports for a single population, which is
        what keeps the equal-budget hypervolume comparison in
        ``benchmarks/ga_runtime.run_islands`` honest.  (Fronting the whole
        shared memo instead would also fold in entries preloaded from a
        persisted store and grow the non-dominated sort quadratically
        with accumulated history.)
        """
        if len(self.islands) == 1:
            # identity wrapper: exactly the single-population result
            out = self.islands[0].result()
        else:
            allm = np.concatenate([isl.pop.masks for isl in self.islands])
            allc = np.concatenate([isl.pop.cats for isl in self.islands])
            allo = np.concatenate([isl.objs for isl in self.islands])
            # dedupe by genome bytes (first occurrence wins) so one genome
            # resident on several islands contributes one front point
            seen: set[bytes] = set()
            uniq: list[int] = []
            for i, key in enumerate(genome_keys(allm, allc)):
                if key not in seen:
                    seen.add(key)
                    uniq.append(i)
            ui = np.asarray(uniq, dtype=np.int64)
            allm, allc, allo = allm[ui], allc[ui], allo[ui]
            front0 = fast_non_dominated_sort(allo)[0]
            out = {
                "masks": allm[front0],
                "cats": allc[front0],
                "objs": allo[front0],
                "population": Genome(allm, allc),
                "all_objs": allo,
                "n_evaluations": self.n_evaluations,
                "n_memo_hits": self.n_memo_hits,
                "n_deferred": self.n_deferred,
            }
        out["island_history"] = [isl.history for isl in self.islands]
        out["migrations"] = self.migrations
        return out
