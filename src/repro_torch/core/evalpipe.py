"""The evaluation pipeline every search driver schedules over (port of ``repro.core.evalpipe``).

NumPy only, copied from the reference.  Four stages:

``plan``
    Walk one pool's genome keys against the memo (plus an optional
    cross-pool ``claimed`` set) and pick the first-seen rows
    (:func:`plan_rows`), under the memo's lock held by the caller.
``screen``
    An optional policy (:class:`ScreenStage`; ``core.surrogate`` is the
    real one) that splits the planned rows into *train now* and *defer*:
    deferred rows receive a predicted objective instead of a trained one.
    Off (``screen=None``) the stage is the identity and the pipeline is
    exactly plan + commit: same rows, same counters, same memo writes.
``dispatch``
    The driver's: blocking, async, or stacked across islands.  The
    pipeline only says *which* rows train (:meth:`PoolPlan.take`).
``commit``
    Write the trained rows into the memo in plan order, settle the
    counters and gather the full pool, memo entries first, deferred
    predictions as fallback (:func:`commit_rows`, :func:`gather_rows`).

Plan order is commit order is memo insertion order.  The screen's honesty
contract (:func:`resolve_decision`): a screen only *splits* the planned
rows, never invents or drops one; a ``must_train`` key (its objective is a
prediction from an earlier plan) always trains; with ``final`` set (the
last generation) everything trains, so the reported front is exact; and
deferred objectives live in a side table next to the memo, never in it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Mapping

import numpy as np

__all__ = [
    "plan_rows",
    "gather_rows",
    "commit_rows",
    "PoolPlan",
    "ScreenContext",
    "ScreenDecision",
    "ScreenStage",
    "resolve_decision",
]


# ---------------------------------------------------------------------------
# plan stage
# ---------------------------------------------------------------------------

def plan_rows(
    table: Mapping[bytes, np.ndarray],
    keys: list[bytes],
    claimed: Iterable[bytes] | None = None,
) -> dict[bytes, int]:
    """The plan/dedupe half: first-seen rows of one pool.

    Returns ``key -> row index`` for every key that is neither in
    ``table`` nor in ``claimed`` (keys another pool owns this wave
    because it planned first) nor a repeat within the pool itself.
    Iteration order of the result IS the pool's row order — commit
    writes in this order, which is what keeps memo insertion order
    identical across drivers.

    The caller holds the table's lock for the duration of the walk.
    """
    unseen: dict[bytes, int] = {}
    for i, k in enumerate(keys):
        if (
            k not in table
            and k not in unseen
            and (claimed is None or k not in claimed)
        ):
            unseen[k] = i
    return unseen


# ---------------------------------------------------------------------------
# commit stage
# ---------------------------------------------------------------------------

def gather_rows(
    keys: list[bytes],
    table: Mapping[bytes, np.ndarray],
    fallback: Mapping[bytes, np.ndarray] | None = None,
) -> np.ndarray:
    """Gather one pool's full objective matrix, row order preserved.

    ``fallback`` holds deferred (screen-predicted) objectives for keys
    the pipeline chose not to train this generation; with screening off
    it is empty/None and every row comes from ``table``.  The caller
    holds the table's lock.
    """
    if fallback:
        return np.stack([table[k] if k in table else fallback[k] for k in keys])
    return np.stack([table[k] for k in keys])


def commit_rows(
    table: dict[bytes, np.ndarray],
    train: Mapping[bytes, int],
    objs: np.ndarray | None,
    deferred_store: dict[bytes, np.ndarray] | None = None,
) -> None:
    """The commit half's writes: trained rows enter the table in plan order.

    ``objs`` rows correspond 1:1 (in order) to ``train`` keys.  A key
    that previously carried a deferred prediction is purged from the
    side table — the exact result supersedes it.  The caller holds the
    table's lock and settles its own counters (they differ per host:
    engines count evaluations/hits, the service counts
    hits/coalesced/trained).
    """
    if not train:
        return
    objs = np.asarray(objs, np.float64)
    for k, o in zip(train, objs):
        table[k] = o
        if deferred_store:
            deferred_store.pop(k, None)


# ---------------------------------------------------------------------------
# screen stage
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ScreenContext:
    """Everything a screen stage may look at when splitting a plan."""

    masks: np.ndarray                      # full pool (P, n_mask_bits) bool
    cats: np.ndarray                       # full pool (P, n_cat) int64
    keys: list[bytes]                      # full pool genome keys
    unseen: dict[bytes, int]               # planned rows: key -> row index
    memo: Mapping[bytes, np.ndarray]       # the exact-objective table (read-only)
    must_train: frozenset[bytes] = frozenset()  # deferred-flagged keys: always train
    final: bool = False                    # last generation: train everything


@dataclasses.dataclass
class ScreenDecision:
    """A screen's split of the planned rows.

    ``train`` is the subset of ``ScreenContext.unseen`` to evaluate
    exactly (same key -> row mapping, pool row order); ``deferred`` maps
    every remaining planned key to its predicted objective vector.
    """

    train: dict[bytes, int]
    deferred: dict[bytes, np.ndarray] = dataclasses.field(default_factory=dict)
    telemetry: dict = dataclasses.field(default_factory=dict)


# a screen stage is any callable with this shape (core.surrogate.SurrogateScreen)
ScreenStage = Callable[[ScreenContext], ScreenDecision]


def resolve_decision(ctx: ScreenContext, decision: ScreenDecision) -> ScreenDecision:
    """Validate a screen's decision against the honesty contract.

    The decision must partition the planned rows exactly (no invented
    keys, none dropped, no overlap) and must not defer a ``must_train``
    key.  Returns the decision with ``train`` re-ordered to pool row
    order, so commit-time memo insertion order never depends on screen
    internals.
    """
    unseen = ctx.unseen
    extra = [k for k in decision.train if k not in unseen]
    extra += [k for k in decision.deferred if k not in unseen]
    if extra:
        raise ValueError(
            f"screen decision names {len(extra)} keys outside the plan"
        )
    both = set(decision.train) & set(decision.deferred)
    if both:
        raise ValueError(
            f"screen decision both trains and defers {len(both)} keys"
        )
    missing = [
        k for k in unseen if k not in decision.train and k not in decision.deferred
    ]
    if missing:
        raise ValueError(
            f"screen decision drops {len(missing)} planned keys (every "
            "planned row must be trained or deferred)"
        )
    violated = [k for k in ctx.must_train if k in decision.deferred]
    if violated:
        raise ValueError(
            f"screen decision defers {len(violated)} must_train keys "
            "(a deferred prediction may survive at most one plan)"
        )
    # canonical order: pool row order, whatever order the screen built
    train = {k: unseen[k] for k in unseen if k in decision.train}
    return ScreenDecision(
        train=train, deferred=decision.deferred, telemetry=decision.telemetry
    )


# ---------------------------------------------------------------------------
# the plan object drivers schedule around
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PoolPlan:
    """One pool's planned evaluation: what to train, what was deferred.

    Produced by ``NSGA2.plan_pool`` (plan + screen under the memo lock),
    consumed by the driver's dispatch stage (:meth:`take`) and by
    ``NSGA2.commit_pool``.  With screening off ``deferred`` is empty and
    the plan is exactly the screen-less ``(keys, unseen)`` pair.
    """

    keys: list[bytes]
    train: dict[bytes, int]
    deferred: dict[bytes, int] = dataclasses.field(default_factory=dict)
    screen_info: dict = dataclasses.field(default_factory=dict)

    @property
    def first_seen(self) -> tuple[bytes, ...]:
        """Keys this pool owns this wave (for cross-pool ``claimed`` sets).

        Both trained and deferred rows are claimed: a later pool must
        not re-train a key an earlier pool deferred — it answers from
        the shared deferred side table instead, exactly like a memo hit.
        """
        return tuple(self.train) + tuple(self.deferred)

    def train_indices(self) -> np.ndarray:
        """Row indices of the train rows, plan (= pool) order."""
        return np.fromiter(
            self.train.values(), dtype=np.int64, count=len(self.train)
        )

    def take(self, masks: np.ndarray, cats: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """The dispatch stage's batch: the train rows of the pool."""
        idx = self.train_indices()
        return masks[idx], cats[idx]
