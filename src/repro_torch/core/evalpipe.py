"""The memo halves of one pool's evaluation (port of ``repro.core.evalpipe``).

``plan`` walks a pool's genome keys against the memo (and a cross-island
``claimed`` set) and picks the first-seen rows; the driver evaluates those
rows, blocking, dispatched or stacked across islands; ``commit`` writes
them into the memo in plan order and gathers the full pool's objectives.
Plan order is commit order is memo insertion order, the property the
reference pins across its drivers.  The screen stage (surrogate) waits for
ROADMAP Queue 1 item 7; without it the pipeline is exactly these two
halves.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping

import numpy as np

__all__ = ["plan_rows", "gather_rows", "commit_rows", "PoolPlan"]


def plan_rows(
    table: Mapping[bytes, np.ndarray],
    keys: list[bytes],
    claimed: Iterable[bytes] | None = None,
) -> dict[bytes, int]:
    """``key -> row index`` of the pool's first-seen keys.

    A key is planned when it is neither in ``table`` nor in ``claimed``
    (keys another pool owns this wave because it planned first) nor a
    repeat within the pool.  Iteration order of the result is the pool's
    row order.  The caller holds the table's lock.
    """
    unseen: dict[bytes, int] = {}
    for i, k in enumerate(keys):
        if k not in table and k not in unseen and (claimed is None or k not in claimed):
            unseen[k] = i
    return unseen


def gather_rows(keys: list[bytes], table: Mapping[bytes, np.ndarray]) -> np.ndarray:
    """The pool's full objective matrix, row order preserved."""
    return np.stack([table[k] for k in keys])


def commit_rows(
    table: dict[bytes, np.ndarray], train: Mapping[bytes, int], objs: np.ndarray | None
) -> None:
    """Trained rows enter the table in plan order (``objs`` rows 1:1 with ``train``)."""
    if not train:
        return
    for k, o in zip(train, np.asarray(objs, np.float64)):
        table[k] = o


@dataclasses.dataclass
class PoolPlan:
    """One pool's planned evaluation: its keys and the rows to train."""

    keys: list[bytes]
    train: dict[bytes, int]

    @property
    def first_seen(self) -> tuple[bytes, ...]:
        """Keys this pool owns this wave (for cross-pool ``claimed`` sets)."""
        return tuple(self.train)

    def take(self, masks: np.ndarray, cats: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """The batch to evaluate: the train rows of the pool, plan order."""
        idx = np.fromiter(self.train.values(), dtype=np.int64, count=len(self.train))
        return masks[idx], cats[idx]
