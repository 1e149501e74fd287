"""Persist the NSGA-II genome→objective memo across campaigns/restarts (port of
``repro.core.memo_store``, the same on-disk format).

The memoized engine (``core.nsga2``) keys objective vectors on the raw
genome bytes, so the cache is a plain ``dict[bytes, np.ndarray]`` that is
valid for exactly one (dataset, evaluator-config) pair.  This module turns
that dict into a ``checkpoint`` artifact (npz payload + sha256
manifest) so a re-run of the same search — a restarted campaign, a widened
budget, a later dataset pass — starts with every previously trained genome
already cached instead of re-training the whole history.

Layout: keys are fixed-length (same genome shape), so the whole memo packs
into two dense arrays — ``keys`` (K, L) uint8 of the raw genome bytes and
``objs`` (K, M) float64 — which round-trip bit-exactly through the npz
payload.  A caller-supplied *fingerprint* (dataset name, adc_bits, eval
budget, seed, …) is stored in the manifest and verified on load (the port's fingerprints carry
``"backend": "torch"``, so a memo trained by one package is refused by the
other's search; the arrays themselves load in either):  a memo
silently reused across incompatible configs would return stale objectives
for colliding genomes, which corrupts the search with no error anywhere —
so :func:`load_memo` refuses a fingerprint mismatch loudly instead.

Used by ``core.codesign.run_codesign`` (``CodesignConfig.memo_path``) and
``core.campaign.run_campaign`` (``CampaignConfig.memo_dir`` — one
sub-checkpoint per dataset, since genome keys mean nothing across
datasets with different feature counts).
"""

from __future__ import annotations

import json
import os
import threading
import time

import numpy as np

from repro_torch.checkpoint import ckpt

__all__ = ["save_memo", "load_memo", "memo_path_exists", "MemoAutosaver"]


def _canonical(fingerprint: dict) -> dict:
    """JSON-round-trip a fingerprint so it compares like the stored copy.

    The manifest serialises the fingerprint through JSON, which turns
    tuples into lists (and dict keys into strings); comparing the caller's
    live dict against the deserialised one with ``==`` would then reject
    every reload of a fingerprint containing a tuple value (e.g. a
    ``layer_sizes`` field) as a spurious mismatch.  Normalising BOTH sides
    through the same round-trip keeps the comparison about values, not
    about JSON's type coarsening.
    """
    return json.loads(json.dumps(fingerprint))


def save_memo(
    path: str, memo: dict[bytes, np.ndarray], fingerprint: dict | None = None
) -> str:
    """Write a genome→objective memo to ``path`` (a checkpoint directory).

    ``fingerprint`` is an arbitrary json-able dict identifying the search
    configuration the entries are valid for; :func:`load_memo` verifies it.
    Atomic via ``ckpt.save_pytree`` (tmp dir + rename).
    """
    if memo:
        keys = np.stack([np.frombuffer(k, dtype=np.uint8) for k in memo])
        objs = np.stack([np.asarray(v, dtype=np.float64) for v in memo.values()])
    else:
        keys = np.zeros((0, 0), np.uint8)
        objs = np.zeros((0, 0), np.float64)
    tree = {"keys": keys, "objs": objs}
    return ckpt.save_pytree(
        path, tree, step=len(memo), extra={"fingerprint": fingerprint or {}}
    )


def load_memo(
    path: str, fingerprint: dict | None = None
) -> dict[bytes, np.ndarray]:
    """Load a memo written by :func:`save_memo`.

    Raises ``ValueError`` when ``fingerprint`` is given and does not match
    the one stored at save time (wrong dataset / eval budget / seed — the
    cached objectives would be wrong, not just suboptimal).
    """
    tree, manifest = ckpt.load_pytree(path)
    stored = manifest.get("extra", {}).get("fingerprint", {})
    if fingerprint is not None and _canonical(stored) != _canonical(fingerprint):
        raise ValueError(
            f"memo at {path} was built for {stored}, not {fingerprint}; "
            "refusing to reuse cached objectives across incompatible searches"
        )
    keys, objs = tree["keys"], tree["objs"]
    return {keys[i].tobytes(): objs[i] for i in range(keys.shape[0])}


def memo_path_exists(path: str) -> bool:
    """True when ``path`` holds a loadable memo checkpoint."""
    return os.path.isfile(os.path.join(path, ckpt.MANIFEST))


class MemoAutosaver:
    """Rate-limited, thread-safe periodic persistence of a live memo.

    A long-running service commits results into its memo continuously; a
    batch campaign saves once at exit.  This helper gives the service the
    campaign's durability without a save per commit: :meth:`poke` is cheap
    enough to call after EVERY memo write and only persists when at least
    ``every_s`` seconds have passed since the last save (``every_s=0``
    saves on every poke — the test setting).  :meth:`flush` saves
    unconditionally (shutdown path).

    Concurrency: the caller passes the SAME lock that guards its memo
    writes (``NSGA2``'s memo lock, or the service's table lock); the dict
    is shallow-copied under that lock and the (slow) npz write happens
    outside it, so a save never blocks commits for longer than one dict
    copy.  An internal lock serialises the writers themselves — two
    threads poking at once produce two sequential atomic checkpoints, not
    an interleaved one.
    """

    def __init__(
        self,
        path: str,
        fingerprint: dict | None = None,
        every_s: float = 0.0,
    ):
        self.path = path
        self.fingerprint = fingerprint
        self.every_s = float(every_s)
        self.n_saves = 0
        self._last_save = -float("inf")
        self._write_lock = threading.Lock()

    def _snapshot(self, memo, lock) -> dict[bytes, np.ndarray]:
        if lock is not None:
            with lock:
                return dict(memo)
        return dict(memo)

    def poke(
        self,
        memo: dict[bytes, np.ndarray],
        lock: "threading.Lock | None" = None,
    ) -> str | None:
        """Persist ``memo`` if the save interval has elapsed, else no-op."""
        now = time.monotonic()
        if now - self._last_save < self.every_s:
            return None
        with self._write_lock:
            if time.monotonic() - self._last_save < self.every_s:
                return None  # another thread saved while we waited
            snap = self._snapshot(memo, lock)
            self._last_save = time.monotonic()
            out = save_memo(self.path, snap, self.fingerprint)
            self.n_saves += 1
            return out

    def flush(
        self,
        memo: dict[bytes, np.ndarray],
        lock: "threading.Lock | None" = None,
    ) -> str:
        """Persist ``memo`` unconditionally (service shutdown)."""
        with self._write_lock:
            snap = self._snapshot(memo, lock)
            self._last_save = time.monotonic()
            out = save_memo(self.path, snap, self.fingerprint)
            self.n_saves += 1
            return out
