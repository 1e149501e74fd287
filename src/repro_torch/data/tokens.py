"""Synthetic LM token pipeline: deterministic, sharded, prefetching (port of
``repro.data.tokens``).

A seeded Zipf-ish synthetic corpus stands in for tokenised shards (offline
machine), as in the reference, and the draws are the reference's: NumPy's
``default_rng(SeedSequence([seed, step, host_index]))``, so both packages
give the same batches bit for bit.  Per-host sharding by ``host_index``,
random access by step (a restore at step k replays exactly the batches k,
k+1, ...), and a background host->device prefetch: on a CUDA device the
batch is copied from pinned host memory with ``non_blocking`` copies.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np
import torch

__all__ = ["TokenConfig", "TokenStream", "Prefetcher"]


@dataclasses.dataclass(frozen=True)
class TokenConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_index: int = 0

    @property
    def host_batch(self) -> int:
        if self.global_batch % self.n_hosts:
            raise ValueError(f"global batch {self.global_batch} does not split over "
                             f"{self.n_hosts} hosts")
        return self.global_batch // self.n_hosts


class TokenStream:
    """Deterministic batch stream; ``batch_at(step)`` is random-access so a
    restore at step k replays exactly the batches k, k+1, ..."""

    def __init__(self, cfg: TokenConfig):
        self.cfg = cfg

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, cfg.host_index])
        )
        # Zipf-ish marginal over the vocab (heavy head like natural text)
        a = 1.2
        raw = rng.zipf(a, size=(cfg.host_batch, cfg.seq_len + 1)).astype(np.int64)
        tokens = np.minimum(raw - 1, cfg.vocab_size - 1).astype(np.int32)
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch with a bounded buffer.  ``device=None``
    keeps the NumPy batches on the host; a device gets tensors (from pinned
    memory, copied ``non_blocking``, on a CUDA device)."""

    def __init__(self, stream: TokenStream, start_step: int = 0, depth: int = 2,
                 device: torch.device | str | None = None):
        self.stream = stream
        self.device = None if device is None else torch.device(device)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(x))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _fill(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.stream.batch_at(step)
            if self.device is not None:
                batch = {k: self._to_device(v) for k, v in batch.items()}
            try:
                self._q.put((step, batch), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def next(self):
        step, batch = self._q.get()
        return step, batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
