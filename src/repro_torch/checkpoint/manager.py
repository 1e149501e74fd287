"""Async checkpoint manager: background writes, rotation, auto-resume (port of
``repro.checkpoint.manager``).

The caller never blocks on I/O: ``save`` snapshots the leaves to host NumPy
arrays (the only synchronous part), then a writer thread serialises them.
Keeps the newest ``keep_n`` checkpoints as ``step_<n>`` directories, skips
corrupt ones at resume, and leaves no torn checkpoint behind a crash (the
atomic tmp-rename in ``ckpt.save_pytree``).  ``restore(shardings=...)``
places each leaf by its ``parallel.sharding.Sharding``: a DTensor
(``distribute_tensor``) on a mesh of more than one rank, a plain tensor on
the mesh's device for a mesh of one (the elastic-rescale path).
"""

from __future__ import annotations

import os
import queue
import re
import shutil
import threading

from repro_torch.checkpoint import ckpt

_STEP_RE = re.compile(r"^step_(\d+)$")


def _place(tree, shardings):
    """``tree``'s leaves placed by the matching ``Sharding`` leaves."""
    if isinstance(tree, dict):
        return {k: _place(v, shardings.get(k)) if shardings is not None else v
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        return type(tree)(_place(v, sh) for v, sh in zip(tree, shardings))
    if shardings is None:
        return tree
    import torch

    t = torch.as_tensor(tree)
    mesh = shardings.mesh
    if mesh.size() == 1:
        return t.to(mesh.device_type)
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t.to(mesh.device_type), mesh, list(shardings.placements))


def _to_host(tree):
    """The tree with every leaf a host NumPy array (dicts, lists and tuples kept)."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        return type(tree)(_to_host(v) for v in tree)
    return ckpt.to_numpy(tree)


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3):
        self.directory = directory
        self.keep_n = keep_n
        os.makedirs(directory, exist_ok=True)
        self._q: queue.Queue = queue.Queue()
        self._err: list[Exception] = []
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _ensure_worker(self):
        # save() after close() used to enqueue onto the dead worker thread and
        # the checkpoint was silently never written; restart lazily instead.
        if not self._thread.is_alive():
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    # -- write path ---------------------------------------------------------
    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                # the shutdown sentinel counts as a task too: without
                # task_done() a post-close wait() would join() forever
                self._q.task_done()
                return
            path, host_tree, step, extra = item
            try:
                ckpt.save_pytree(path, host_tree, step, extra)
                self._rotate()
            except Exception as e:  # surfaced on next wait()
                self._err.append(e)
            finally:
                self._q.task_done()

    def save(self, step: int, tree, extra: dict | None = None, block: bool = False):
        """Snapshot to host, enqueue async write."""
        host_tree = _to_host(tree)
        path = os.path.join(self.directory, f"step_{step}")
        self._ensure_worker()
        self._q.put((path, host_tree, int(step), extra))
        if block:
            self.wait()

    def wait(self):
        self._q.join()
        if self._err:
            # Drain every queued failure, oldest first — popping only the most
            # recent hid all earlier write errors.
            errs, self._err = self._err, []
            if len(errs) == 1:
                raise errs[0]
            raise RuntimeError(
                f"{len(errs)} checkpoint writes failed: "
                + "; ".join(f"{type(e).__name__}: {e}" for e in errs)
            )

    def _rotate(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep_n] if len(steps) > self.keep_n else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"), ignore_errors=True)

    # -- read path ----------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m and os.path.isdir(os.path.join(self.directory, name)):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None, shardings=None):
        """Load newest (or given) checkpoint; skip corrupt ones, newest first.

        ``shardings``: an optional tree of ``parallel.sharding.Sharding``
        matching the saved tree (None leaves stay host arrays); each leaf is
        placed onto its mesh."""
        candidates = sorted(self.all_steps(), reverse=True) if step is None else [step]
        last_err: Exception | None = None
        for s in candidates:
            path = os.path.join(self.directory, f"step_{s}")
            try:
                tree, manifest = ckpt.load_pytree(path)
            except Exception as e:
                last_err = e
                continue
            if shardings is not None:
                tree = _place(tree, shardings)
            return tree, manifest
        if last_err is not None:
            raise last_err
        raise FileNotFoundError(f"no checkpoints under {self.directory}")

    def close(self):
        # idempotent: a second close() on a dead worker must not enqueue a
        # stale sentinel that a lazily restarted worker would eat first
        if self._thread.is_alive():
            self._q.put(None)
            self._thread.join(timeout=10)
