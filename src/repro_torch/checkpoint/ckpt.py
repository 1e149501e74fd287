"""Pytree checkpointing, npz payload + json manifest (port of ``repro.checkpoint.ckpt``).

The on-disk format is the reference's, so either package reads what the
other wrote: a directory holding ``arrays.npz`` (leaves keyed by their
``/``-joined path) and ``manifest.json`` (step, per-leaf shapes and dtypes,
the payload's sha256 and a caller's ``extra`` dict).  Leaves may be NumPy
arrays or tensors; they are stored as NumPy arrays, and loaded as such.

Integrity: ``load_pytree`` verifies the sha256 and every leaf's shape and
dtype before handing data out.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any

import numpy as np

MANIFEST = "manifest.json"
PAYLOAD = "arrays.npz"


def _flatten_with_paths(tree) -> dict[str, Any]:
    flat = {}

    def rec(prefix, node):
        if isinstance(node, dict):
            for k in sorted(node):
                rec(f"{prefix}/{k}" if prefix else str(k), node[k])
        elif isinstance(node, (list, tuple)) and not hasattr(node, "shape"):
            for i, v in enumerate(node):
                rec(f"{prefix}/[{i}]", v)
        else:
            flat[prefix] = node

    rec("", tree)
    return flat


def to_numpy(leaf) -> np.ndarray:
    """A leaf as a host NumPy array (a tensor is copied off its device)."""
    if hasattr(leaf, "detach"):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def save_pytree(path: str, tree, step: int = 0, extra: dict | None = None) -> str:
    """Write tree to ``path`` (a directory). Atomic: writes to .tmp then renames."""
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    flat = _flatten_with_paths(tree)
    arrays = {}
    meta = {}
    for key, leaf in flat.items():
        arr = to_numpy(leaf)
        arrays[key] = arr
        meta[key] = {"shape": list(arr.shape), "dtype": str(arr.dtype)}
    payload = os.path.join(tmp, PAYLOAD)
    np.savez(payload, **{k.replace("/", "\x1f"): v for k, v in arrays.items()})
    manifest = {
        "step": int(step),
        "leaves": meta,
        "payload_sha256": _sha256(payload),
        "extra": extra or {},
    }
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    return path


def _unflatten(flat: dict[str, Any]):
    root: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return root


def load_pytree(path: str, verify: bool = True) -> tuple[dict, dict]:
    """Returns (tree-of-np-arrays, manifest). Raises on corruption."""
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    payload = os.path.join(path, PAYLOAD)
    if verify and _sha256(payload) != manifest["payload_sha256"]:
        raise IOError(f"checkpoint payload corrupted: {path}")
    with np.load(payload) as z:
        flat = {k.replace("\x1f", "/"): z[k] for k in z.files}
    for key, spec in manifest["leaves"].items():
        arr = flat[key]
        if list(arr.shape) != spec["shape"] or str(arr.dtype) != spec["dtype"]:
            raise IOError(f"leaf {key} mismatch: {arr.shape}/{arr.dtype} vs {spec}")
    return _unflatten(flat), manifest
