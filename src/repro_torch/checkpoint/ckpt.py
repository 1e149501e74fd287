"""Pytree checkpointing, npz payload + json manifest (port of ``repro.checkpoint.ckpt``).

The on-disk format is the reference's, so either package reads what the
other wrote: a directory holding ``arrays.npz`` (leaves keyed by their
``/``-joined path) and ``manifest.json`` (step, per-leaf shapes and dtypes,
the payload's sha256 and a caller's ``extra`` dict).  Leaves may be NumPy
arrays or tensors; they are stored as NumPy arrays, and loaded as such.

NumPy has no bfloat16.  A bf16 tensor is stored as its 2-byte bit pattern,
the ``|V2`` payload the reference's npz holds for an ml_dtypes bfloat16
leaf, with ``"bfloat16"`` in the manifest as the reference writes it; it
loads as a CPU bf16 tensor with the same bits (a ``|V2`` or 2-byte integer
payload under ``"bfloat16"``, whichever package wrote it).

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
import torch

MANIFEST = "manifest.json"
PAYLOAD = "arrays.npz"
BF16_BITS = np.dtype("V2")  # how npz holds a bfloat16 leaf


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
    """A leaf as a host NumPy array (a tensor is copied off its device; a
    bf16 tensor becomes its bit pattern, ``BF16_BITS``)."""
    if hasattr(leaf, "detach"):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(BF16_BITS)
        return t.numpy()
    return np.asarray(leaf)


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if arr.dtype == BF16_BITS else str(arr.dtype)


def _bf16(arr: np.ndarray) -> torch.Tensor:
    """A bfloat16 leaf's 2-byte payload as a CPU bf16 tensor, the same bits."""
    return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)


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
        meta[key] = {"shape": list(arr.shape), "dtype": _dtype_name(arr)}
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
    """Returns (tree-of-np-arrays, bf16 leaves as CPU tensors; manifest).
    Raises on corruption."""
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    payload = os.path.join(path, PAYLOAD)
    if verify and _sha256(payload) != manifest["payload_sha256"]:
        raise IOError(f"checkpoint payload corrupted: {path}")
    with np.load(payload) as z:
        flat = {k.replace("\x1f", "/"): z[k] for k in z.files}
    for key, spec in manifest["leaves"].items():
        arr = flat[key]
        bf16 = spec["dtype"] == "bfloat16" and arr.dtype.itemsize == 2 and arr.dtype.kind in "Viu"
        if list(arr.shape) != spec["shape"] or not (bf16 or str(arr.dtype) == spec["dtype"]):
            raise IOError(f"leaf {key} mismatch: {arr.shape}/{arr.dtype} vs {spec}")
        if bf16:
            flat[key] = _bf16(arr)
    return _unflatten(flat), manifest
