"""Assigned input-shape sets + per-(arch, shape) input specs.

Port of ``repro.launch.shapes``: the same shape sets, skip policy and
specs.  Every (arch x shape) cell resolves to a *step kind* plus a dict of
``(shape, dtype)`` stand-ins (no allocation; ``launch.steps`` turns them
into meta or fake tensors only where a step is traced) and matching
logical axes:

  * ``train_*``   -> ``train_step``  (fwd + bwd + optimizer)
  * ``prefill_*`` -> ``prefill``     (full-sequence forward + cache build)
  * ``decode_*`` / ``long_*`` -> ``serve_step`` (one token, full KV cache)

``long_500k`` requires sub-quadratic attention: per the assignment it runs
for SSM/hybrid archs and is skipped (with reason) for pure full-attention
archs — see ``cell_plan()``.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig

__all__ = ["SHAPES", "ShapeSpec", "input_specs", "cell_plan", "SKIP", "Cell"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

SKIP = "skipped(full-attention)"


@dataclasses.dataclass(frozen=True)
class Cell:
    arch: str
    shape: str
    status: str  # "run" | SKIP
    reason: str = ""


def cell_plan(cfg: ModelConfig) -> list[Cell]:
    """The 4 cells of one arch, with long_500k skip policy applied."""
    cells = []
    for sname in SHAPES:
        if sname == "long_500k" and not cfg.supports_long_context:
            cells.append(
                Cell(cfg.name, sname, SKIP, "O(S^2) attention at 524k out of contract")
            )
        else:
            cells.append(Cell(cfg.name, sname, "run"))
    return cells


def _sds(shape, dtype: str) -> tuple[tuple[int, ...], str]:
    return tuple(shape), dtype


def input_specs(cfg: ModelConfig, shape_name: str,
                spec: ShapeSpec | None = None) -> tuple[str, dict, dict]:
    """Returns (kind, {name: (shape, dtype name)}, {name: logical_axes}).

    Cache entries for decode kinds are provided by the model's
    ``cache_specs`` and merged by the dry-run (they are *state*, not
    host-fed inputs, but they are step operands all the same).  ``spec``
    overrides the shape set's sizes (the one-card cut of a cell).
    """
    sp = spec or SHAPES[shape_name]
    B, S = sp.global_batch, sp.seq_len
    fam = cfg.family

    if sp.kind == "train":
        if fam == "audio":
            T = cfg.max_target_len
            return (
                "train",
                {
                    "frames": _sds((B, S, cfg.d_model), "float32"),
                    "tokens": _sds((B, T), "int32"),
                    "labels": _sds((B, T), "int32"),
                },
                {
                    "frames": ("batch", None, None),
                    "tokens": ("batch", None),
                    "labels": ("batch", None),
                },
            )
        if fam == "vlm":
            P = cfg.frontend_len
            return (
                "train",
                {
                    "patch_embeds": _sds((B, P, cfg.d_model), "float32"),
                    "tokens": _sds((B, S - P), "int32"),
                    "labels": _sds((B, S - P), "int32"),
                },
                {
                    "patch_embeds": ("batch", None, None),
                    "tokens": ("batch", None),
                    "labels": ("batch", None),
                },
            )
        return (
            "train",
            {"tokens": _sds((B, S), "int32"), "labels": _sds((B, S), "int32")},
            {"tokens": ("batch", None), "labels": ("batch", None)},
        )

    if sp.kind == "prefill":
        if fam == "audio":
            return (
                "prefill",
                {"frames": _sds((B, S, cfg.d_model), "float32")},
                {"frames": ("batch", None, None)},
            )
        if fam == "vlm":
            P = cfg.frontend_len
            return (
                "prefill",
                {
                    "patch_embeds": _sds((B, P, cfg.d_model), "float32"),
                    "tokens": _sds((B, S - P), "int32"),
                },
                {"patch_embeds": ("batch", None, None), "tokens": ("batch", None)},
            )
        return (
            "prefill",
            {"tokens": _sds((B, S), "int32")},
            {"tokens": ("batch", None)},
        )

    # decode: one new token against a seq_len cache
    return (
        "decode",
        {"token": _sds((B,), "int32"), "kv_len": _sds((B,), "int32")},
        {"token": ("batch",), "kv_len": ("batch",)},
    )
