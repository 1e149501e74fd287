"""Full paper reproduction on the port: ADC-aware co-design across all six datasets.

The twin of the reference's ``examples/adc_codesign.py``, with its flag
(``--quick``) and ``--device`` (the card by default, ``cpu`` for the plain
path).  Runs the NSGA-II x QAT search of ``core.codesign`` on each of the
paper's six datasets at ``configs.printed_mlp.codesign_config(ds,
full=not quick)`` (the full budget: pop 24, 16 generations, 600 steps) and
prints the gains at a 5% and a 1% accuracy-drop budget (Fig. 4; the
paper's headline is x11.2 area / x13.2 power at <5%), then:

  * the searched Seeds ADC bank through the pruned-quant comparator bank
    (K1, ``kernels/pruned_quant``, on a CUDA tensor; its plain version on
    the CPU)
  * the KV-codebook generalisation: the same pruned-level rule compressing
    a serving KV tensor (``core.frontend.kv_codebook_quantize``)

On the card every QAT step of the search runs the fused pruned-ADC kernels
K2/K3 (``kernels/fused_qat``) from the population step's CUDA graphs.

    PYTHONPATH=src python -m repro_torch.launch.adc_codesign [--quick] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs.printed_mlp import PAPER_DATASETS, codesign_config
from repro_torch.core import codesign
from repro_torch.core.frontend import kv_codebook_quantize
from repro_torch.device import resolve_device
from repro_torch.kernels.pruned_quant import ops as pq_ops

__all__ = ["search", "searched_bank_levels", "kv_codebook_demo", "run", "main"]


def search(quick: bool, device: str) -> dict:
    """The six searches: ``{ds: (CodesignResult, gains at 5%, gains at 1%)}``."""
    out = {}
    for ds in PAPER_DATASETS:
        cfg = dataclasses.replace(codesign_config(ds, full=not quick), device=device)
        res = codesign.run_codesign(cfg)
        out[ds] = (res, codesign.gains_at_budget(res, 0.05), codesign.gains_at_budget(res, 0.01))
    return out


def searched_bank_levels(mask: np.ndarray, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(x, levels): 8 draws of ``default_rng(0)`` through the pruned bank ``mask``."""
    x = torch.as_tensor(np.random.default_rng(0).uniform(0, 1, (8, mask.shape[0])),
                        dtype=torch.float32, device=device)
    return x, pq_ops.pruned_quantize(x, torch.as_tensor(mask, device=device), 4)


def kv_codebook_demo(device: str) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(kv, codes, dequantized): a (4, 16) KV tensor against 6 of 16 grid levels,
    from ``default_rng(1)``."""
    rng = np.random.default_rng(1)
    kv = torch.as_tensor(rng.normal(size=(4, 16)).astype(np.float32), device=device)
    grid = np.linspace(-3, 3, 16)
    keep = np.sort(rng.choice(16, size=6, replace=False))
    levels_tab = torch.as_tensor(np.tile(grid[keep], (16, 1)).astype(np.float32), device=device)
    codes, deq = kv_codebook_quantize(kv, levels_tab)
    return kv, codes, deq


def run(quick: bool = False, device: str | None = None) -> dict:
    """Everything ``main`` prints, and what it was computed from.

    Returns ``searches`` (``search``'s dict), ``mean_area_gain`` and
    ``mean_power_gain`` (at 5%), the K1 call's ``x`` and ``levels``, the KV
    demo's ``kv``, ``codes``, ``deq`` and ``kv_err``, and ``lines``: the
    text, one string a printed line.
    """
    dev = resolve_device(device).type
    searches = search(quick, dev)
    lines = []
    for ds, (res, g5, g1) in searches.items():
        lines.append(
            f"{ds:14s} conv_acc={res.conv_acc:.3f} | <5%: x{g5['area_gain']:.1f} area "
            f"x{g5['power_gain']:.1f} power (acc {g5['acc']:.3f}) | "
            f"<1%: x{g1['area_gain']:.1f} area"
        )
    a = float(np.mean([g5["area_gain"] for _, g5, _ in searches.values()]))
    p = float(np.mean([g5["power_gain"] for _, g5, _ in searches.values()]))
    lines += ["", f"MEAN at <5% drop: x{a:.1f} area, x{p:.1f} power (paper: x11.2 / x13.2)", ""]

    # -- the searched frontend through the comparator bank (K1 on the card) --
    x, levels = searched_bank_levels(searches["seeds"][1]["mask"], dev)
    route = "the CUDA kernel" if dev == "cuda" else "its plain PyTorch version"
    lines += [
        f"Pruned-quant comparator bank ({route}) on the searched Seeds ADC bank:",
        f"  input[0] : {np.round(x[0].cpu().numpy(), 3).tolist()}",
        f"  levels[0]: {levels[0].cpu().numpy().tolist()}",
    ]

    # -- beyond-paper: KV-cache codebook from a pruned uniform grid --------
    kv, codes, deq = kv_codebook_demo(dev)
    err = float(torch.mean(torch.abs(kv - deq)))
    dtype = str(codes.dtype).removeprefix("torch.")
    lines += [
        "",
        f"KV codebook (6 of 16 levels kept): mean |err|={err:.3f}, "
        f"codes dtype={dtype} (4x smaller than f32 cache)",
    ]
    return dict(searches=searches, mean_area_gain=a, mean_power_gain=p, x=x, levels=levels,
                kv=kv, codes=codes, deq=deq, kv_err=err, lines=lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    print("\n".join(run(args.quick, args.device)["lines"]))


if __name__ == "__main__":
    main()
