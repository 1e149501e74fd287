"""Quickstart on the port: the paper's ADC-aware co-design on one dataset.

The twin of the reference's ``examples/quickstart.py``, with ``--device``
(the card by default, ``cpu`` for the plain path).  Trains the paper's
bespoke printed MLP (8-bit pow2 weights, 4-bit ADC inputs) on the Seeds
replica, runs a short NSGA-II search over per-sensor pruned ADC level sets
(pop 16, 8 generations, 400 steps; on the card every QAT step runs the
fused pruned-ADC kernels K2/K3 from the population step's CUDA graphs), and
prints the accuracy-vs-area Pareto front plus the gains at the paper's <5%
accuracy budget.

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import codesign
from repro_torch.device import resolve_device

__all__ = ["run", "main"]


def run(device: str | None = None) -> dict:
    """The search and what ``main`` prints: ``cfg``, ``result``, ``gains`` (at
    5%) and ``lines``, one string a printed line."""
    cfg = codesign.CodesignConfig(dataset="seeds", pop_size=16, n_generations=8,
                                  max_steps=400, device=resolve_device(device).type)
    lines = [f"dataset={cfg.dataset}: NSGA-II pop={cfg.pop_size} gens={cfg.n_generations}"]
    res = codesign.run_codesign(cfg)
    lines += [
        "",
        f"conventional 4-bit ADC baseline accuracy: {res.conv_acc:.3f}",
        f"conventional ADC bank: {res.conv_area:.3f} cm^2, {res.conv_power:.2f} mW",
        "",
        "Pareto front (accuracy vs ADC area):",
    ]
    for i in np.argsort(res.front_area):
        kept = res.front_masks[i][:, 1:].sum(-1)
        lines.append(
            f"  acc={res.front_acc[i]:.3f}  area={res.front_area[i]:.4f} cm^2 "
            f"({res.front_area[i]/res.conv_area:5.1%} of conventional)  "
            f"levels/sensor={kept.tolist()}"
        )
    g = codesign.gains_at_budget(res, 0.05)
    lines += [
        "",
        f"at <5% accuracy drop: {g['area_gain']:.1f}x area, "
        f"{g['power_gain']:.1f}x power reduction "
        f"(paper average across datasets: 11.2x / 13.2x)",
    ]
    return dict(cfg=cfg, result=res, gains=g, lines=lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args()
    print("\n".join(run(args.device)["lines"]))


if __name__ == "__main__":
    main()
