"""Multi-dataset co-design campaigns, the paper's Table II in one call (port of
``repro.core.campaign``).

A campaign runs :func:`core.codesign.run_codesign` across a set of
``uci_synth`` datasets with one shared search configuration and collects
the paper-style gains table — area×/power× vs the conventional ADC bank at
an accuracy-drop budget — plus engine telemetry (QAT rows trained, memo
hits, per-dataset wall-clock).

Per dataset, ``CampaignConfig.codesign_config(ds)`` specialises the shared
knobs into a ``CodesignConfig``; ``run_codesign`` builds the population
evaluator (a CUDA graph a block of training steps on the card, see
``core.trainer``), runs the NSGA-II search and returns the Pareto front;
``gains_at_budget`` projects it onto the paper's headline metric.

``memo_dir`` keeps each dataset's memo under ``{memo_dir}/{dataset}``
(``core.memo_store``): a rerun of the same campaign trains zero rows.
``num_islands``, ``stacked_islands`` and ``async_pipeline`` select the
island drivers, ``checkpoint_dir`` / ``resume`` the elastic runner, as in
the reference; so do ``genome_axes``, ``surrogate`` and the ``hybrid_*``
knobs; ``device`` picks the card (default) or the CPU.

    from repro_torch.core import campaign
    res = campaign.run_campaign(campaign.CampaignConfig())
    print(res.table)

CLI: ``PYTHONPATH=src python -m repro_torch.launch.campaign [--quick] [--datasets a,b]``.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np

from repro_torch.core import codesign
from repro_torch.data import uci_synth

__all__ = ["CampaignConfig", "CampaignResult", "run_campaign", "format_gains_table"]


@dataclasses.dataclass(frozen=True)
class CampaignConfig:
    """Shared sweep configuration applied to every dataset in the campaign."""

    datasets: tuple[str, ...] = tuple(uci_synth.DATASETS)
    acc_drop_budget: float = 0.05  # the paper's headline budget
    adc_bits: int = 4
    pop_size: int = 12
    n_generations: int = 6
    step_scale: float = 0.5
    max_steps: int = 300
    seed: int = 0
    memoize: bool = True
    use_fused_kernel: bool = False   # accepted either way: the port always runs K2/K3
    memo_dir: str | None = None      # persist per-dataset memos under {memo_dir}/{ds}
    # island-model NSGA-II (core.nsga2.IslandNSGA2): num_islands
    # sub-populations of pop_size chromosomes each with ring migration
    # every migration_interval generations; 1 = single-population engine
    num_islands: int = 1
    migration_interval: int = 3
    migration_size: int = 2
    migration_topology: str = "ring"
    # one cross-island population call per generation instead of stepping
    # islands sequentially (bit-for-bit identical results; needs memoize)
    stacked_islands: bool = False
    # non-blocking device dispatch: overlap host-side variation/planning
    # with in-flight QAT programs, blocking only at commit time (bit-for-bit
    # identical results; with islands needs memoize, excludes stacked)
    async_pipeline: bool = False
    # fault tolerance: checkpoint each dataset's GA state + shared memo
    # under {checkpoint_dir}/{dataset} every checkpoint_every generations;
    # resume=True continues each interrupted dataset search from its
    # newest compatible checkpoint (see CodesignConfig.checkpoint_dir)
    checkpoint_dir: str | None = None
    checkpoint_every: int = 1
    resume: bool = False
    # generalized approximation genome: which gene groups the search
    # evolves (core.chromosome.AXES; "adc" mandatory).  The default is
    # the paper's ADC-only space, bit-for-bit the pre-axes configuration.
    genome_axes: tuple[str, ...] | str = ("adc",)
    # memo-trained surrogate pre-screening (core.surrogate): spend QAT
    # rows only on predicted-undominated + exploration genomes, defer the
    # rest with flagged predictions (needs memoize; see CodesignConfig)
    surrogate: bool = False
    surrogate_min_rows: int = 32
    surrogate_explore_frac: float = 0.15
    # gradient/GA hybrid (core.hybrid): warm-start each island population
    # from relaxed gradient descents and/or gradient-polish front-0
    # members every hybrid_refine_every generations (needs memoize; see
    # CodesignConfig — defaults keep the search bit-for-bit hybrid-less)
    hybrid_warm_frac: float = 0.0
    hybrid_refine_every: int = 0
    hybrid_grad_steps: int = 30
    device: str | None = None        # None = "cuda"; the tests pass "cpu"

    def validate(self) -> "CampaignConfig":
        """Campaign-level checks + the shared driver-flag matrix.

        Dataset membership is checked here; everything else delegates to
        :meth:`codesign.CodesignConfig.validate` — the ONE driver-flag
        matrix — via a representative per-dataset config.
        """
        if not self.datasets:
            raise ValueError("datasets must name at least one dataset")
        unknown = [d for d in self.datasets if d not in uci_synth.DATASETS]
        if unknown:
            raise ValueError(
                f"unknown dataset(s): {', '.join(unknown)} "
                f"(choose from: {', '.join(uci_synth.DATASETS)})"
            )
        self.codesign_config(self.datasets[0]).validate()
        return self

    def codesign_config(self, dataset: str) -> codesign.CodesignConfig:
        return codesign.CodesignConfig(
            dataset=dataset,
            adc_bits=self.adc_bits,
            pop_size=self.pop_size,
            n_generations=self.n_generations,
            step_scale=self.step_scale,
            max_steps=self.max_steps,
            seed=self.seed,
            memoize=self.memoize,
            use_fused_kernel=self.use_fused_kernel,
            memo_path=os.path.join(self.memo_dir, dataset) if self.memo_dir else None,
            num_islands=self.num_islands,
            migration_interval=self.migration_interval,
            migration_size=self.migration_size,
            migration_topology=self.migration_topology,
            stacked_islands=self.stacked_islands,
            async_pipeline=self.async_pipeline,
            checkpoint_dir=(
                os.path.join(self.checkpoint_dir, dataset)
                if self.checkpoint_dir
                else None
            ),
            checkpoint_every=self.checkpoint_every,
            resume=self.resume,
            genome_axes=self.genome_axes,
            surrogate=self.surrogate,
            surrogate_min_rows=self.surrogate_min_rows,
            surrogate_explore_frac=self.surrogate_explore_frac,
            hybrid_warm_frac=self.hybrid_warm_frac,
            hybrid_refine_every=self.hybrid_refine_every,
            hybrid_grad_steps=self.hybrid_grad_steps,
            device=self.device,
        )


@dataclasses.dataclass
class CampaignResult:
    config: CampaignConfig
    results: dict[str, codesign.CodesignResult]   # per-dataset full results
    gains: dict[str, dict]                        # per-dataset gains_at_budget
    wall_s: dict[str, float]                      # per-dataset wall-clock
    table: str                                    # formatted gains table

    @property
    def n_evaluations(self) -> int:
        return sum(r.n_evaluations for r in self.results.values())

    @property
    def n_memo_hits(self) -> int:
        return sum(r.n_memo_hits for r in self.results.values())

    @property
    def n_deferred(self) -> int:
        return sum(r.n_deferred for r in self.results.values())

    @property
    def mean_area_gain(self) -> float:
        return float(np.mean([g["area_gain"] for g in self.gains.values()]))

    @property
    def mean_power_gain(self) -> float:
        return float(np.mean([g["power_gain"] for g in self.gains.values()]))


def format_gains_table(
    gains: dict[str, dict],
    wall_s: dict[str, float] | None = None,
    results: dict[str, codesign.CodesignResult] | None = None,
) -> str:
    """Render the paper-style per-dataset gains table as aligned text."""
    hdr = (
        f"{'dataset':<14} {'conv_acc':>8} {'acc':>6} {'drop':>6} "
        f"{'area_x':>7} {'power_x':>8} {'levels':>7}"
    )
    if results is not None:
        hdr += f" {'evals':>6} {'hits':>6}"
    if wall_s is not None:
        hdr += f" {'wall_s':>7}"
    lines = [hdr, "-" * len(hdr)]
    for ds, g in gains.items():
        row = (
            f"{ds:<14} {g['conv_acc']:>8.3f} {g['acc']:>6.3f} "
            f"{g['conv_acc'] - g['acc']:>6.3f} {g['area_gain']:>6.1f}x {g['power_gain']:>7.1f}x "
            f"{g['kept_levels_mean']:>7.2f}"
        )
        if results is not None:
            r = results[ds]
            row += f" {r.n_evaluations:>6d} {r.n_memo_hits:>6d}"
        if wall_s is not None:
            row += f" {wall_s[ds]:>7.1f}"
        lines.append(row)
    area = np.mean([g["area_gain"] for g in gains.values()])
    power = np.mean([g["power_gain"] for g in gains.values()])
    lines.append("-" * len(hdr))
    lines.append(
        f"{'MEAN':<14} {'':>8} {'':>6} {'':>6} {area:>6.1f}x {power:>7.1f}x"
        "   (paper: x11.2 area / x13.2 power at <5% drop)"
    )
    return "\n".join(lines)


def run_campaign(cfg: CampaignConfig = CampaignConfig()) -> CampaignResult:
    """Run the co-design search on every dataset and tabulate the gains."""
    cfg.validate()
    results: dict[str, codesign.CodesignResult] = {}
    gains: dict[str, dict] = {}
    wall_s: dict[str, float] = {}
    for ds in cfg.datasets:
        t0 = time.perf_counter()
        res = codesign.run_codesign(cfg.codesign_config(ds))
        wall_s[ds] = round(time.perf_counter() - t0, 2)
        results[ds] = res
        gains[ds] = codesign.gains_at_budget(res, cfg.acc_drop_budget)
    table = format_gains_table(gains, wall_s, results)
    return CampaignResult(
        config=cfg, results=results, gains=gains, wall_s=wall_s, table=table
    )
