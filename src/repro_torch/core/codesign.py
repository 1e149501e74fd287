"""ADC-aware co-design: the paper's training flow (port of ``repro.core.codesign``).

Couples the NSGA-II search (``core.nsga2``) over per-input ADC level masks
and QAT hyper-parameters with the population QAT evaluator
(``core.trainer``: a CUDA graph a block of steps on the card by default)
and the area proxy (``core.area``).  Both objectives are minimised, as in
section II-C:

    obj0 = accuracy miss  (1 - test accuracy of the QAT-trained MLP)
    obj1 = total ADC area (proxy model, normalised to the conventional ADC)

The reference's search drivers are all here: one population or islands
(sequential, stacked into one population call a generation, or the async
pipeline that varies and plans island i+1 while island i trains), the
memo (``memoize``) and its store on disk (``memo_path``), GA-state
checkpoints with resume, and chaos drills (``drill``), the last two
through ``runtime.elastic.ElasticGARunner``.  ``use_fused_kernel`` is
accepted either way: the port's first QAT layer is always the fused K2/K3
pair, which the reference's own "identical search outcome" allows.

Not ported yet, each raising ``NotImplementedError`` (see
:data:`NOT_PORTED`): genome axes beyond ``"adc"`` (ROADMAP Queue 1 item
6), the surrogate screen and the gradient/GA hybrid (item 7) and the
evaluation-service backend (item 8).
"""

from __future__ import annotations

import dataclasses
import itertools
import zlib

import numpy as np

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import area as area_model
from repro_torch.core import chromosome, memo_store, nsga2, qat, trainer
from repro_torch.data import uci_synth
from repro_torch.device import resolve_device
from repro_torch.runtime import elastic as elastic_rt
from repro_torch.runtime import failure as failure_rt

__all__ = [
    "CodesignConfig",
    "CodesignResult",
    "NOT_PORTED",
    "run_codesign",
    "make_service_backend",
    "gains_at_budget",
]

NOT_PORTED = {
    "genome_axes": "genome axes beyond 'adc' are not ported yet: ROADMAP Queue 1 item 6",
    "surrogate": "the surrogate screen is not ported yet: ROADMAP Queue 1 item 7",
    "hybrid": "the gradient/GA hybrid is not ported yet: ROADMAP Queue 1 item 7",
    "service": "the evaluation service is not ported yet: ROADMAP Queue 1 item 8",
}


@dataclasses.dataclass(frozen=True)
class CodesignConfig:
    dataset: str = "seeds"
    adc_bits: int = 4
    pop_size: int = 24
    n_generations: int = 12
    step_scale: float = 1.0
    max_steps: int = 600
    seed: int = 0
    # False selects the paper-style naive engine that re-trains the full
    # parent+child pool every generation
    memoize: bool = True
    crossover_rate: float = 0.7
    mutation_rate: float = 0.02
    # accepted either way: the port's first layer is always K2/K3
    use_fused_kernel: bool = False
    # genome->objective memo on disk: preloaded when present
    # (fingerprint-verified), saved after the search
    memo_path: str | None = None
    # island model (core.nsga2.IslandNSGA2): num_islands sub-populations of
    # pop_size each, one shared memo, ring migration; 1 = one population
    num_islands: int = 1
    migration_interval: int = 3
    migration_size: int = 2
    migration_topology: str = "ring"
    # one cross-island population call a generation (needs memoize)
    stacked_islands: bool = False
    # dispatch each batch and block only at commit time (islands: needs
    # memoize, excludes stacked_islands)
    async_pipeline: bool = False
    # GA state + memo checkpointed every checkpoint_every generations under
    # checkpoint_dir; resume continues from the newest compatible one.
    # Either this or drill routes the run through ElasticGARunner.
    checkpoint_dir: str | None = None
    checkpoint_every: int = 1
    resume: bool = False
    drill: "elastic_rt.DrillConfig | None" = None
    # validated as the reference does; only ("adc",) runs (item 6)
    genome_axes: tuple[str, ...] | str = ("adc",)
    # validated as the reference does; enabling either raises (item 7)
    surrogate: bool = False
    surrogate_min_rows: int = 32
    surrogate_explore_frac: float = 0.15
    hybrid_warm_frac: float = 0.0
    hybrid_refine_every: int = 0
    hybrid_grad_steps: int = 30
    device: str | None = None  # None = "cuda"; the tests pass "cpu"

    def validate(self) -> "CodesignConfig":
        """The reference's driver-flag validation matrix: every rejected combination.

        Every entry point (:func:`run_codesign`, ``CampaignConfig.validate``,
        the CLI) routes through here first.  Options that are valid but not
        ported are refused afterwards, by :func:`run_codesign`, with
        ``NotImplementedError``.  Returns ``self``.
        """
        self.axes()  # raises on unknown/missing genome axes
        if self.pop_size < 2:
            raise ValueError(f"pop_size must be >= 2, got {self.pop_size}")
        if self.n_generations < 0:
            raise ValueError(f"n_generations must be >= 0, got {self.n_generations}")
        if self.num_islands < 1:
            raise ValueError(f"num_islands must be >= 1, got {self.num_islands}")
        if self.migration_interval < 1:
            raise ValueError(
                f"migration_interval must be >= 1, got {self.migration_interval}"
            )
        if self.migration_size < 0:
            raise ValueError(f"migration_size must be >= 0, got {self.migration_size}")
        if self.migration_topology not in nsga2.TOPOLOGIES:
            raise ValueError(
                f"unknown topology {self.migration_topology!r}; "
                f"choose from {nsga2.TOPOLOGIES}"
            )
        if self.stacked_islands and self.async_pipeline:
            raise ValueError(
                "stacked_islands and async_pipeline are mutually exclusive "
                "drivers (one cross-island wave vs in-flight per-island "
                "programs — pick one)"
            )
        if self.stacked_islands and not self.memoize:
            raise ValueError(
                "stacked_islands needs memoize=True (the cross-island wave "
                "is deduped through the shared memo)"
            )
        if self.async_pipeline and self.num_islands > 1 and not self.memoize:
            raise ValueError(
                "async_pipeline with num_islands > 1 needs memoize=True "
                "(the overlapped islands dedupe through the shared memo)"
            )
        if self.checkpoint_every < 1:
            raise ValueError(f"checkpoint_every must be >= 1, got {self.checkpoint_every}")
        if self.resume and self.checkpoint_dir is None:
            raise ValueError("resume=True needs checkpoint_dir (where to resume from)")
        if self.surrogate and not self.memoize:
            raise ValueError(
                "surrogate=True needs memoize=True (the memo is the "
                "surrogate's training set)"
            )
        if self.surrogate_min_rows < 1:
            raise ValueError(
                f"surrogate_min_rows must be >= 1, got {self.surrogate_min_rows}"
            )
        if not 0.0 <= self.surrogate_explore_frac <= 1.0:
            raise ValueError(
                "surrogate_explore_frac must be in [0, 1], got "
                f"{self.surrogate_explore_frac}"
            )
        if not 0.0 <= self.hybrid_warm_frac <= 1.0:
            raise ValueError(f"hybrid_warm_frac must be in [0, 1], got {self.hybrid_warm_frac}")
        if self.hybrid_refine_every < 0:
            raise ValueError(
                f"hybrid_refine_every must be >= 0, got {self.hybrid_refine_every}"
            )
        if self.hybrid_grad_steps < 1:
            raise ValueError(f"hybrid_grad_steps must be >= 1, got {self.hybrid_grad_steps}")
        if (self.hybrid_warm_frac > 0.0 or self.hybrid_refine_every > 0) and not self.memoize:
            raise ValueError(
                "the gradient/GA hybrid needs memoize=True (warm/refined "
                "genomes are exact-scored through the memo pipeline so "
                "later generations see them as hits)"
            )
        return self

    def check_ported(self) -> "CodesignConfig":
        """Raise ``NotImplementedError`` for a valid option the port lacks."""
        if self.axes() != ("adc",):
            raise NotImplementedError(NOT_PORTED["genome_axes"])
        if self.surrogate:
            raise NotImplementedError(NOT_PORTED["surrogate"])
        if self.hybrid_warm_frac > 0.0 or self.hybrid_refine_every > 0:
            raise NotImplementedError(NOT_PORTED["hybrid"])
        return self

    def axes(self) -> tuple[str, ...]:
        """The normalized genome-axes tuple (canonical order, validated)."""
        return chromosome.normalize_axes(self.genome_axes)

    def island_config(self) -> nsga2.IslandConfig:
        return nsga2.IslandConfig(
            num_islands=self.num_islands,
            migration_interval=self.migration_interval,
            migration_size=self.migration_size,
            topology=self.migration_topology,
            stacked=self.stacked_islands,
            async_pipeline=self.async_pipeline,
        )

    def memo_fingerprint(self) -> dict:
        """Config fields the cached objectives are a pure function of.

        ``backend`` keeps a memo trained by this port from ever aliasing
        objectives trained by the JAX package: the two draw different
        initial weights and minibatches for the same genome.  The
        ``genome_axes`` key appears only beyond "adc", as in the reference.
        """
        fp = {
            "dataset": self.dataset,
            "adc_bits": self.adc_bits,
            "step_scale": self.step_scale,
            "max_steps": self.max_steps,
            "seed": self.seed,
            "backend": "torch",
        }
        axes = self.axes()
        if axes != ("adc",):
            fp["genome_axes"] = list(axes)
        return fp

    def search_fingerprint(self) -> dict:
        """Config fields a GA-state checkpoint is only valid for.

        The objectives' fields (:meth:`memo_fingerprint`) plus the
        search-shape knobs the RNG streams and population arrays encode.
        ``n_generations`` is left out: a resumed campaign may widen its
        budget.  The surrogate and hybrid keys appear only when enabled,
        as in the reference.
        """
        fp = {
            **self.memo_fingerprint(),
            "pop_size": self.pop_size,
            "crossover_rate": self.crossover_rate,
            "mutation_rate": self.mutation_rate,
            "num_islands": self.num_islands,
            "migration_interval": self.migration_interval,
            "migration_size": self.migration_size,
            "migration_topology": self.migration_topology,
        }
        if self.surrogate:
            fp["surrogate"] = {
                "min_rows": self.surrogate_min_rows,
                "explore_frac": self.surrogate_explore_frac,
            }
        if self.hybrid_warm_frac > 0.0 or self.hybrid_refine_every > 0:
            fp["hybrid"] = {
                "warm_frac": self.hybrid_warm_frac,
                "refine_every": self.hybrid_refine_every,
                "grad_steps": self.hybrid_grad_steps,
            }
        return fp


@dataclasses.dataclass
class CodesignResult:
    dataset: str
    spec: uci_synth.DatasetSpec
    front_masks: np.ndarray        # (F, C, 2^N)
    front_cats: np.ndarray         # (F, 5)
    front_acc: np.ndarray          # (F,)
    front_area: np.ndarray         # (F,) absolute cm^2
    front_power: np.ndarray        # (F,) absolute mW
    conv_acc: float                # conventional-ADC QAT baseline accuracy
    conv_area: float
    conv_power: float
    history: list
    n_evaluations: int = 0         # QAT rows actually trained by the GA
    n_memo_hits: int = 0           # QAT rows answered from the genome memo
    n_deferred: int = 0            # rows answered by a surrogate: 0 in the port
    # island-model telemetry (None for the single-population engine):
    island_history: list | None = None   # per-island NSGA2.history lists
    migrations: list | None = None       # per-wave acceptance counts
    # elastic-runner telemetry (None when the run was not checkpointed):
    recoveries: list | None = None       # rebuild events (device loss etc.)
    genome_axes: tuple[str, ...] = ("adc",)


def _genome_seeds(mask_genes: np.ndarray, cat_genes: np.ndarray) -> np.ndarray:
    """Deterministic per-genome training seeds (crc32 of the genome bytes).

    Seeding from the genome, not the row position, makes the objective a
    pure function of the chromosome, which lets the memo answer repeated
    genomes without changing the search outcome.
    """
    keys = nsga2.genome_keys(mask_genes, cat_genes)
    return np.asarray([zlib.crc32(k) & 0x7FFFFFFF for k in keys], np.int32)


def _rows(dec: dict) -> tuple:
    """The evaluator's per-row arrays of a decoded batch."""
    return (dec["masks"], dec["weight_bits"], dec["act_bits"], dec["batch_size"],
            dec["epochs"], dec["lr"])


def run_codesign(cfg: CodesignConfig) -> CodesignResult:
    cfg.validate().check_ported()
    X, y, spec = uci_synth.load(cfg.dataset)
    X_tr, y_tr, X_te, y_te = uci_synth.stratified_split(X, y, 0.7, cfg.seed)
    mlp_cfg = qat.MLPConfig(
        layer_sizes=(spec.n_features, spec.hidden, spec.n_classes),
        adc_bits=cfg.adc_bits,
    )
    eval_cfg = trainer.EvalConfig(
        max_steps=cfg.max_steps, step_scale=cfg.step_scale, seed=cfg.seed
    )
    # evaluators live in a mutable dict so the recovery path can swap in
    # rebuilt ones mid-campaign: every callback reads it at call time
    evaluators: dict = {
        "pop": trainer.make_population_evaluator(
            X_tr, y_tr, X_te, y_te, mlp_cfg, eval_cfg, device=cfg.device
        )
    }

    def rebuild_evaluators(n_devices: int | None = None) -> None:
        """Fresh evaluators (empty graph caches) on the first ``n_devices`` devices."""
        for name in list(evaluators):
            evaluators[name] = evaluators[name].rebuild(n_devices)

    conv_area, conv_power = area_model.conventional_cost(spec.n_features, cfg.adc_bits)

    # chaos-drill tap: every batch sent to an evaluator passes here (one
    # ordinal per non-empty batch, rows accumulated) BEFORE dispatch, so an
    # injected failure interrupts the generation with the batch counted
    drill = cfg.drill
    _batch_ordinal = itertools.count()

    def _observe_batch(n_rows: int) -> None:
        if drill is None:
            return
        step = next(_batch_ordinal)
        drill.rows_dispatched += int(n_rows)
        if drill.injector is not None:
            drill.injector.maybe_slow(step)
            drill.injector.maybe_fail(step)

    def dispatch_evaluate(mask_genes: np.ndarray, cat_genes: np.ndarray):
        """Launch one batch's training now; objectives on resolve().

        The area pass runs on the host while the card trains; resolved at
        once, this is the blocking callback (``evaluate`` below).
        """
        dec = chromosome.decode_batch(mask_genes, cat_genes, spec.n_features, cfg.adc_bits)
        seeds = _genome_seeds(mask_genes, cat_genes)
        _observe_batch(mask_genes.shape[0])
        resolve_acc = evaluators["pop"].dispatch(*_rows(dec), seeds)
        areas, _ = area_model.adc_cost_batch(dec["masks"], cfg.adc_bits)

        def resolve() -> np.ndarray:
            accs = np.asarray(resolve_acc())
            return np.stack([1.0 - accs, areas / conv_area], axis=1)

        return resolve

    def evaluate(mask_genes: np.ndarray, cat_genes: np.ndarray) -> np.ndarray:
        """Blocking objective callback: dispatch, then resolve at once."""
        return dispatch_evaluate(mask_genes, cat_genes)()

    def make_stacked_evaluate():
        """Cross-island objective callback: every island's batch in one population call."""
        evaluators["islands"] = trainer.make_island_evaluator(
            X_tr, y_tr, X_te, y_te, mlp_cfg, eval_cfg, num_islands=cfg.num_islands,
            device=cfg.device,
        )

        def evaluate_stacked(batches):
            decs = [chromosome.decode_batch(m, c, spec.n_features, cfg.adc_bits)
                    for m, c in batches]
            for m, _ in batches:
                if m.shape[0]:
                    _observe_batch(m.shape[0])
            resolve_accs = evaluators["islands"].dispatch(
                [_rows(d) + (_genome_seeds(m, c),) for d, (m, c) in zip(decs, batches)]
            )
            areas = [area_model.adc_cost_batch(d["masks"], cfg.adc_bits)[0] for d in decs]
            return [np.stack([1.0 - np.asarray(a), ar / conv_area], axis=1)
                    for a, ar in zip(resolve_accs(), areas)]

        return evaluate_stacked

    preload = None
    if cfg.memo_path and cfg.memoize and memo_store.memo_path_exists(cfg.memo_path):
        preload = memo_store.load_memo(cfg.memo_path, cfg.memo_fingerprint())
    ga_cfg = nsga2.NSGA2Config(
        pop_size=cfg.pop_size, n_generations=cfg.n_generations, seed=cfg.seed,
        memoize=cfg.memoize, crossover_rate=cfg.crossover_rate,
        mutation_rate=cfg.mutation_rate,
    )
    ga_kwargs = dict(
        n_mask_bits=chromosome.n_mask_bits(spec.n_features, cfg.adc_bits),
        cat_cardinalities=chromosome.cat_cardinalities(),
        evaluate=evaluate,
        cfg=ga_cfg,
        memo=preload,
    )
    if cfg.num_islands > 1:
        ga = nsga2.IslandNSGA2(
            island_cfg=cfg.island_config(),
            stacked_evaluate=make_stacked_evaluate() if cfg.stacked_islands else None,
            dispatch_evaluate=dispatch_evaluate if cfg.async_pipeline else None,
            **ga_kwargs,
        )

        def run_ga(hook):
            return ga.run(checkpoint_hook=hook)
    else:
        ga = nsga2.NSGA2(**ga_kwargs)

        def run_ga(hook):
            if cfg.async_pipeline:
                return ga.run_async(dispatch_evaluate, checkpoint_hook=hook)
            return ga.run(checkpoint_hook=hook)

    recoveries = None
    if cfg.checkpoint_dir is not None or drill is not None:
        out, recoveries = _run_elastic(cfg, ga, run_ga, rebuild_evaluators)
    else:
        out = run_ga(None)
    if cfg.memo_path and cfg.memoize:
        memo_store.save_memo(cfg.memo_path, ga.memo, cfg.memo_fingerprint())

    dec = chromosome.decode_batch(out["masks"], out["cats"], spec.n_features, cfg.adc_bits)
    front_area, front_power = area_model.adc_cost_batch(dec["masks"], cfg.adc_bits)
    front_acc = 1.0 - out["objs"][:, 0]

    # conventional-ADC baseline accuracy: full mask + default hyper-params,
    # best of several inits (the [7] baseline is a tuned bespoke circuit).
    # Explicit replicate seeds: genome-derived seeds would collapse the
    # identical replicates onto one init.
    n_seeds = 4
    base = chromosome.decode_batch(
        np.ones((n_seeds, chromosome.n_mask_bits(spec.n_features, cfg.adc_bits)), bool),
        np.zeros((n_seeds, len(chromosome.cat_cardinalities())), np.int64),
        spec.n_features, cfg.adc_bits,
    )
    base_accs = evaluators["pop"](*_rows(base), np.arange(n_seeds, dtype=np.int32))
    return CodesignResult(
        dataset=cfg.dataset,
        spec=spec,
        front_masks=dec["masks"],
        front_cats=out["cats"],
        front_acc=front_acc,
        front_area=front_area,
        front_power=front_power,
        conv_acc=float(base_accs.max()),
        conv_area=conv_area,
        conv_power=conv_power,
        history=out["history"],
        n_evaluations=int(out["n_evaluations"]),
        n_memo_hits=int(out["n_memo_hits"]),
        n_deferred=int(out.get("n_deferred", 0)),
        island_history=out.get("island_history"),
        migrations=out.get("migrations"),
        recoveries=recoveries,
        genome_axes=cfg.axes(),
    )


def make_service_backend(cfg: CodesignConfig, wave_slots: int = 4) -> dict:
    """The evaluation service's wave backend: not ported (raises)."""
    raise NotImplementedError(NOT_PORTED["service"])


def _run_elastic(cfg: CodesignConfig, ga, run_ga, rebuild_evaluators):
    """Run the GA under the elastic runner: checkpoints, resume, recovery.

    Optional resume from the newest fingerprint-compatible checkpoint, a
    save callback every ``cfg.checkpoint_every`` generation boundaries
    (plus straggler-urgent boundaries and the last one), a device probe
    honouring the drill's ``lose_devices``, and the evaluator rebuild hook.
    The manager is closed in a ``finally`` so a crashing campaign (an
    injected ``HostFailure``) still drains its queued writes: that last
    durable boundary is what the restarted process resumes from.
    """
    drill = cfg.drill
    mgr = CheckpointManager(cfg.checkpoint_dir) if cfg.checkpoint_dir is not None else None
    fp = cfg.search_fingerprint()
    if mgr is not None and cfg.resume:
        step = mgr.latest_step()
        if step is not None:
            tree, manifest = mgr.restore(step)
            stored = manifest.get("extra", {}).get("fingerprint", {})
            if memo_store._canonical(stored) != memo_store._canonical(fp):
                raise ValueError(
                    f"checkpoint at {cfg.checkpoint_dir} was written by a "
                    f"search configured {stored}, not {fp}; refusing to "
                    "resume an incompatible campaign"
                )
            ga.set_state({"arrays": tree, "meta": manifest["extra"]["meta"]})

    every = max(int(cfg.checkpoint_every), 1)

    def save_cb(driver, gens_done: int, urgent: bool) -> None:
        if mgr is None:
            return
        if urgent or gens_done % every == 0 or gens_done >= cfg.n_generations:
            st = driver.state_dict()
            mgr.save(gens_done, st["arrays"], extra={"meta": st["meta"], "fingerprint": fp})

    probe = None
    if drill is not None and drill.lose_devices:
        n_dev = trainer.device_count(resolve_device(cfg.device))

        def probe():
            return max(n_dev - drill.lose_devices, 1)

    runner = elastic_rt.ElasticGARunner(
        driver=ga,
        run_fn=run_ga,
        rebuild=rebuild_evaluators,
        probe=probe,
        watchdog=(drill.watchdog if drill is not None else None),
        checkpoint_cb=save_cb,
        recover_on=(failure_rt.DeviceLossError,),
    )
    try:
        out = runner.run()
    finally:
        if mgr is not None:
            mgr.close()
    return out, runner.recoveries


def gains_at_budget(res: CodesignResult, acc_drop_budget: float = 0.05) -> dict:
    """Paper-style gains: best area/power reduction within an accuracy budget."""
    ok = res.front_acc >= (res.conv_acc - acc_drop_budget)
    if not ok.any():
        ok = res.front_acc >= res.front_acc.max() - 1e-9  # fall back to best acc
    idx = np.where(ok)[0]
    best = idx[np.argmin(res.front_area[idx])]
    return {
        "dataset": res.dataset,
        "budget": acc_drop_budget,
        "conv_acc": res.conv_acc,
        "acc": float(res.front_acc[best]),
        "area_gain": float(res.conv_area / max(res.front_area[best], 1e-12)),
        "power_gain": float(res.conv_power / max(res.front_power[best], 1e-12)),
        "kept_levels_mean": float(res.front_masks[best][:, 1:].sum(-1).mean()),
        "mask": res.front_masks[best],
        "cats": res.front_cats[best],
    }
