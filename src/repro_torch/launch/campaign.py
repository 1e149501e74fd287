"""Multi-dataset ADC co-design campaign on the port: the paper's gains table in one run.

The twin of the reference's ``examples/campaign.py``, with the same flags
and ``--device`` (the card by default, ``cpu`` for the plain path).  Runs
the NSGA-II x QAT co-design across the UCI replica datasets and prints the
per-dataset area×/power× gains at a 5% accuracy-drop budget (the paper's
headline: x11.2 area / x13.2 power mean), the QAT rows trained against
those answered from the genome memo, and per-dataset wall-clock.

    PYTHONPATH=src python -m repro_torch.launch.campaign --quick
    PYTHONPATH=src python -m repro_torch.launch.campaign --datasets seeds,balance,cardio
    PYTHONPATH=src python -m repro_torch.launch.campaign --islands 4 --stacked-islands
    PYTHONPATH=src python -m repro_torch.launch.campaign --islands 4 --async-pipeline
    PYTHONPATH=src python -m repro_torch.launch.campaign --memo-dir DIR   # reruns train nothing
    PYTHONPATH=src python -m repro_torch.launch.campaign --genome-axes adc,act,wprec \
        --surrogate --hybrid-warm-frac 0.25   # three-axis genome, screened, warm-started
    PYTHONPATH=src python -m repro_torch.launch.campaign   # full budget, all six
"""

import argparse

from repro_torch.core import campaign, chromosome
from repro_torch.data import uci_synth


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--quick", action="store_true", help="CI-scale search budget")
    ap.add_argument(
        "--datasets", default=",".join(uci_synth.DATASETS),
        help="comma-separated subset of: " + ", ".join(uci_synth.DATASETS),
    )
    ap.add_argument("--budget", type=float, default=0.05, help="accuracy-drop budget")
    ap.add_argument("--no-memo", action="store_true", help="disable evaluation memo")
    ap.add_argument(
        "--memo-dir", default=None, metavar="DIR",
        help="persist per-dataset genome memos under DIR (reruns replay free)",
    )
    ap.add_argument(
        "--fused", action="store_true",
        help="accepted for parity with the reference: the port always runs the "
             "fused pruned-ADC QAT kernels (kernels.fused_qat)",
    )
    ap.add_argument(
        "--islands", type=int, default=1, metavar="K",
        help="island-model NSGA-II: K sub-populations of pop_size each with "
             "ring-wise Pareto-front migration (1 = single population)",
    )
    ap.add_argument(
        "--migration-interval", type=int, default=3, metavar="G",
        help="generations between migration waves (with --islands > 1)",
    )
    ap.add_argument(
        "--migration-size", type=int, default=2, metavar="M",
        help="Pareto-front members each island sends per wave",
    )
    ap.add_argument(
        "--stacked-islands", action="store_true",
        help="evaluate all islands' unseen genomes as one cross-island "
             "population call per generation (bit-for-bit identical results; "
             "the sequential island loop remains the default)",
    )
    ap.add_argument(
        "--async-pipeline", action="store_true",
        help="dispatch QAT batches as non-blocking device programs and "
             "overlap host-side variation/planning with the in-flight "
             "evaluation (bit-for-bit identical results)",
    )
    ap.add_argument(
        "--checkpoint-dir", default=None, metavar="DIR",
        help="checkpoint each dataset's GA state + memo under DIR/<dataset> "
             "every --checkpoint-every generations (fault tolerance)",
    )
    ap.add_argument(
        "--checkpoint-every", type=int, default=1, metavar="N",
        help="generations between GA-state checkpoints (with --checkpoint-dir)",
    )
    ap.add_argument(
        "--resume", action="store_true",
        help="resume each dataset search from its newest checkpoint under "
             "--checkpoint-dir (fingerprint-verified; fresh run if none)",
    )
    ap.add_argument(
        "--device", default=None, metavar="DEV",
        help="cuda (default: the card) or cpu (the plain PyTorch path)",
    )
    ap.add_argument(
        "--genome-axes", default="adc", metavar="AXES",
        help="comma-separated genome gene groups to evolve, from: "
             + ",".join(chromosome.AXES)
             + " ('adc' = the paper's level masks, mandatory; 'act' adds "
             "per-layer activation approximations, 'wprec' per-layer "
             "weight precision / ternary weights)",
    )
    ap.add_argument(
        "--surrogate", action="store_true",
        help="memo-trained surrogate pre-screening (core.surrogate): spend "
             "QAT rows only on each generation's predicted-undominated "
             "genomes + a seeded exploration slice; the rest are deferred "
             "with flagged predictions and trained when next planned "
             "(needs the evaluation memo)",
    )
    ap.add_argument(
        "--surrogate-min-rows", type=int, default=32, metavar="N",
        help="train everything exactly until the memo holds N rows "
             "(the surrogate's confidence gate)",
    )
    ap.add_argument(
        "--hybrid-warm-frac", type=float, default=0.0, metavar="F",
        help="gradient/GA hybrid: seed this fraction of each island's "
             "initial population from relaxed gradient descents, hardened "
             "and exactly re-scored through the QAT evaluator "
             "(0 = pure GA; needs the evaluation memo)",
    )
    ap.add_argument(
        "--hybrid-refine-every", type=int, default=0, metavar="R",
        help="gradient/GA hybrid: every R generations gradient-polish the "
             "top crowding-distance front-0 members and inject the "
             "hardened results as extra children (0 = off)",
    )
    ap.add_argument(
        "--hybrid-grad-steps", type=int, default=30, metavar="T",
        help="relaxed-descent steps per hybrid warm-start restart / "
             "refinement wave",
    )
    args = ap.parse_args()

    datasets = tuple(d.strip() for d in args.datasets.split(",") if d.strip())
    island_kw = dict(
        num_islands=args.islands, migration_interval=args.migration_interval,
        migration_size=args.migration_size, stacked_islands=args.stacked_islands,
        async_pipeline=args.async_pipeline, checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every, resume=args.resume,
        genome_axes=args.genome_axes, surrogate=args.surrogate,
        surrogate_min_rows=args.surrogate_min_rows,
        hybrid_warm_frac=args.hybrid_warm_frac,
        hybrid_refine_every=args.hybrid_refine_every,
        hybrid_grad_steps=args.hybrid_grad_steps, device=args.device,
    )
    if args.quick:
        cfg = campaign.CampaignConfig(
            datasets=datasets, acc_drop_budget=args.budget, pop_size=10,
            n_generations=4, step_scale=0.3, max_steps=150, memoize=not args.no_memo,
            use_fused_kernel=args.fused, memo_dir=args.memo_dir, **island_kw,
        )
    else:
        cfg = campaign.CampaignConfig(
            datasets=datasets, acc_drop_budget=args.budget, pop_size=24,
            n_generations=16, step_scale=1.0, max_steps=600, memoize=not args.no_memo,
            use_fused_kernel=args.fused, memo_dir=args.memo_dir, **island_kw,
        )
    # the ONE driver-flag validation matrix (CodesignConfig.validate) —
    # every rejected flag combination surfaces as a CLI usage error
    try:
        cfg.validate()
    except ValueError as e:
        ap.error(str(e))

    res = campaign.run_campaign(cfg)
    print(res.table)
    deferred = f", {res.n_deferred} surrogate-deferred" if args.surrogate else ""
    print(
        f"\ntotal QAT rows trained: {res.n_evaluations} "
        f"(+{res.n_memo_hits} memo hits{deferred}, "
        f"{sum(res.wall_s.values()):.1f}s wall)"
    )
    for ds, r in res.results.items():
        if r.recoveries:
            events = ", ".join(
                f"{e['reason']}@gen{e['gens_done']}" for e in r.recoveries
            )
            print(f"{ds}: recovered from {len(r.recoveries)} event(s): {events}")
    if args.islands > 1:
        for ds, r in res.results.items():
            waves = r.migrations or []
            accepted = sum(sum(w["accepted"]) for w in waves)
            sent = sum(sum(w["sent"]) for w in waves)
            print(
                f"{ds}: {args.islands} islands, {len(waves)} migration waves, "
                f"{accepted}/{sent} migrants accepted after genome dedupe"
            )


if __name__ == "__main__":
    main()
