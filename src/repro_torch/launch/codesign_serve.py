"""Serve concurrent co-design searches from one persistent memo and one device
(port of ``repro.launch.codesign_serve``).

The launch half of ``core.eval_service``: builds the QAT wave backend
(``core.codesign.make_service_backend``) on ``--device`` (the card by
default, ``cpu`` for the plain path), starts the service, plays an offered
workload of concurrent search requests against it (optionally staggered
at a fixed arrival interval), and prints the per-request latencies plus
the service telemetry: memo hit rate, wave occupancy, admission counters.

This is the in-process service driver: clients are threads, the request
"transport" is :meth:`EvalService.submit` / :meth:`EvalService.result`.
A network frontend would sit above this module and carry no search logic
of its own.

Example (tiny budgets, two duplicate clients to show cross-request hits):

    PYTHONPATH=src python -m repro_torch.launch.codesign_serve \\
        --requests 4 --duplicate-every 2 --pop 8 --gens 3 \\
        --step-scale 0.1 --max-steps 30 [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core import codesign, eval_service, nsga2
from repro_torch.runtime import admission as admission_rt


def build_requests(
    n_requests: int,
    pop_size: int,
    n_generations: int,
    base_seed: int,
    duplicate_every: int = 0,
) -> list[eval_service.SearchRequest]:
    """An offered workload of search requests.

    Request *i* searches with seed ``base_seed + i`` — distinct searches
    whose populations still overlap heavily on common genomes, the
    realistic cross-request sharing case.  With ``duplicate_every=k``
    every k-th request repeats the seed of the previous one: an identical
    search, the all-hits case (a client re-asking a solved question costs
    ~zero device rows).
    """
    reqs = []
    seed = base_seed
    for i in range(n_requests):
        if not (duplicate_every and i % duplicate_every and i > 0):
            seed = base_seed + i
        reqs.append(
            eval_service.SearchRequest(
                request_id=f"req-{i:03d}",
                ga=nsga2.NSGA2Config(
                    pop_size=pop_size,
                    n_generations=n_generations,
                    seed=seed,
                ),
            )
        )
    return reqs


def serve_workload(
    service: eval_service.EvalService,
    requests: list[eval_service.SearchRequest],
    arrival_s: float = 0.0,
) -> list[eval_service.SearchResult]:
    """Submit ``requests`` at a fixed arrival interval; collect in order."""
    for i, req in enumerate(requests):
        if arrival_s > 0 and i > 0:
            time.sleep(arrival_s)
        service.submit(req)
    return [service.result(req.request_id) for req in requests]


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="seeds")
    ap.add_argument("--adc-bits", type=int, default=4)
    ap.add_argument("--slots", type=int, default=4, help="device wave slots")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--duplicate-every", type=int, default=2)
    ap.add_argument("--pop", type=int, default=8)
    ap.add_argument("--gens", type=int, default=3)
    ap.add_argument("--max-steps", type=int, default=60)
    ap.add_argument("--step-scale", type=float, default=0.25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arrival-s", type=float, default=0.0,
                    help="inter-request arrival gap (0 = all at once)")
    ap.add_argument("--coalesce-s", type=float, default=0.02)
    ap.add_argument("--max-active", type=int, default=8)
    ap.add_argument("--deadline-s", type=float, default=None)
    ap.add_argument("--memo-path", default=None,
                    help="persistent shared memo checkpoint directory")
    ap.add_argument("--surrogate", action="store_true",
                    help="memo-trained surrogate pre-screening per request "
                         "(core.surrogate; fresh screen per search)")
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: cuda; 'cpu' runs the "
                         "plain PyTorch path)")
    args = ap.parse_args(argv)

    cd_cfg = codesign.CodesignConfig(
        dataset=args.dataset, adc_bits=args.adc_bits, seed=args.seed,
        max_steps=args.max_steps, step_scale=args.step_scale,
        surrogate=args.surrogate, device=args.device,
    )
    backend = codesign.make_service_backend(cd_cfg, wave_slots=args.slots)
    svc_cfg = eval_service.ServiceConfig(
        wave_slots=args.slots,
        coalesce_s=args.coalesce_s,
        admission=admission_rt.AdmissionConfig(
            max_active=args.max_active, deadline_s=args.deadline_s
        ),
        memo_path=args.memo_path,
    )
    service = eval_service.EvalService(
        backend["stacked_evaluate"],
        backend["n_mask_bits"],
        backend["cat_cardinalities"],
        cfg=svc_cfg,
        fingerprint=backend["fingerprint"],
        screen_factory=backend["screen_factory"],
    )
    requests = build_requests(
        args.requests, args.pop, args.gens, args.seed,
        duplicate_every=args.duplicate_every,
    )
    with service:
        results = serve_workload(service, requests, arrival_s=args.arrival_s)
        stats = service.stats()

    print(f"\n{args.dataset}: {len(results)} requests, "
          f"{args.slots}-slot waves, {stats['waves']['n_waves']} waves")
    print(f"{'request':<10} {'status':<8} {'front':>5} {'evals':>6} "
          f"{'hits':>6} {'wait_s':>8} {'latency_s':>10}")
    for r in results:
        if r.ok:
            print(f"{r.request_id:<10} {'ok':<8} "
                  f"{len(r.result['objs']):>5} {r.n_evaluations:>6} "
                  f"{r.n_memo_hits:>6} {r.queue_wait_s:>8.3f} "
                  f"{r.latency_s:>10.3f}")
        else:
            print(f"{r.request_id:<10} {'error':<8} {r.error!r}")
    lat = np.asarray([r.latency_s for r in results if r.ok])
    if lat.size:
        print(f"\nlatency p50={np.percentile(lat, 50):.3f}s "
              f"p95={np.percentile(lat, 95):.3f}s")
    sm = stats["shared_memo"]
    print(f"shared memo: {sm['entries']} entries, "
          f"{sm['rows_requested']} rows requested, {sm['trained']} trained, "
          f"{sm['hits']} hits + {sm['coalesced']} coalesced "
          f"(cross-request hit rate {stats['hit_rate']:.1%})")
    print(f"admission: {stats['admission']}")
    return {"results": results, "stats": stats}


if __name__ == "__main__":
    main()
