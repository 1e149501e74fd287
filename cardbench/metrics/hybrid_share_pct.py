"""Share of the window inside the gradient/GA hybrid and the surrogate screen.

The harness's spans around ``hybrid.warm_start_genomes``, the refiner's
calls and the surrogate screen's calls (its fits and predictions), their
union over the window's wall time (each less the time the harness spent
reading the profiler).
"""

from cardbench.tracing import union_s

UNIT, BETTER, SOURCE = "%", "lower", "program_span"
LAYER, MOVES = "hybrid and screen", "search_s"
SPANS = ("hybrid.warm_start", "hybrid.refine", "surrogate.screen")


def read(run):
    t0, t1 = run.records["search_window"]
    spans = [(a, b) for _, a, b in run.spans.within(t0, t1, SPANS)]
    if not spans:
        return None
    inside = union_s(spans, t0, t1) - union_s(spans, *run.trace.pause)
    return 100.0 * inside / ((t1 - t0) - run.trace.paused_s(t0, t1))
