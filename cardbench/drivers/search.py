"""Closed loop of co-design searches: one client, back-to-back ``run_codesign`` calls.

Search k of a run takes the seed ``derived_seed(1, k)`` of ``--seed`` for
its split, its GA and its training, and starts from an empty memo.  The
window runs searches until ``--seconds`` have passed; the one running at
the deadline runs to its end, and ``search_s`` is the window's wall time
over the searches completed in it.

The harness watches the search from outside.  It wraps the population
evaluator the search builds (``trainer.make_population_evaluator``): every
call's rows, its accuracies, its bucket and the warm-up steps a capture
ran are recorded.  It puts spans around the gradient/GA hybrid's warm
start and refiner and the surrogate screen's calls.  Nothing in the
program is edited.

The output check retrains every row the window trained with the plain fp32
reference (``reference/printed_mlp``): the data, the split, each row's
initial weights and minibatches worked out again from the seeds, and
compares the accuracies.  It decodes each front point's genes again,
finds the row trained for that genome and compares its accuracy, and
prices the front with the reference's area/power proxy.
"""

from __future__ import annotations

import dataclasses
import time
import traceback

import numpy as np

from cardbench.reference import printed_mlp as ref

ROW_NAMES = ("masks", "weight_bits", "act_bits", "batch_size", "epochs", "lr", "seeds")
EXTRA_NAMES = {"act": "act_sel", "wprec": "wprec"}


@dataclasses.dataclass
class State:
    search: dict | None = None  # the record of the search running now
    searches: list = dataclasses.field(default_factory=list)


def _axes(run) -> tuple[str, ...]:
    axes = run.traffic.get("search", {}).get("genome_axes", "adc")
    axes = axes.split(",") if isinstance(axes, str) else list(axes)
    return tuple(a for a in ("adc", "act", "wprec") if a in axes)


def search_config(run, seed: int, **over):
    from repro_torch.core.codesign import CodesignConfig

    c = run.config
    fields = dict(dataset=c["dataset"], adc_bits=c["adc_bits"], pop_size=c["pop_size"],
                  n_generations=c["n_generations"], step_scale=c["step_scale"],
                  max_steps=c["max_steps"])
    fields.update(run.traffic.get("search", {}))
    fields.update(over)
    return CodesignConfig(seed=seed, device=run.device, **fields)


def _check_config(run) -> None:
    """The configuration file holds what the program runs."""
    from repro_torch.configs import printed_mlp
    from repro_torch.core import trainer
    from repro_torch.data import uci_synth

    c = run.config
    prog = printed_mlp.codesign_config(c["dataset"], full=True)
    spec = uci_synth.DATASETS[c["dataset"]]
    want = {"pop_size": prog.pop_size, "n_generations": prog.n_generations,
            "step_scale": prog.step_scale, "max_steps": prog.max_steps,
            "adc_bits": prog.adc_bits, "n_samples": spec.n_samples,
            "layer_sizes": [spec.n_features, spec.hidden, spec.n_classes],
            "max_batch": trainer.EvalConfig().max_batch}
    diff = {k: (c.get(k), v) for k, v in want.items() if c.get(k) != v}
    if diff:
        raise SystemExit(f"configs/{run.cell['config']}.json differs from the program: {diff}")


_WATCH: dict = {}  # the run and state the installed wrappers record into


def _install(run, state: State) -> None:
    """Wrap the evaluator factory and the hybrid's and screen's entry points
    (once a process; the wrappers record into the newest run)."""
    from repro_torch.core import hybrid, surrogate, trainer

    _WATCH.update(run=run, state=state)
    make = trainer.make_population_evaluator
    if getattr(make, "cardbench", False):
        return

    def span(name, fn):
        def wrapped(*args, **kwargs):
            with _WATCH["run"].spans.span(name):
                return fn(*args, **kwargs)
        return wrapped

    def make_recorded(*args, **kwargs):
        ev = make(*args, **kwargs)

        def dispatch(*rows):
            run, rec = _WATCH["run"], _WATCH["state"].search
            run.trace.boundary()
            P = int(np.shape(rows[0])[0])
            warm0 = ev.stats["warmup_steps"]
            traced = run.trace.active
            with run.spans.span("evaluator.dispatch"):
                resolve = ev.dispatch(*rows)
            entry = {"rows": [np.array(r, copy=True) for r in rows], "P": P,
                     "warmup": ev.stats["warmup_steps"] - warm0, "traced": traced,
                     "acc": None}
            if rec is not None:
                rec["calls"].append(entry)

            def resolved():
                with run.spans.span("evaluator.resolve"):
                    acc = resolve()
                entry["acc"] = np.array(acc, copy=True)
                return acc

            return resolved

        def evaluate(*rows):
            return dispatch(*rows)()

        for attr in ("rebuild", "stats", "mesh", "granule", "plan", "programs"):
            setattr(evaluate, attr, getattr(ev, attr))
        evaluate.dispatch = dispatch
        return evaluate

    make_recorded.cardbench = True
    trainer.make_population_evaluator = make_recorded
    hybrid.warm_start_genomes = span("hybrid.warm_start", hybrid.warm_start_genomes)
    make_refiner = hybrid.make_refiner
    hybrid.make_refiner = lambda *a, **k: span("hybrid.refine", make_refiner(*a, **k))
    surrogate.SurrogateScreen.__call__ = span("surrogate.screen",
                                              surrogate.SurrogateScreen.__call__)


def setup(run) -> State:
    from repro_torch.core import codesign

    _check_config(run)
    X, y = ref.load(run.config["dataset"])
    split = ref.stratified_split(X, y, 0.7, 0)
    budget = search_config(run, 0)
    run.records.update(n_train=len(split[1]), n_test=len(split[3]),
                       budget={"max_steps": budget.max_steps, "step_scale": budget.step_scale})
    state = State()
    _install(run, state)
    # one short search: builds or loads K2/K3, warms the trainer and the GA
    warm = int(run.traffic.get("warm_generations", 1))
    codesign.run_codesign(search_config(run, run.derived_seed(0), n_generations=warm))
    return state


def window(run, state: State) -> dict:
    from repro_torch.core.codesign import run_codesign

    t0 = time.perf_counter()
    k = failed = 0
    while True:
        seed = run.derived_seed(1, k)
        state.search = rec = {"seed": seed, "calls": [], "result": None}
        try:
            with run.spans.span("search"):
                res = run_codesign(search_config(run, seed))
            rec["result"] = {
                "front_masks": res.front_masks, "front_cats": res.front_cats,
                "front_acc": res.front_acc, "front_area": res.front_area,
                "front_power": res.front_power, "n_evaluations": res.n_evaluations,
                "n_memo_hits": res.n_memo_hits, "n_deferred": res.n_deferred,
            }
        except Exception:
            traceback.print_exc()
            failed += 1
        state.searches.append(rec)
        k += 1
        run.trace.boundary()
        if time.perf_counter() - t0 >= run.seconds:
            break
    t1 = time.perf_counter()
    state.search = None
    run.records.update(attempted=k, failed=failed, searches=state.searches,
                       search_window=(t0, t1))
    done = max(k - failed, 1)
    return {"search_s": (t1 - t0) / done}


# ---------------------------------------------------------------------------
# the output check
# ---------------------------------------------------------------------------

def problem(run, seeds):
    """Each search seed's split, stacked: (X_tr, y_tr, X_te, y_te) arrays (D, n, ...)."""
    X, y = ref.load(run.config["dataset"])
    parts = [ref.stratified_split(X, y, 0.7, s) for s in seeds]
    return tuple(np.stack([p[i] for p in parts]) for i in range(4))


def trained_rows(state: State, axes) -> tuple[dict, np.ndarray, list]:
    """Every row the window's searches trained: the evaluator's inputs by
    name, the search each belongs to, and the accuracies the program gave."""
    names = ROW_NAMES + tuple(EXTRA_NAMES[a] for a in axes if a in EXTRA_NAMES)
    cols = {n: [] for n in names}
    data, acc, seeds = [], [], []
    for d, rec in enumerate(s for s in state.searches if s["result"] is not None):
        seeds.append(rec["seed"])
        for call in rec["calls"]:
            for n, a in zip(names, call["rows"]):
                cols[n].append(np.asarray(a))
            data.append(np.full(call["P"], d))
            acc.append(call["acc"])
    rows = {n: np.concatenate(v) for n, v in cols.items()}
    rows["data"] = np.concatenate(data)
    return rows, np.concatenate(acc), seeds


def reference_accuracies(run, rows: dict, seeds: list, precision: str = "fp32"):
    """The reference's accuracies of ``rows`` (from :func:`trained_rows`)."""
    import torch

    dev = torch.device(run.device)
    c = run.config
    X_tr, y_tr, X_te, y_te = problem(run, seeds)
    sizes = c["layer_sizes"]
    budget = run.records["budget"]
    draws = [ref.draw_row(seeds[d], s, sizes, X_tr.shape[1], budget["max_steps"],
                          c["max_batch"])
             for d, s in zip(rows["data"], rows["seeds"])]
    params0 = {k: torch.stack([p[k] for p, _ in draws]).to(dev) for k in draws[0][0]}
    idx = torch.stack([i for _, i in draws]).to(dev)
    t = {k: torch.as_tensor(np.asarray(v)).to(dev) for k, v in rows.items() if k != "seeds"}
    t["masks"] = t["masks"].to(torch.bool)
    as_t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
    acc = ref.train_rows(as_t(X_tr, torch.float32), as_t(y_tr, torch.int64),
                         as_t(X_te, torch.float32), as_t(y_te, torch.int64), t, params0, idx,
                         c["adc_bits"], budget["max_steps"], budget["step_scale"],
                         precision=precision)
    return acc.cpu().numpy(), X_te.shape[1]


def no_ternary(rows: dict) -> np.ndarray:
    """Rows none of whose layers takes ternary weights."""
    if "wprec" not in rows:
        return np.ones(len(rows["seeds"]), bool)
    return np.all(np.asarray(rows["wprec"]) > 0, axis=1)


def _row_key(mask, wb, ab, bs, ep, lr, extra) -> bytes:
    parts = [np.asarray(mask, bool).tobytes()]
    parts += [np.float32(v).tobytes() for v in (wb, ab, lr)]
    parts += [np.int64(v).tobytes() for v in (bs, ep)]
    parts += [np.asarray(e, np.float32).tobytes() for e in extra]
    return b"|".join(parts)


def front_checks(run, state: State, axes) -> tuple[int, float]:
    """(front points whose accuracy is not that of the row trained for
    their genome, the largest relative gap of their area or power to the
    reference's proxy).  With a surrogate screen a front point may hold the
    screen's prediction, even for a genome trained later, so only its cost
    is compared; without one every point has a trained row."""
    c = run.config
    sizes, n_bits = c["layer_sizes"], c["adc_bits"]
    screened = bool(run.traffic.get("search", {}).get("surrogate", False))
    extras = [EXTRA_NAMES[a] for a in axes if a in EXTRA_NAMES]
    bad, worst = 0, 0.0
    for rec in state.searches:
        res = rec["result"]
        if res is None:
            continue
        seen: dict[bytes, list[float]] = {}
        for call in rec["calls"]:
            r = call["rows"]
            n_base = len(ROW_NAMES)
            for i in range(call["P"]):
                key = _row_key(r[0][i], r[1][i], r[2][i], r[3][i], r[4][i], r[5][i],
                               [e[i] for e in r[n_base:]])
                seen.setdefault(key, []).append(float(call["acc"][i]))
        dec = ref.decode_cats(res["front_cats"], axes, len(sizes) - 1)
        for j in range(len(res["front_acc"])):
            mask = np.asarray(res["front_masks"][j], bool).copy()
            mask[:, 0] = True
            extra = [dec[n][j] for n in extras]
            key = _row_key(mask, dec["weight_bits"][j], dec["act_bits"][j],
                           dec["batch_size"][j], dec["epochs"][j], dec["lr"][j], extra)
            if not screened:
                # the program's objective is 1 - acc, kept in float32; the
                # baseline's rows may train the same genome from other seeds
                bad += key not in seen or min(
                    abs(a - float(res["front_acc"][j])) for a in seen[key]) > 1e-6
            if axes == ("adc",):
                area, power = ref.bank_cost(mask, n_bits)
            else:
                area, power = ref.system_cost(
                    mask, n_bits, sizes, dec["weight_bits"][j], dec["act_bits"][j],
                    act_sel=dec.get("act_sel", [None] * (j + 1))[j],
                    wprec=dec.get("wprec", [None] * (j + 1))[j])
            worst = max(worst, abs(res["front_area"][j] - area) / area,
                        abs(res["front_power"][j] - power) / power)
    return bad, worst


def mismatched(acc, acc_ref, n_test: int) -> np.ndarray:
    """Rows whose accuracy differs from the reference's by more than half a test sample."""
    gap = np.abs(np.asarray(acc, np.float64) - np.asarray(acc_ref, np.float64))
    return gap > 0.5 / n_test


def numbers(run, state: State, rows: dict, acc, acc_ref, n_test: int) -> list[tuple[str, float]]:
    """The numbers the check compares, for the accuracies ``acc`` of the
    window's trained ``rows`` against the reference's ``acc_ref``.

    ``acc_mismatch_share``: the share of the rows without a ternary layer
    that :func:`mismatched` finds.  A ternary layer's pre-activations that
    are zero in exact arithmetic come out +-1 ulp with a sign set by the
    order of summation, so such rows part from any other order of the same
    fp32 sums from the first step (``tools/divergence.py`` reads it): they
    are retrained but not counted in the share (PERF.md gives both
    readings).  ``front_acc_mismatch``: front points whose accuracy is no
    row's trained for their genome.  ``front_cost_rel_gap``: the largest
    relative gap of a front point's area or power to the reference proxy's
    (float64 sums in two orders).  The front numbers are the program's
    whatever ``acc`` is: a control retrains rows, it runs no search."""
    plain = no_ternary(rows)
    miss = mismatched(acc, acc_ref, n_test)
    share = float(np.mean(miss[plain])) if plain.any() else 0.0
    bad, cost_gap = front_checks(run, state, _axes(run))
    return [("acc_mismatch_share", share), ("front_acc_mismatch", float(bad)),
            ("front_cost_rel_gap", float(cost_gap))]


def check(run, state: State) -> list[tuple[str, float]]:
    """The program's numbers: every trained row retrained by the fp32
    reference.  The rows, the reference's accuracies and the test-set size
    stay in ``run.records`` for a control to be judged against."""
    rows, acc_prog, seeds = trained_rows(state, _axes(run))
    acc_ref, n_test = reference_accuracies(run, rows, seeds)
    miss = mismatched(acc_prog, acc_ref, n_test)
    run.records.update(rows_checked=int(miss.size), rows_compared=int(no_ternary(rows).sum()),
                       acc_mismatch_share_all=float(np.mean(miss)), checked_rows=rows,
                       checked_seeds=seeds, acc_program=acc_prog, acc_ref=acc_ref,
                       n_test=n_test)
    return numbers(run, state, rows, acc_prog, acc_ref, n_test)


def control_numbers(run, state: State) -> list[tuple[str, float]]:
    """The numbers of the control, after :func:`check`: the same rows
    retrained by the reference with TF32 inputs to every matmul, put in the
    program's place."""
    rec = run.records
    acc, _ = reference_accuracies(run, rec["checked_rows"], rec["checked_seeds"], "tf32")
    rec["acc_control"] = acc
    return numbers(run, state, rec["checked_rows"], acc, rec["acc_ref"], rec["n_test"])
