"""Share of the rows the window's searches asked for that the genome memo answered.

``n_memo_hits / (n_evaluations + n_memo_hits)`` summed over the searches
completed in the window (``CodesignResult``'s counters).
"""

UNIT, BETTER, SOURCE = "%", "higher", "program_counter"
LAYER, MOVES = "search driver", "search_s"


def read(run):
    done = [s["result"] for s in run.records.get("searches", []) if s["result"] is not None]
    trained = sum(r["n_evaluations"] for r in done)
    hits = sum(r["n_memo_hits"] for r in done)
    if trained + hits == 0:
        return None
    return 100.0 * hits / (trained + hits)
