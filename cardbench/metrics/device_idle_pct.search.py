"""Share of the traced part of the window in which no operation ran on the card.

From the profiler's device records: one minus the union of their intervals
over the traced part's length.
"""

UNIT, BETTER, SOURCE = "%", "lower", "device_trace"
LAYER, MOVES = "device", "search_s"


def read(run):
    if run.trace.t0 is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
