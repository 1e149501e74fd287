"""The card's idle time inside the program's expert layers, as a share of the traced part.

Each idle instant of the traced part goes to the innermost program span
open then (``attribution``); this is the share that falls in
``model.moe``: the expert layer's host work, its one wait for the groups'
sizes among it.
"""

from cardbench import attribution

UNIT, BETTER, SOURCE = "%", "lower", "program_span"
LAYER, MOVES = "expert layer", "ttft_p95_ms"


def read(run):
    return attribution.idle_share_pct(run, ("model.moe",))
