"""The card's idle time inside the program's latent attention blocks, as a share of the traced part.

Each idle instant of the traced part goes to the innermost program span
open then (``attribution``); this is the share that falls in
``model.mla``: the host's work between the block's launches.
"""

from cardbench import attribution

UNIT, BETTER, SOURCE = "%", "lower", "program_span"
LAYER, MOVES = "latent attention layer", "ttft_p95_ms"


def read(run):
    return attribution.idle_share_pct(run, ("model.mla",))
