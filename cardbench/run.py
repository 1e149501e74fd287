"""Run one cell of the port's benchmark once, on the card, and print its result line.

    python3 cardbench/run.py --workload cardio-search --seed 7 --seconds 30 --trace 0

The benchmark measures ``repro_torch`` (the PyTorch/CUDA port, under
``src/``) and nothing else; run it from the root of a checkout.  The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``, each number the output check compared beside its limit.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

if __name__ == "__main__":
    _T_IMPORT = time.time()
    _ROOT = Path(__file__).resolve().parent.parent
    sys.path[:0] = [str(_ROOT), str(_ROOT / "src")]
    from cardbench import harness

    sys.exit(harness.main())
