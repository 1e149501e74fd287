"""What the benchmark loads: no JAX, no JAX package, and no port in the references."""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from cardbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "cardbench"

RUN_TINY = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
from cardbench.tests import tiny
from cardbench import harness
r, out = tiny.run({cell!r})
for name in r.cell["per_layer"]:
    harness.load_module("metrics", name)
print(json.dumps({{"correct": out["correct"], "modules": sorted(sys.modules)}}))
"""


@pytest.mark.parametrize("cell", sorted(tiny.OVERRIDES))
def test_a_cell_loads_no_jax(cell):
    """A tiny run of the cell (listed or parked) on the CPU, in a process of
    its own: harness, driver, metric readers, reference and the port's
    modules they reach."""
    code = RUN_TINY.format(root=str(ROOT), src=str(ROOT / "src"), cell=cell)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"]
    tops = {m.split(".")[0] for m in out["modules"]}
    assert not tops & {"jax", "jaxlib", "flax", "repro"}
    assert "repro_torch" in tops  # the port itself was measured


def test_references_load_no_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import cardbench.reference.printed_mlp, cardbench.reference.internlm2\n"
            "import cardbench.reference.precision, cardbench.counts\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    tops = set(eval(proc.stdout.strip().splitlines()[-1]))
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_no_file_reads_the_jax_benchmarks():
    pattern = re.compile(r"""["'/]benchmarks\b|\bimport benchmarks|from benchmarks""")
    for path in BENCH.rglob("*.py"):
        if path.name == Path(__file__).name:
            continue
        assert not pattern.search(path.read_text()), path
    for path in BENCH.rglob("*.json"):
        assert "benchmarks/" not in path.read_text(), path
