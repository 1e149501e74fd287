"""Each cell for 10 s on the card, as the driver runs it (skips without a card).

    python3 -m pytest -q cardbench/tests/test_card_smoke.py    # on a machine with an H100
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from cardbench import harness

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.card
@pytest.mark.parametrize("cell", harness.names("cells", ".json"))
def test_cell_runs_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark's cells run on the card only")
    proc = subprocess.run([sys.executable, "cardbench/run.py", "--workload", cell, "--seed",
                           "4242424242", "--seconds", "10", "--trace", "0"],
                          capture_output=True, text=True, timeout=1200, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["failed"] == 0


def test_no_card_no_result(monkeypatch, capsys):
    """Without a card the benchmark exits non-zero and prints no result line."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "cardio-search", "--seed", "1", "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_without_the_program_no_result(tmp_path):
    """In a directory with only BENCHMARK.json and cardbench/, a run fails and prints nothing."""
    import shutil

    shutil.copytree(ROOT / "cardbench", tmp_path / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    proc = subprocess.run([sys.executable, "cardbench/run.py", "--workload", "cardio-search",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=600, cwd=tmp_path,
                          env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0 and proc.stdout.strip() == ""
