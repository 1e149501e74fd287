"""The harness as data: new cells, configurations and metrics are files alone."""

import json
import re
import shutil
from pathlib import Path

import pytest

from cardbench import harness, manifest
from cardbench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

NEW_METRIC = '''"""Rows the window's searches trained (a test's metric)."""

UNIT, BETTER, SOURCE = "rows", "higher", "program_counter"
LAYER, MOVES = "search driver", "search_s"


def read(run):
    return sum(c["P"] for s in run.records["searches"] for c in s["calls"])
'''


@pytest.fixture()
def copy(tmp_path):
    dst = tmp_path / "cardbench"
    shutil.copytree(ROOT / "cardbench", dst, ignore=shutil.ignore_patterns("__pycache__"))
    return dst


def test_new_files_are_found_by_name(copy):
    before = {p: p.read_bytes() for p in copy.rglob("*") if p.is_file()}
    cell = json.loads((copy / "cells" / "cardio-search.json").read_text())
    config = json.loads((copy / "configs" / "printed-mlp-cardio.json").read_text())
    (copy / "configs" / "printed-mlp-cardio-b.json").write_text(json.dumps(config))
    cell.update(config="printed-mlp-cardio-b", order=99,
                per_layer=[*cell["per_layer"], "rows_trained"])
    (copy / "cells" / "cardio-search-b.json").write_text(json.dumps(cell))
    (copy / "metrics" / "rows_trained.py").write_text(NEW_METRIC)
    assert all(p.read_bytes() == b for p, b in before.items())  # nothing edited

    bench = manifest.build(copy)
    assert bench["workloads"][-1]["name"] == "cardio-search-b"
    assert "printed-mlp-cardio-b" in [c["name"] for c in bench["configs"]]
    assert {"name": "rows_trained", "unit": "rows", "better": "higher",
            "source": "program_counter", "layer": "search driver", "moves": "search_s",
            "workloads": ["cardio-search-b"]} in bench["per_layer"]

    r, out = tiny.run("cardio-search-b", root=copy, overrides=tiny.OVERRIDES["cardio-search"],
                      trace=True)
    assert out["correct"]
    assert out["metrics"]["rows_trained"]["value"] > 0


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(copy, trace):
    from cardbench import harness as h
    import time
    import torch

    torch.set_num_threads(1)
    run = h.Run("cardio-search", 5, 0.01, trace, device="cpu", root=copy,
                overrides=tiny.OVERRIDES["cardio-search"])
    out = h.run_cell(run, time.time())
    keys = list(out)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"  # each number compared beside its limit, last
    assert set(keys) <= {"correct", "attempted", "failed", "metrics", "device", "breakdown",
                         "checks"}
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    want = (set(run.cell["per_layer"]) if trace
            else {"setup_s", *run.cell["end_to_end"]})
    assert set(out["metrics"]) <= want
    if not trace:
        assert set(out["metrics"]) == want
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}


def test_benchmark_json_is_the_files():
    assert json.loads((ROOT / "BENCHMARK.json").read_text()) == manifest.build()


def test_names_and_units():
    bench = manifest.build()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[group]:
            assert NAME.match(entry["name"]), entry["name"]
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
            for text in (entry.get("why"), entry.get("layer"), entry.get("source")):
                if text is not None:
                    assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    for c in bench["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    names = [e["name"] for g in ("end_to_end", "per_layer") for e in bench[g]]
    assert len(names) == len(set(names))
    e2e = {e["name"] for e in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
    for e in bench["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25
    assert len(json.dumps(bench)) <= 64 * 1024
    for path in (ROOT / "cardbench").rglob("*"):
        rel = path.relative_to(ROOT).as_posix()
        if "__pycache__" not in rel:
            assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel


def test_every_named_file_exists():
    for cell in harness.names("cells", ".json"):
        c = harness.load_json("cells", cell)
        harness.load_json("configs", c["config"])
        t = harness.load_json("traffic", c["traffic"])
        harness.load_module("drivers", t["driver"])
        for m in c["per_layer"]:
            harness.load_module("metrics", m)
        for m in c["end_to_end"]:
            harness.load_json("end_to_end", m)
