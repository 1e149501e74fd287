"""Write ``BENCHMARK.json`` from what the harness finds under ``cardbench/``.

    python3 cardbench/manifest.py            # write BENCHMARK.json at the repo root
    python3 cardbench/manifest.py --check    # exit 1 if it differs from the files

Cells come from ``cells/*.json`` (in their ``order``), configurations,
traffic and end-to-end metrics from the files the cells name, and each
per-layer metric from its reader's ``UNIT``, ``BETTER``, ``SOURCE``,
``LAYER`` and ``MOVES``, listed with the cells that report it.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))

from cardbench.harness import BENCH, load_json, load_module, names  # noqa: E402

__all__ = ["build", "main"]


def build(root: Path = BENCH) -> dict:
    settings = json.loads((root / "settings.json").read_text())
    cells = sorted(((load_json("cells", n, root), n) for n in names("cells", ".json", root)),
                   key=lambda cn: (cn[0].get("order", 1 << 30), cn[1]))
    rel = root.name
    configs, workloads, e2e, layer = {}, [], {}, {}
    for cell, name in cells:
        cfg = load_json("configs", cell["config"], root)
        configs.setdefault(cell["config"], {
            "name": cell["config"], "source": cfg["source"],
            "file": f"{rel}/configs/{cell['config']}.json",
            "reduced": cfg["reduced"], "why": cfg["why"]})
        workloads.append({"name": name, "config": cell["config"], "traffic": cell["traffic"],
                          "chips": cell["chips"], "why": cell["why"]})
        for m in ["setup_s", *cell["end_to_end"]]:
            e2e.setdefault(m, []).append(name)
        for m in cell["per_layer"]:
            layer.setdefault(m, []).append(name)
    end_to_end = []
    for m, cells_of in sorted(e2e.items(), key=lambda kv: (kv[0] == "setup_s", kv[0])):
        spec = load_json("end_to_end", m, root)
        entry = {"name": m, "unit": spec["unit"], "better": spec["better"],
                 "bound": spec["bound"], "source": spec["source"]}
        if len(cells_of) < len(workloads):
            entry["workloads"] = cells_of
        end_to_end.append(entry)
    per_layer = []
    for m, cells_of in layer.items():
        r = load_module("metrics", m, root)
        per_layer.append({"name": m, "unit": r.UNIT, "better": r.BETTER, "source": r.SOURCE,
                          "layer": r.LAYER, "moves": r.MOVES, "workloads": cells_of})
    return {"command": settings["command"], "paths": settings["paths"],
            "run_seconds": settings["run_seconds"], "configs": list(configs.values()),
            "workloads": workloads, "end_to_end": end_to_end, "per_layer": per_layer}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    text = json.dumps(build(), indent=2) + "\n"
    path = ROOT / "BENCHMARK.json"
    if "--check" in argv:
        same = path.is_file() and json.loads(path.read_text()) == json.loads(text)
        print("BENCHMARK.json matches the files" if same else "BENCHMARK.json is stale")
        return 0 if same else 1
    path.write_text(text)
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
