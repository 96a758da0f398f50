"""Finds a cell's pieces by the names BENCHMARK.json gives, so that a cell
is added by adding files and one `workloads` entry:

  - configuration: the file its `configs` entry names;
  - traffic mix: `benchmark/traffic/<traffic>.json`, read by scene.py and
    cells.py (its `mode` picks the kind of cell);
  - per-layer metric: `benchmark/metrics/<metric>.py`, whose read(ctx)
    returns the number or None;
  - the limits of the cell's correctness numbers:
    `benchmark/limits/<workload>.json`.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Registry:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.here = self.root / "benchmark"

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, cell: dict) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == cell["config"]:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {cell['config']!r} in BENCHMARK.json")

    def traffic(self, cell: dict) -> dict:
        return json.loads(self.traffic_path(cell["traffic"]).read_text())

    def traffic_path(self, name: str) -> Path:
        return self.here / "traffic" / f"{name}.json"

    def limits(self, cell: dict) -> Dict[str, float]:
        return json.loads(self.limits_path(cell["name"]).read_text())

    def limits_path(self, name: str) -> Path:
        return self.here / "limits" / f"{name}.json"

    def metric_path(self, name: str) -> Path:
        return self.here / "metrics" / f"{name}.py"

    def end_to_end(self, cell: dict):
        """The cell's end-to-end metrics (those listing it, or listing no
        cells)."""
        return [m for m in self.spec["end_to_end"]
                if cell["name"] in m.get("workloads", [cell["name"]])]

    def per_layer(self, cell: dict):
        """The per-layer metrics read in this cell: those that list it, and
        those with no list whose moved metric the cell reports."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.spec["per_layer"]
                if (cell["name"] in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]

    def reader(self, name: str):
        path = self.metric_path(name)
        spec = importlib.util.spec_from_file_location(
            "benchmark_metric_" + name.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
