"""Every name in BENCHMARK.json resolves to its file, and a cell added as
files plus one workloads entry is found with no other edit."""

from __future__ import annotations

import json
import shutil

from benchmark.registry import ROOT, Registry


def test_every_name_resolves():
    reg = Registry()
    spec = reg.spec
    for c in spec["configs"]:
        assert (ROOT / c["file"]).is_file(), c["file"]
        assert c["file"].startswith(tuple(p + "/" for p in spec["paths"]))
    for w in spec["workloads"]:
        assert reg.traffic_path(w["traffic"]).is_file()
        assert reg.limits_path(w["name"]).is_file()
        assert reg.config(w)["name"] == w["config"]
        assert reg.traffic(w)["mode"] in ("predict", "train")
        assert reg.per_layer(w), w["name"]
    for m in spec["per_layer"]:
        assert callable(reg.reader(m["name"]))
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}


def test_a_cell_added_as_files_is_found(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    traffic = json.loads((tmp_path / "benchmark/traffic/lidar_stream.json")
                         .read_text())
    traffic["scene"]["sweeps"] = 1
    (tmp_path / "benchmark/traffic/lidar_sweep1.json").write_text(
        json.dumps(traffic))
    (tmp_path / "benchmark/limits/nusc_L.predict.sweep1.json").write_text(
        json.dumps({"head_gap": 1e-4, "answers_wrong": 0}))
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "nusc_L.predict.sweep1",
                              "config": "srfdet_voxel_nusc_L",
                              "traffic": "lidar_sweep1", "chips": 1,
                              "why": "one sweep a frame"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    reg = Registry(tmp_path)
    cell = reg.cell("nusc_L.predict.sweep1")
    assert reg.traffic(cell)["scene"]["sweeps"] == 1
    assert reg.limits(cell)["head_gap"] == 1e-4
    names = {m["name"] for m in reg.end_to_end(cell)}
    assert "setup_s" in names and "peak_mem_gib" in names
    assert reg.per_layer(cell) == []        # no metric lists it yet
