"""Nothing a benchmark run loads is JAX or the JAX package: a run of every
cell (tiny, on the CPU) in a fresh process, then its sys.modules, compared
by whole top-level names; and the reference imports nothing of the
system."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "srfdet3d_tpu"}

RUN_ALL = """
import json, sys
sys.path.insert(0, {root!r})
from benchmark import run
from benchmark.registry import Registry
from benchmark.tests.bench_common import tiny_tweak
import benchmark.calibrate, benchmark.trace
reg = Registry()
for cell in reg.spec["workloads"]:
    run.run(cell["name"], 3, 0.5, False, device="cpu",
            tweak=tiny_tweak("LC" in cell["config"]))
    for m in reg.per_layer(cell):
        reg.reader(m["name"])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

REF_ONLY = """
import json, sys
sys.path.insert(0, {root!r})
import benchmark.reference.models.detector, benchmark.reference.train.trainer
import benchmark.reference.models.losses
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(code: str):
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=600,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_of_every_cell_loads_no_jax():
    loaded = _top_level(RUN_ALL)
    assert "srfdet3d_torch" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_the_reference_imports_nothing_of_the_system():
    loaded = _top_level(REF_ONLY)
    assert not loaded & (FORBIDDEN | {"srfdet3d_torch"})


def test_the_run_refuses_forbidden_modules(monkeypatch):
    from benchmark import run
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert run.forbidden_modules() == ["jaxlib"]
    monkeypatch.delitem(sys.modules, "jaxlib")
    assert "srfdet3d_tpu" not in run.forbidden_modules()


def test_main_prints_no_result_when_the_check_loads_jax(monkeypatch,
                                                         capsys):
    """main() looks at sys.modules again once the run (the reference and
    the metric readers with it) is done, before the result is printed."""
    import os

    import torch

    from benchmark import run

    def loads_jax(*args, **kwargs):
        monkeypatch.setitem(sys.modules, "jax", sys)
        return {"correct": True}
    monkeypatch.setattr(run, "run", loads_jax)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(os, "sched_setaffinity", lambda *a: None)
    monkeypatch.setattr(torch, "set_num_threads", lambda n: None)
    rc = run.main(["--workload", "nusc_L.predict.stream", "--seed", "1",
                   "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""
