"""The port's profiling hooks (`srfdet3d_torch/utils/profiling.py`) against
the JAX package's: StepTimer's summary equal to the JAX one's over the same
clock readings (time.perf_counter replaced by a list of readings), warmup
discard and aborted steps included; `trace` writes a Chrome trace on the
CPU that reads back with the profiled ops in it."""

import glob
import json
import time

import pytest
import torch

from srfdet3d_tpu.utils import profiling as jprof
from srfdet3d_torch.utils import profiling as tprof


class Boom(RuntimeError):
    pass


def drive(timer, steps):
    """Each step: (duration in s, aborts?)."""
    for _, abort in steps:
        try:
            with timer:
                if abort:
                    raise Boom()
        except Boom:
            pass
    return timer.summary()


@pytest.mark.parametrize("warmup", [0, 2, 5])
def test_step_timer_summary_matches_jax(monkeypatch, warmup):
    steps = [(0.120, False), (0.080, False), (0.031, True), (0.101, False),
             (0.0995, False), (0.5, True), (0.1042, False), (0.097, False),
             (0.2503, False), (0.0987, False)]
    # enter reads the clock once; exit reads it once, unless the step
    # aborted
    clock, now = [], 10.0
    for dt, abort in steps:
        now += 0.003
        clock.append(now)
        now += dt
        if not abort:
            clock.append(now)
    summaries = []
    for mod, kw in ((jprof, {}), (tprof, {"device": "cpu"})):
        readings = iter(clock)
        monkeypatch.setattr(time, "perf_counter", lambda: next(readings))
        timer = mod.StepTimer(warmup=warmup, **kw)
        summaries.append(drive(timer, steps))
        times = timer.times
    assert summaries[0] == summaries[1]
    kept = [dt for dt, abort in steps if not abort][warmup:]
    assert times == pytest.approx(kept, abs=1e-9)
    if kept:
        assert set(summaries[1]) == {"p50_ms", "p90_ms", "mean_ms",
                                     "steps_per_sec"}


def test_step_timer_empty_and_default_device():
    assert tprof.StepTimer(device="cpu").summary() == {} == \
        jprof.StepTimer().summary()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tprof.StepTimer()


def test_trace_writes_a_readable_trace(tmp_path):
    x = torch.randn(64, 64)
    with tprof.trace(str(tmp_path), device="cpu") as prof:
        for _ in range(3):
            x = torch.relu(x @ x.T) / 64
    names = {e.key for e in prof.key_averages()}
    assert "aten::relu" in names and "aten::mm" in names
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::relu" for e in events)

