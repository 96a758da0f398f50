"""The port's profiling hooks (`srfdet3d_torch/utils/profiling.py`) against
the JAX package's: StepTimer's summary equal to the JAX one's over the same
clock readings (time.perf_counter replaced by a list of readings), warmup
discard and aborted steps included; `trace` writes a Chrome trace on the
CPU that reads back with the profiled ops in it.

The port's own spans and counters on the tiny config: spans nest under
predict and train_step with their parent, frame or step id and counter
deltas while a profiler session is open; the Chrome trace holds them
around the ops they enclose; with no session open they touch neither
`record_function` nor CUDA events and record nothing; an export under an
open session holds no profiler node; the counters reset and read."""

import glob
import json
import sys
import threading
import time

import pytest
import torch

from srfdet3d_tpu.utils import profiling as jprof
from srfdet3d_torch.configs import get_config
from srfdet3d_torch.models.detector import SRFDet
from srfdet3d_torch.tools.export import synthetic_batch
from srfdet3d_torch.train.trainer import make_optimizer, train_step
from srfdet3d_torch.utils import profiling


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
    for mod, kw in ((jprof, {}), (profiling, {"device": "cpu"})):
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
    assert profiling.StepTimer(device="cpu").summary() == {} == \
        jprof.StepTimer().summary()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            profiling.StepTimer()


def test_trace_writes_a_readable_trace(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path), device="cpu") as prof:
        for _ in range(3):
            x = torch.relu(x @ x.T) / 64
    names = {e.key for e in prof.key_averages()}
    assert "aten::relu" in names and "aten::mm" in names
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::relu" for e in events)


STAGES = ["voxelize", "encoder", "bev", "head", "decode"]
PHASES = ["forward", "loss_ota", "backward", "optimizer"]


@pytest.fixture(scope="module")
def tiny():
    cfg = get_config("tiny")
    torch.manual_seed(0)
    net = SRFDet(cfg, device="cpu")
    return dict(net=net, opt=make_optimizer(net, cfg, 100),
                batch=synthetic_batch(cfg, 1, seed=0),
                train=synthetic_batch(cfg, 2, with_gt=True, seed=1),
                heads=cfg.head.num_heads)


@pytest.fixture(scope="module")
def traced(tiny, tmp_path_factory):
    """A predict and a train step under trace(), inside a window range;
    the counters read before, between and after."""
    log_dir = tmp_path_factory.mktemp("trace")
    snaps = []
    with profiling.trace(str(log_dir), "cpu"):
        with torch.profiler.record_function("test/window"):
            snaps.append(profiling.snapshot())
            tiny["net"].predict(tiny["batch"])
            snaps.append(profiling.snapshot())
            train_step(tiny["net"], tiny["opt"], tiny["train"],
                       torch.Generator().manual_seed(0))
            snaps.append(profiling.snapshot())
    files = glob.glob(str(log_dir / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    return dict(recs=profiling.recorded(), snaps=snaps, events=events)


def _children(recs, i):
    return [r.name for r in recs if r.parent == i]


def test_spans_nest_under_predict_and_train_step(tiny, traced):
    recs, snaps = traced["recs"], traced["snaps"]
    tops = [i for i, r in enumerate(recs) if r.parent is None]
    assert [recs[i].name for i in tops] == ["predict", "train_step"]
    frame, step = tops
    assert recs[frame].frame != recs[step].frame
    for i, r in enumerate(recs):
        top = frame if i < step else step
        assert r.frame == recs[top].frame
        assert r.t0_ns <= r.t1_ns
        if r.parent is not None:
            p = recs[r.parent]
            assert p.t0_ns <= r.t0_ns and r.t1_ns <= p.t1_ns
        assert r.stream_ms is None          # no CUDA here
    assert _children(recs, frame) == STAGES
    assert _children(recs, step) == PHASES
    forward = recs.index(next(r for r in recs if r.name == "forward"))
    assert _children(recs, forward) == STAGES[:-1]
    head = [i for i, r in enumerate(recs) if r.name == "head"]
    for i in head:
        refines = [j for j, r in enumerate(recs) if r.parent == i]
        assert [recs[j].name for j in refines] == ["refine"] * tiny["heads"]
        for j in refines:
            assert _children(recs, j) == ["roi_align"]
    backward = PHASES.index("backward")
    back = [i for i, r in enumerate(recs) if r.parent == step][backward]
    kernels = _children(recs, back)
    assert kernels and set(kernels) == {"k3", "k4", "k5"}
    # a span's deltas are the counters' moves over it
    for i, (a, b) in zip(tops, zip(snaps, snaps[1:])):
        moved = {k: v - a.get(k, 0) for k, v in b.items()
                 if v != a.get(k, 0)}
        assert recs[i].counts == moved
        assert recs[i].counts["host_sync"] > 0
        inner = sum(recs[j].counts.get("host_sync", 0)
                    for j, r in enumerate(recs) if r.parent == i)
        assert inner == recs[i].counts["host_sync"]


def test_chrome_trace_holds_the_spans(traced):
    events = [e for e in traced["events"] if "dur" in e]
    window = next(e for e in events if e["name"] == "test/window")
    t0, t1 = window["ts"], window["ts"] + window["dur"]
    spans = [e for e in events if e["name"].startswith(profiling.PREFIX)]
    names = {e["name"][len(profiling.PREFIX):] for e in spans}
    assert names == {r.name for r in traced["recs"]}
    assert all(t0 <= e["ts"] and e["ts"] + e["dur"] <= t1 for e in spans)
    vox = next(e for e in spans if e["name"] == "srfdet/voxelize")
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and vox["ts"] <= e["ts"] and e["ts"] + e["dur"] <=
           vox["ts"] + vox["dur"]]
    assert any(e["name"].startswith("aten::") for e in ops)
    pred = next(e for e in spans if e["name"] == "srfdet/predict")
    assert pred["ts"] <= vox["ts"] and (vox["ts"] + vox["dur"] <=
                                        pred["ts"] + pred["dur"])


def test_spans_off_record_nothing(tiny, monkeypatch):
    """No profiler session: predict and a train step run with
    `record_function` and CUDA events made to raise."""
    def boom(*args, **kwargs):
        raise AssertionError("a span recorded with no session open")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    before = len(profiling.recorded())
    tiny["net"].predict(tiny["batch"])
    train_step(tiny["net"], tiny["opt"], tiny["train"],
               torch.Generator().manual_seed(1))
    assert len(profiling.recorded()) == before
    assert profiling.span("predict") is profiling.span("predict")


def test_spans_off_while_exporting():
    """An export under an open profiler session records no span and
    holds no profiler node."""
    class Twice(torch.nn.Module):
        @profiling.span("twice")
        def forward(self, x):
            with profiling.span("inner"):
                return x * 2

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        before = len(profiling.recorded())
        prog = torch.export.export(Twice(), (torch.randn(3),), strict=False)
        assert len(profiling.recorded()) == before
    targets = [str(n.target) for n in prog.graph.nodes]
    assert targets == ["x", "aten.mul.Tensor", "output"]


def test_a_span_on_another_thread_takes_the_open_span_as_parent(tmp_path):
    """As K3-K5 on autograd's backward thread: a span opened on a thread
    with none open sits under the innermost span of the thread that holds
    the top-level one, in its frame."""
    @profiling.span("worker")
    def work():
        with profiling.span("leaf"):
            pass

    with profiling.trace(str(tmp_path), "cpu"):
        with profiling.span("top"), profiling.span("mid"):
            t = threading.Thread(target=work)
            t.start()
            t.join()
        work()
    recs = profiling.recorded()
    names = [(r.name, r.parent, r.frame) for r in recs]
    top, mid = recs[0].frame, recs[1].frame
    assert names[:4] == [("top", None, top), ("mid", 0, top),
                         ("worker", 1, top), ("leaf", 2, top)]
    # after the top-level span closed, a span opens a frame of its own
    assert names[4][:2] == ("worker", None) and names[4][2] != mid
    assert names[5] == ("leaf", 4, names[4][2])
    assert recs[2].thread != recs[0].thread


def test_counters_lose_no_count_across_threads():
    """Eight threads (autograd's device threads count beside the caller)
    add to one counter with the interpreter switching every microsecond:
    no add is lost."""
    profiling.reset("stress")
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [
            profiling.count("stress") for _ in range(2000)])
            for _ in range(8)]
        for t in workers:
            t.start()
        for t in workers:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in workers)
    assert profiling.snapshot()["stress"] == 8 * 2000
    profiling.reset("stress")


def test_counters_reset_and_snapshot():
    profiling.reset()
    assert profiling.snapshot() == {}
    profiling.count("host_sync")
    profiling.count("host_sync", 2)
    profiling.count("hungarian.host_ms", 1.5)
    profiling.count("hungarian.solves", 4)
    snap = profiling.snapshot()
    assert snap == {"host_sync": 3, "hungarian.host_ms": 1.5,
                    "hungarian.solves": 4}
    snap["host_sync"] = 0                   # a copy
    profiling.reset("hungarian.")
    assert profiling.snapshot() == {"host_sync": 3}
    profiling.reset()
    assert profiling.snapshot() == {}
