"""The readers of the system's own record (`benchmark/program_spans.py`
and the metrics that use it) on a fabricated record and trace; the same
readers on a real record of a tiny predict and step on the CPU; and, on
the card, the system's `host_sync` counter against every sync torch
reports over flagship and LC frames and flagship steps (run on the chip
with `python3 -m pytest benchmark/tests -m card`)."""

from __future__ import annotations

import types
import warnings

import pytest
import torch

from benchmark import cells, port, program_spans, scene
from benchmark.registry import Registry
from benchmark.trace import Trace

from .bench_common import need_card

PREDICT = ("voxelize_stream_ms.predict", "decode_nms_stream_ms.predict",
           "host_syncs_per_frame.predict")
TRAIN = ("forward_stream_ms.train", "loss_ota_stream_ms.train",
         "backward_stream_ms.train", "optimizer_stream_ms.train",
         "k3_stream_ms.train", "k4_stream_ms.train", "k5_stream_ms.train",
         "host_syncs_per_step.train")


def _rec(name, parent, ms=None, syncs=0):
    return types.SimpleNamespace(name=name, parent=parent, stream_ms=ms,
                                 counts={"host_sync": syncs} if syncs else {})


def _fabricated():
    """Two frames and two steps: every stage once a frame, phases once a
    step, two K3 spans and one K4 and K5 a step (on the backward)."""
    recs = []

    def add(name, parent, ms=None, syncs=0):
        recs.append(_rec(name, parent, ms, syncs))
        return len(recs) - 1
    for f in range(2):
        top = add("predict", None, 100.0 + f, syncs=90 + f)
        add("voxelize", top, 2.0 + f)
        head = add("head", top, 10.0)
        add("refine", head, 2.0)
        add("decode", top, 4.0 + 2 * f)
    for s in range(2):
        top = add("train_step", None, 300.0, syncs=98 + 2 * s)
        add("forward", top, 120.0 + s)
        add("loss_ota", top, 30.0)
        back = add("backward", top, 140.0)
        add("k3", back, 5.0)
        add("k3", back, 7.0)
        add("k4", back, 1.5)
        add("k5", back, 0.5 + s)
        add("optimizer", top, 8.0)
    return recs


def _read(name, mode, trace=None):
    ctx = types.SimpleNamespace(mode=mode, trace=trace)
    return Registry().reader(name)(ctx)


def test_readers_on_a_fabricated_record(monkeypatch):
    monkeypatch.setattr(program_spans, "records", _fabricated)
    got = {n: _read(n, "predict") for n in PREDICT}
    assert got == {"voxelize_stream_ms.predict": 2.5,
                   "decode_nms_stream_ms.predict": 5.0,
                   "host_syncs_per_frame.predict": 90.5}
    got = {n: _read(n, "train") for n in TRAIN}
    assert got == {"forward_stream_ms.train": 120.5,
                   "loss_ota_stream_ms.train": 30.0,
                   "backward_stream_ms.train": 140.0,
                   "optimizer_stream_ms.train": 8.0,
                   "k3_stream_ms.train": 12.0, "k4_stream_ms.train": 1.5,
                   "k5_stream_ms.train": 1.0,
                   "host_syncs_per_step.train": 99.0}
    # each reads in its own mode only
    assert all(_read(n, "train") is None for n in PREDICT)
    assert all(_read(n, "predict") is None for n in TRAIN)


def test_readers_give_none_without_the_record(monkeypatch):
    """A system without the record (the parent of the change that added
    it) or a run off the card (no stream ms) reads nothing and raises
    nothing."""
    from srfdet3d_torch.utils import profiling
    monkeypatch.delattr(profiling, "recorded")
    assert program_spans.records() is None
    assert all(_read(n, "predict") is None for n in PREDICT)
    assert all(_read(n, "train") is None for n in TRAIN)
    monkeypatch.setattr(program_spans, "records", lambda: [
        _rec(r.name, r.parent, None, sum(r.counts.values()))
        for r in _fabricated()])
    assert _read("voxelize_stream_ms.predict", "predict") is None
    assert _read("host_syncs_per_step.train", "train") == 99.0


def _event(cat, name, ts, dur, tid=1, corr=None):
    e = {"cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_idle_in_predict_on_a_fabricated_trace():
    """Window 0-100 us; kernels busy 10-20, 30-40 and 70-80; predict holds
    the host 5-45 and 60-85.  Idle: 0-10, 20-30, 40-70, 80-100 (70 us);
    inside predict: 5-10, 20-30, 40-45, 60-70, 80-85 (35 us): 50%."""
    events = [_event("user_annotation", "bench/window", 0, 100),
              _event("user_annotation", "srfdet/predict", 5, 40),
              _event("user_annotation", "srfdet/predict", 60, 25)]
    for i, (s, e) in enumerate(((10, 20), (30, 40), (70, 80))):
        events.append(_event("cuda_runtime", "cudaLaunchKernel", s - 2, 1,
                             corr=i))
        events.append(_event("kernel", f"k{i}", s, e - s, tid=7, corr=i))
    trace = Trace(events)
    got = _read("idle_in_predict_pct.predict", "predict", trace)
    assert got == pytest.approx(50.0)
    # a trace without the system's range reads nothing
    bare = Trace([e for e in events if e["name"] != "srfdet/predict"])
    assert _read("idle_in_predict_pct.predict", "predict", bare) is None
    assert _read("idle_in_predict_pct.predict", "train", trace) is None


def test_idle_by_innermost_span():
    """The same trace with a `voxelize` range at 20-25 inside the first
    predict: idle 0-5, 45-60 and 85-100 outside every range (35 us),
    20-25 in voxelize (5), the rest of the idle inside predict (30)."""
    events = [_event("user_annotation", "bench/window", 0, 100),
              _event("user_annotation", "srfdet/predict", 5, 40),
              _event("user_annotation", "srfdet/voxelize", 20, 5),
              _event("user_annotation", "srfdet/predict", 60, 25)]
    for i, (s, e) in enumerate(((10, 20), (30, 40), (70, 80))):
        events.append(_event("cuda_runtime", "cudaLaunchKernel", s - 2, 1,
                             corr=i))
        events.append(_event("kernel", f"k{i}", s, e - s, tid=7, corr=i))
    got = program_spans.idle_by_span(Trace(events))
    assert got == pytest.approx({"(none)": 35e-6, "voxelize": 5e-6,
                                 "predict": 30e-6})


def test_readers_on_a_real_cpu_record(tmp_path):
    """A tiny predict and train step under the profiler on the CPU: the
    counters read per frame and step, the stream ms (no CUDA) read
    nothing."""
    from srfdet3d_torch.configs import get_config
    from srfdet3d_torch.models.detector import SRFDet
    from srfdet3d_torch.tools.export import synthetic_batch
    from srfdet3d_torch.utils import profiling
    cfg = get_config("tiny")
    torch.manual_seed(0)
    net = SRFDet(cfg, device="cpu")
    opt = port.optimizer(net, cfg, 10)
    batch = synthetic_batch(cfg, 1, seed=0)
    train = synthetic_batch(cfg, 2, with_gt=True, seed=1)
    with profiling.trace(str(tmp_path), "cpu"):
        before = profiling.snapshot().get("host_sync", 0)
        net.predict(batch)
        frame = profiling.snapshot()["host_sync"] - before
        port.train_step(net, opt, train, torch.Generator().manual_seed(0))
        step = profiling.snapshot()["host_sync"] - before - frame
    assert _read("host_syncs_per_frame.predict", "predict") == frame > 0
    assert _read("host_syncs_per_step.train", "train") == step > 0
    assert _read("k3_stream_ms.train", "train") is None


def _syncs_of(fn):
    """(torch's sync warnings, the system's host_sync count) over fn()."""
    from srfdet3d_torch.utils import profiling
    torch.cuda.synchronize()
    before = profiling.snapshot().get("host_sync", 0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    seen = sum("called a synchronizing CUDA operation" in str(w.message)
               for w in caught)
    return seen, profiling.snapshot().get("host_sync", 0) - before


@pytest.mark.card
@pytest.mark.parametrize("workload", ["nusc_L.predict.stream",
                                      "nusc_L.train.b6",
                                      "nusc_LC.predict.stream"])
def test_host_sync_counts_every_sync_torch_reports(workload):
    need_card()
    reg = Registry()
    cell = reg.cell(workload)
    doc, traffic = reg.config(cell), reg.traffic(cell)
    dev = torch.device("cuda")
    seed = 2 ** 33 + 20261019
    port.system()
    port.build_kernels()
    net = port.model(port.config(doc), seed, dev)
    pool = scene.make_pool(traffic, doc, seed, dev)
    if traffic["mode"] == "predict":
        run = cells.PredictCell(net, pool, dev, seed, 0.0)
        run.warm()

        def one(i):
            batch = cells.to_device(pool[i % len(pool)], cells.INPUT_KEYS,
                                    dev)
            return lambda: net.predict(batch)
    else:
        run = cells.TrainCell(port.config(doc), net, pool, dev, seed)
        run.step()

        def one(i):
            return run.step
    for i in range(3):
        seen, counted = _syncs_of(one(i))
        assert seen > 0 and counted == seen, (i, seen, counted)
    run.close()
