"""The traced run: the benchmark's own spans around the detector's stages,
torch.profiler over the window, and the reduction of its trace to what
the per-layer readers (`benchmark/metrics/`) read.

Spans are `record_function` ranges named `bench/<stage>`, opened by forward
pre-hooks and closed by forward hooks on the detector's submodules
(`port.modules`), so they cover each stage's forward; `bench/k3` wraps the
system's submanifold backward call (K3) for the traced window only.  A
kernel belongs to every span whose host interval holds the call that
launched it (matched by the profiler's correlation id, on the same host
thread).
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
PREFIX = "bench/"


class Spans:
    """Forward spans on the detector's stages (and the K3 call) while
    open; removed by close()."""

    def __init__(self, stages: Dict[str, torch.nn.Module], wrap=()):
        self._handles = []
        self._open: Dict[str, list] = defaultdict(list)
        for name, mod in stages.items():
            self._handles.append(mod.register_forward_pre_hook(
                self._enter(name)))
            self._handles.append(mod.register_forward_hook(self._exit(name)))
        self._wrapped = []
        for module, attr, name in wrap:
            fn = getattr(module, attr)
            setattr(module, attr, self._wrap(fn, name))
            self._wrapped.append((module, attr, fn))

    def _enter(self, name):
        def hook(mod, args):
            rf = torch.profiler.record_function(PREFIX + name)
            rf.__enter__()
            self._open[name].append(rf)
        return hook

    def _exit(self, name):
        def hook(mod, args, out):
            self._open[name].pop().__exit__(None, None, None)
        return hook

    @staticmethod
    def _wrap(fn, name):
        def wrapped(*a, **kw):
            with torch.profiler.record_function(PREFIX + name):
                return fn(*a, **kw)
        return wrapped

    def close(self):
        for h in self._handles:
            h.remove()
        for module, attr, fn in self._wrapped:
            setattr(module, attr, fn)


class Trace:
    """The reduced trace of one window."""

    def __init__(self, events: List[dict], window: str = PREFIX + "window"):
        win = [e for e in events if e.get("cat") == "user_annotation"
               and e.get("name") == window]
        if not win:
            raise RuntimeError("the trace holds no window span")
        self.t0 = float(win[0]["ts"])
        self.t1 = self.t0 + float(win[0]["dur"])
        launch = {}
        for e in events:
            if e.get("cat") in LAUNCH_CATS and "args" in e:
                corr = e["args"].get("correlation")
                if corr is not None:
                    launch[corr] = (float(e["ts"]), e.get("tid"))
        spans = defaultdict(list)
        host = []
        for e in events:
            cat = e.get("cat")
            if cat == "user_annotation" and e["name"].startswith(PREFIX):
                spans[e.get("tid")].append(
                    (float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"][len(PREFIX):]))
            if cat in HOST_CATS and "dur" in e:
                host.append((float(e["ts"]), float(e["dur"]), e["name"]))
        self.device = []          # (name, start us, dur us, spans)
        for e in events:
            if e.get("cat") not in DEVICE_CATS or "dur" not in e:
                continue
            ts, dur = float(e["ts"]), float(e["dur"])
            if ts + dur < self.t0 or ts > self.t1 + 5e6:
                continue
            corr = e.get("args", {}).get("correlation")
            where = launch.get(corr)
            names = set()
            if where is not None:
                lt, tid = where
                if not self.t0 <= lt <= self.t1:
                    continue
                names = {n for s, t, n in spans.get(tid, ()) if s <= lt <= t}
            elif ts > self.t1:
                continue
            self.device.append((e["name"], ts, dur, names,
                                e.get("cat") == "kernel"))
        self.host = sorted(host)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def intervals(self):
        """Merged device busy intervals (us), clipped to the window's
        start; the device's work launched in the window may end after the
        host's window span closes, and counts in full."""
        iv = sorted((max(ts, self.t0), ts + dur)
                    for _, ts, dur, _, _ in self.device if ts + dur > self.t0)
        merged = []
        for s, e in iv:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.intervals()) * 1e-6

    def launches(self) -> int:
        return sum(1 for d in self.device if d[4])

    def span_s(self, name: str, kernels: Optional[tuple] = None) -> float:
        """Device seconds launched inside span `name` (optionally only the
        kernels whose name holds one of `kernels`)."""
        tot = 0.0
        for kname, _, dur, names, _ in self.device:
            if name in names and (kernels is None or
                                  any(k in kname for k in kernels)):
                tot += dur
        return tot * 1e-6

    def named_s(self, kernels: tuple) -> float:
        return sum(dur for kname, _, dur, _, _ in self.device
                   if any(k in kname for k in kernels)) * 1e-6

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps inside the window, each named by the innermost host
        operation running when it began."""
        by_name = defaultdict(float)
        for kname, _, dur, _, _ in self.device:
            by_name[kname] += dur * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        iv = self.intervals()
        gaps = []
        prev = self.t0
        for s, e in iv:
            if s > prev:
                gaps.append((s - prev, prev))
            prev = max(prev, e)
        if self.t1 > prev:
            gaps.append((self.t1 - prev, prev))
        gaps.sort(reverse=True)
        starts = [h[0] for h in self.host]
        named = []
        for length, at in gaps[:top]:
            i = bisect.bisect_right(starts, at)
            best = None
            for ts, dur, name in self.host[max(0, i - 2000):i]:
                if ts <= at <= ts + dur and (best is None or dur < best[0]):
                    best = (dur, name)
            named.append([best[1] if best else "(no host op)",
                          length * 1e-6])
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}


def profile(fn) -> Trace:
    """Run fn() under torch.profiler (CPU and CUDA) inside the window
    span, export the trace to a temporary file, and reduce it."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(PREFIX + "window"):
            fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return Trace(events)
