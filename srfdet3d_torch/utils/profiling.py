"""Profiling hooks (the JAX package's `utils/profiling.py`): a trace of the
enclosed steps with torch.profiler, a step timer, and the port's own spans
and counters.

    with trace("work_dirs/trace", device):
        for batch in batches:
            train_step(...)
    spans = recorded()  # the port's spans in the trace, with stream ms

    timer = StepTimer(warmup=2, device=device)
    for batch in batches:
        with timer:
            train_step(...)
    timer.summary()     # p50_ms, p90_ms, mean_ms, steps_per_sec

Spans.  `span(name)`, a context manager or a decorator, marks a stage of
the port (`srfdet/<name>`).  It records exactly while a torch.profiler
session is open (`trace()`, or any other `torch.profiler.profile`), and
never while a program is exported or compiled; otherwise it costs one
check.  A recorded span opens a `record_function` range, so it sits in
the profiler's trace beside the kernels it launches, on their clock, and
keeps a `SpanRecord`: its parent, the top-level span (a frame or a step)
it belongs to, its host interval, its stream ms (CUDA events on the
current stream: the card's time from reaching its start to reaching its
end) and the counters' deltas over it.  Spans nest per thread; a span
opened on another thread (autograd's backward thread: K3, K4, K5) takes
the innermost open span of the thread that opened the top-level one as
its parent.  `trace()` clears the record when it opens; `recorded()`
reads it.

Counters.  `count(name, n)` adds to a named counter, always (the card
checks read the kernel launch counts with no profiler open); `snapshot()`
reads them, `reset()` zeroes them.  `host_sync` counts the host syncs of
predict and the train step on a card: each read of a device value on the
host (NMS's loop predicate, OTA's, an `int()`) and each copy from host
memory that waits for the stream.  The sites count on the CPU too, where
nothing waits.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import threading
import time
from typing import Dict, Iterator, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

from .. import resolve_device

PREFIX = "srfdet/"


@contextlib.contextmanager
def trace(log_dir: str, device=None) -> Iterator[torch.profiler.profile]:
    """torch.profiler over the enclosed steps: CPU activity, and CUDA
    activity when `device` (default: cuda) is a card.  On exit it writes a
    Chrome trace (`*.pt.trace.json`) into `log_dir`, which TensorBoard's
    profiler plugin and Perfetto open.  Yields the profiler (its
    `key_averages()` sums the events by name).  The port's span record
    starts empty."""
    dev = resolve_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    _records.clear()
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


class StepTimer:
    """Wall-clock step timing with warmup discard and percentile summary.

    Each step ends with a synchronise of a CUDA `device` (default: cuda),
    so a step's time covers its kernels, not only their launches."""

    def __init__(self, warmup: int = 2, device=None):
        self.warmup = warmup
        self.device = resolve_device(device)
        self.times = []
        self._t = None
        self._n = 0

    def __enter__(self):
        self._t = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc and exc[0] is not None:
            return   # aborted step: a partial duration would skew p50/p90
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - self._t
        self._n += 1
        if self._n > self.warmup:
            self.times.append(dt)

    def summary(self) -> Dict[str, float]:
        import numpy as np
        if not self.times:
            return {}
        t = np.asarray(self.times)
        return {"p50_ms": float(np.percentile(t, 50) * 1e3),
                "p90_ms": float(np.percentile(t, 90) * 1e3),
                "mean_ms": float(t.mean() * 1e3),
                "steps_per_sec": float(1.0 / t.mean())}


# ---- counters ------------------------------------------------------------

_counts: Dict[str, float] = {}
# autograd's device threads count (K3-K5) beside the calling thread
_counts_lock = threading.Lock()


def count(name: str, n: float = 1) -> None:
    """Add n to counter `name`."""
    with _counts_lock:
        _counts[name] = _counts.get(name, 0) + n


def reset(*prefixes: str) -> None:
    """Zero every counter, or those whose name starts with one of
    `prefixes`."""
    with _counts_lock:
        for name in [k for k in _counts
                     if not prefixes or k.startswith(prefixes)]:
            del _counts[name]


def snapshot() -> Dict[str, float]:
    """The counters' values (a counter never counted is absent)."""
    with _counts_lock:
        return dict(_counts)


# ---- spans ---------------------------------------------------------------

@dataclasses.dataclass
class SpanRecord:
    """One recorded span.  `parent` indexes the enclosing span in
    `recorded()` (None: a top-level span); `frame` numbers the top-level
    span it belongs to; `t0_ns` / `t1_ns` are its host interval
    (`time.perf_counter_ns`); `stream_ms` is None without CUDA; `counts`
    holds the counters that moved over it, by how much."""
    name: str
    parent: Optional[int]
    frame: int
    thread: int
    t0_ns: int
    t1_ns: Optional[int] = None
    stream_ms: Optional[float] = None
    counts: Dict[str, float] = dataclasses.field(default_factory=dict)
    events: Optional[list] = dataclasses.field(default=None, repr=False)


_records: List[SpanRecord] = []
_local = threading.local()
# the open stack of the thread whose top-level span is open
_anchor: Optional[List[int]] = None
_frames = itertools.count()


def _stack() -> List[int]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Site:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return spanned


class _Off(_Site):
    """A span that records nothing (no profiler session open)."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


class _On(_Site):
    __slots__ = ("index", "stack", "range")

    def __enter__(self):
        global _anchor
        stack = _stack()
        outer = stack or _anchor
        parent = outer[-1] if outer else None
        if parent is None:
            frame = next(_frames)
            _anchor = stack
        else:
            frame = _records[parent].frame
        self.index, self.stack = len(_records), stack
        rec = SpanRecord(self.name, parent, frame, threading.get_ident(),
                         time.perf_counter_ns(), counts=snapshot())
        _records.append(rec)
        stack.append(self.index)
        self.range = _autograd_profiler.record_function(PREFIX + self.name)
        self.range.__enter__()
        if torch.cuda.is_initialized():
            rec.events = [torch.cuda.Event(enable_timing=True)]
            rec.events[0].record()
        return rec

    def __exit__(self, *exc):
        global _anchor
        rec = _records[self.index]
        if rec.events is not None:
            rec.events.append(torch.cuda.Event(enable_timing=True))
            rec.events[1].record()
        self.range.__exit__(*exc)
        rec.t1_ns = time.perf_counter_ns()
        before = rec.counts
        rec.counts = {k: v - before.get(k, 0) for k, v in snapshot().items()
                      if v != before.get(k, 0)}
        self.stack.pop()
        if not self.stack and _anchor is self.stack:
            _anchor = None
        return False


_OFF: Dict[str, _Off] = {}
# > 0 inside `muted()`
_muted = 0


@contextlib.contextmanager
def muted() -> Iterator[None]:
    """No span records inside: the work that sets up a CUDA graph (its
    eager warm-up and its capture, whose kernels never run) is no stage
    of a frame, and an event recorded inside a capture has no time."""
    global _muted
    _muted += 1
    try:
        yield
    finally:
        _muted -= 1


def span(name: str):
    """A span `srfdet/<name>` over a `with` block or, as a decorator, over
    each call of the function.  Off (no profiler session open, inside an
    export or compile, or `muted()`) it is one shared object that records
    nothing."""
    if _muted or not _autograd_profiler._is_profiler_enabled or \
            torch.compiler.is_exporting() or torch.compiler.is_compiling():
        off = _OFF.get(name)
        if off is None:
            off = _OFF[name] = _Off(name)
        return off
    return _On(name)


def recorded() -> List[SpanRecord]:
    """The spans recorded since `trace()` last opened, in the order they
    opened, each closed one with its stream ms (read after its end event
    completes)."""
    for rec in _records:
        if rec.events is not None and len(rec.events) == 2:
            start, end = rec.events
            end.synchronize()
            rec.stream_ms = start.elapsed_time(end)
            rec.events = None
    return list(_records)
