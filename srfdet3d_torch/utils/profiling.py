"""Profiling hooks (the JAX package's `utils/profiling.py`): a trace of the
enclosed steps with torch.profiler, and a step timer.

    with trace("work_dirs/trace", device):
        for batch in batches:
            train_step(...)

    timer = StepTimer(warmup=2, device=device)
    for batch in batches:
        with timer:
            train_step(...)
    timer.summary()     # p50_ms, p90_ms, mean_ms, steps_per_sec
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator

import torch

from .. import resolve_device


@contextlib.contextmanager
def trace(log_dir: str, device=None) -> Iterator[torch.profiler.profile]:
    """torch.profiler over the enclosed steps: CPU activity, and CUDA
    activity when `device` (default: cuda) is a card.  On exit it writes a
    Chrome trace (`*.pt.trace.json`) into `log_dir`, which TensorBoard's
    profiler plugin and Perfetto open.  Yields the profiler (its
    `key_averages()` sums the events by name)."""
    dev = resolve_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
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
