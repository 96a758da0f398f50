"""Training observability: per-interval metric lines on stdout and, with a
`log_dir`, TensorBoard scalars (the JAX package's `utils/logging.py`).

Replaces mmcv TextLoggerHook / TensorboardLoggerHook (cfg
srfdet_voxel_nusc_L.py:384-389): per-interval loss lines with iter timing,
and an event file of scalars when a log_dir is given.  The JAX package
writes its scalars through tensorflow; the port writes the event file
itself (`event_file.EventWriter`), so it needs neither tensorflow nor
tensorboard.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, Optional

from .event_file import EventWriter


class MetricLogger:
    def __init__(self, interval: int = 50, log_dir: Optional[str] = None):
        self.interval = interval
        self._last = time.perf_counter()
        self._writer = EventWriter(log_dir) if log_dir else None

    def log(self, step: int, metrics: Dict[str, float],
            lr: Optional[float] = None) -> None:
        if step % max(self.interval, 1):
            return
        now = time.perf_counter()
        dt = (now - self._last) / max(self.interval, 1)
        self._last = now
        parts = [f"iter {step}", f"{dt * 1000:.0f} ms/iter"]
        if lr is not None:
            parts.append(f"lr {lr:.2e}")
        parts += [f"{k} {float(v):.4f}" for k, v in sorted(metrics.items())]
        # one write with its newline: a line another rank prints into the
        # same log cannot land inside it
        sys.stdout.write("  ".join(parts) + "\n")
        sys.stdout.flush()
        if self._writer is not None:
            scalars = {k: float(v) for k, v in metrics.items()}
            if lr is not None:
                scalars["lr"] = float(lr)
            self._writer.add_scalars(step, scalars)

    def log_eval(self, step: int, metrics: Dict[str, float]) -> None:
        """Validation metrics (mmcv EvalHook lines), always printed;
        scalars land under val/ in the event file."""
        scalars = {k: float(v) for k, v in metrics.items()
                   if isinstance(v, (int, float))}
        parts = [f"eval @ iter {step}"]
        parts += [f"{k} {v:.4f}" for k, v in sorted(scalars.items())]
        print("  ".join(parts), flush=True)
        if self._writer is not None:
            self._writer.add_scalars(
                step, {f"val/{k}": v for k, v in scalars.items()})

    @property
    def event_path(self) -> Optional[str]:
        """The event file, or None without a log_dir."""
        return None if self._writer is None else self._writer.path

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
