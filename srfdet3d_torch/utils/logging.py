"""Training observability: per-interval metric lines on stdout (the JAX
package's `utils/logging.py`; its TensorBoard event file has no
counterpart in the port).

Replaces mmcv TextLoggerHook (cfg srfdet_voxel_nusc_L.py:384-389):
per-interval loss lines with iter timing.
"""

from __future__ import annotations

import time
from typing import Dict, Optional


class MetricLogger:
    def __init__(self, interval: int = 50):
        self.interval = interval
        self._last = time.perf_counter()

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
        print("  ".join(parts), flush=True)

    def log_eval(self, step: int, metrics: Dict[str, float]) -> None:
        """Validation metrics (mmcv EvalHook lines), always printed."""
        scalars = {k: float(v) for k, v in metrics.items()
                   if isinstance(v, (int, float))}
        parts = [f"eval @ iter {step}"]
        parts += [f"{k} {v:.4f}" for k, v in sorted(scalars.items())]
        print("  ".join(parts), flush=True)
