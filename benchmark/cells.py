"""The two kinds of cell a traffic file can ask for (`mode`): a predict
stream and back-to-back train steps.  Each drives the system under test
through its public entry (`SRFDet.predict`, `trainer.train_step`), times a
window, and afterwards compares what the window produced with the plain
reference (`compare.py`).

predict: one stream, closed loop.  A frame runs from handing its host
tensors (pinned, as a loader hands them over) to the model until its
decoded boxes, scores, labels and valid flags are on the host; the next
frame starts then.  Frames cycle through the traffic's pool.  A forward
hook keeps (by reference, no copy) the head's outputs of the last frame
served, for a share of the frames drawn from the seed (`check_share`), beside
the answer served, which the check compares with the reference.

train: set-up builds the model and its optimizer once and drives them
through the first three steps, on pool batches 0, 1, 2, through the same
call and feed as the window; it keeps, on the host, each step's state
before it, its discrete decisions, its losses, Adam's first moment after
it (the gradient as the optimizer gets it) and the parameters after it
(decisions.checked_steps).  The window continues from there with the
same objects, cycling through the pool.
"""

from __future__ import annotations

import math
import random
import time
from typing import Dict, List

import torch

from . import port, scene

INPUT_KEYS = ("points", "points_mask", "images", "lidar2img")
TRAIN_KEYS = INPUT_KEYS + ("gt_boxes", "gt_labels", "gt_mask")
# the lr schedule's length (the configs' epochs over nuScenes' 28,130
# training frames at their batch sizes); the checked steps sit in warm-up
SCHEDULE_STEPS = 100_000
CHECKED_STEPS = 3


def to_device(batch: Dict[str, torch.Tensor], keys, dev):
    return {k: batch[k].to(dev, non_blocking=True) for k in keys
            if k in batch}


class PredictCell:
    def __init__(self, net, pool: List[dict], dev, seed: int,
                 check_share: float):
        self.net, self.pool, self.dev = net, pool, dev
        self.sampled: List[tuple] = []
        self._current = 0
        self._kept = self._last = None
        self._draw = random.Random(scene.derived_seed(seed, 0xC4EC))
        self._share = check_share
        self._hook = net.bbox_head.register_forward_hook(self._keep)

    def _keep(self, mod, args, out):
        self._kept = out

    def serve(self, i: int):
        self._current = i % len(self.pool)
        batch = to_device(self.pool[self._current], INPUT_KEYS, self.dev)
        out = self.net.predict(batch)
        return {k: v.cpu() for k, v in out.items()}

    def serve_window_frame(self, i: int):
        """A window's frame; a share of them, drawn from the seed, keep
        the head's outputs (by reference) beside their served answer, and
        so does the window's last frame when the draw took none."""
        checked = self._draw.random() < self._share
        ans = self.serve(i)
        self._last = (self._current, self._kept, ans)
        self._kept = None
        if checked:
            self.sampled.append(self._last)
        return ans

    def warm(self) -> None:
        """Every pool entry once (cuDNN picks its algorithms here: every
        frame has the same shapes)."""
        for i in range(len(self.pool)):
            self.serve(i)

    def window(self, seconds: float, on_frame=None) -> dict:
        lat = []
        start = time.perf_counter()
        i = 0
        while time.perf_counter() - start < seconds:
            t0 = time.perf_counter()
            self.serve_window_frame(i)
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            if on_frame is not None:
                on_frame()
            i += 1
        end = time.perf_counter()
        if not self.sampled and self._last is not None:
            self.sampled.append(self._last)
        self._last = None
        return dict(frames=len(lat), window_s=end - start, latencies=lat)

    def e2e(self, w: dict) -> dict:
        lat_ms = sorted(x * 1e3 for x in w["latencies"])
        return {"predict_frames_per_s": w["frames"] / w["window_s"],
                "predict_p90_ms": percentile(lat_ms, 0.9)}

    def close(self):
        self._hook.remove()
        self.net = None


class TrainCell:
    def __init__(self, cfg, net, pool: List[dict], dev, seed: int):
        self.net, self.pool, self.dev = net, pool, dev
        self.seed = seed
        self.opt = port.optimizer(net, cfg, SCHEDULE_STEPS)
        self.step_index = 0
        self.record: dict = {}

    def step(self):
        i = self.step_index
        batch = to_device(self.pool[i % len(self.pool)], TRAIN_KEYS,
                          self.dev)
        gen = port.step_generator(self.net, self.seed, i)
        out = port.train_step(self.net, self.opt, batch, gen)
        self.step_index += 1
        return out

    def warm(self) -> None:
        """The checked steps: the first three steps of the window's own
        call and feed, with what the check needs kept on the host
        (decisions.checked_steps: each step's state before it, its
        decisions, losses, Adam's first moment and the parameters after;
        probes.ConvGradProbe: the first step's sparse conv weight
        gradients, projected)."""
        from .decisions import checked_steps, modules_of
        from .probes import ConvGradProbe
        probes = []

        def step(s):
            if s:
                return self.step()
            probe = ConvGradProbe(self.net, self.seed)
            try:
                return self.step()
            finally:
                probe.close()
                probes.extend(probe.calls)
        self.record = checked_steps(
            self.net, self.opt, step, modules_of(port.system().__name__),
            CHECKED_STEPS)
        self.record["conv_probes"] = probes

    def window(self, seconds: float, on_frame=None) -> dict:
        start = time.perf_counter()
        steps = 0
        while time.perf_counter() - start < seconds:
            self.step()
            steps += 1
            if on_frame is not None:
                on_frame()
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        end = time.perf_counter()
        b = self.pool[0]["points"].shape[0]
        return dict(frames=steps, samples=steps * b, window_s=end - start)

    def e2e(self, w: dict) -> dict:
        return {"train_samples_per_s": w["samples"] / w["window_s"]}

    def close(self):
        self.net = self.opt = None


def percentile(sorted_vals: List[float], q: float) -> float:
    """The q-th percentile of sorted values by linear interpolation
    between closest ranks (numpy's default)."""
    if not sorted_vals:
        return math.nan
    pos = q * (len(sorted_vals) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(sorted_vals) - 1)
    return sorted_vals[lo] + (sorted_vals[hi] - sorted_vals[lo]) * (pos - lo)


CELLS = {"predict": PredictCell, "train": TrainCell}
