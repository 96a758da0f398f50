"""Native Waymo detection metrics (AP / APH, LEVEL_1 / LEVEL_2).

A copy of the JAX package's `evals/waymo_eval.py` on the port's own
`geometry.iou.iou_3d`, which runs on the device `resolve_device` gives
(the card unless the caller names another).

Replaces the Waymo `compute_detection_metrics_main` bazel binary the
reference shells out to (README.md:72-93) for the OBJECT_TYPE, RANGE and
VELOCITY breakdown axes; the camera-synced-box variant of the binary is
NOT implemented (see "Remaining simplifications" below).  Protocol:

  - match by 3D IoU: Car/Vehicle 0.7, Pedestrian/Cyclist 0.5, greedy in
    score order,
  - LEVEL_2 = all GTs; LEVEL_1 = GTs with > 5 lidar points (and not marked
    difficulty 2) — the official rule: a box with <= 5 points or labeler
    difficulty 2 is LEVEL_2-only,
  - AP = 101-point interpolated PR area; APH weights each TP by heading
    accuracy (1 - |Δyaw_wrapped| / pi) on BOTH axes — precision
    Σh / (tp + fp) and recall Σh / npos — matching the official
    compute_detection_metrics semantics (a 90°-heading detector halves
    recall too, not just precision),
  - RANGE breakdown shards ([0, 30), [30, 50), [50, inf) m by BEV center
    distance, the official OBJECT_TYPE x RANGE axes) and VELOCITY
    breakdown shards (official speed buckets STATIONARY [0, 0.2),
    SLOW [0.2, 1), MEDIUM [1, 3), FAST [3, 10), VERY_FAST [10, inf)
    m/s) follow the official per-shard Matcher semantics: predictions
    and ground truths are each assigned to a shard by their OWN
    range/velocity and matching is RE-RUN inside every shard subset —
    a cross-shard pair therefore scores as an FN in the GT's shard
    plus an FP in the prediction's shard (ADVICE r4 fixed the earlier
    global-match-then-credit-GT-shard scheme, which inflated breakdown
    AP).  Velocity comes from a "velocity" (N, 2) key or columns 7:9
    of 9-wide boxes (zero — STATIONARY — when the export carries
    none),
  - NLZ: predictions flagged `overlap_nlz` that fail to match any GT are
    ignored rather than counted FP (the official pair-metrics rule; the
    mmdet3d-style .bin export carries no NLZ info, so the flag is
    optional and defaults to False everywhere).

Remaining simplifications vs the binary (documented, not claimed):
the camera-synced boxes variant (separate prediction files projected to
camera-synchronized box frames) and the acceleration axis are not
implemented; matching is greedy by score (the official matcher
maximizes total IoU via Hungarian on ties — indistinguishable on
real score distributions).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import resolve_device
from .kitti_eval import _iou3d_np

IOU_THRESHOLDS = {"Car": 0.7, "Vehicle": 0.7, "Pedestrian": 0.5,
                  "Cyclist": 0.5}

# official RANGE breakdown edges (BEV center distance, metres)
RANGE_BUCKETS: Tuple[Tuple[float, float], ...] = (
    (0.0, 30.0), (30.0, 50.0), (50.0, float("inf")))
RANGE_NAMES = ("0_30", "30_50", "50_inf")

# official VELOCITY breakdown edges (speed magnitude, m/s)
VELOCITY_BUCKETS: Tuple[Tuple[float, float], ...] = (
    (0.0, 0.2), (0.2, 1.0), (1.0, 3.0), (3.0, 10.0), (10.0, float("inf")))
VELOCITY_NAMES = ("stationary", "slow", "medium", "fast", "very_fast")


def _heading_acc(yaw_p: float, yaw_g: float) -> float:
    d = abs(yaw_p - yaw_g) % (2 * np.pi)
    d = min(d, 2 * np.pi - d)
    return max(0.0, 1.0 - d / np.pi)


def _pr_area(weights: np.ndarray, is_tp: np.ndarray, scores: np.ndarray,
             npos: int) -> float:
    if npos == 0 or len(scores) == 0:
        return 0.0
    order = np.argsort(-scores)
    tp_w = np.cumsum(np.where(is_tp[order], weights[order], 0.0))
    fp = np.cumsum(~is_tp[order]).astype(float)
    tp = np.cumsum(is_tp[order]).astype(float)
    rec = tp_w / npos                 # heading-weighted recall (APH)
    prec_w = tp_w / np.maximum(tp + fp, 1e-9)
    rec_i = np.linspace(0, 1, 101)
    prec_i = np.interp(rec_i, rec, prec_w, right=0.0)
    # monotone envelope
    for i in range(len(prec_i) - 2, -1, -1):
        prec_i[i] = max(prec_i[i], prec_i[i + 1])
    return float(np.mean(prec_i))


def _bev_range(boxes: np.ndarray) -> np.ndarray:
    return np.hypot(boxes[:, 0], boxes[:, 1])


def _speed(d: Dict) -> np.ndarray:
    boxes = d["boxes"]
    if "velocity" in d:
        v = np.asarray(d["velocity"], float)
        return np.hypot(v[:, 0], v[:, 1])
    if boxes.shape[1] >= 9:
        return np.hypot(boxes[:, 7], boxes[:, 8])
    return np.zeros(len(boxes))


def _bucketize(vals: np.ndarray, buckets, names) -> np.ndarray:
    """Per-row shard name (object dtype) for one breakdown axis."""
    out = np.empty(len(vals), object)
    for (lo, hi), nm in zip(buckets, names):
        sel = (vals >= lo) & (vals < hi)
        out[sel] = nm
    return out


class _Accum:
    """One (level, shard) PR accumulator."""

    def __init__(self):
        self.is_tp: List[bool] = []
        self.weights: List[float] = []
        self.scores: List[float] = []
        self.npos = 0

    def add(self, tp: bool, score: float, weight: float) -> None:
        self.is_tp.append(tp)
        self.scores.append(score)
        self.weights.append(weight)

    def result(self) -> Tuple[float, float]:
        t = np.asarray(self.is_tp, bool)
        w = np.asarray(self.weights)
        s = np.asarray(self.scores)
        return (_pr_area(np.ones_like(w), t, s, self.npos),
                _pr_area(w, t, s, self.npos))


def waymo_eval(gts: List[Dict], preds: List[Dict],
               class_names: Sequence[str] = ("Car", "Pedestrian",
                                             "Cyclist"),
               range_breakdown: bool = False,
               velocity_breakdown: bool = False, device=None) -> Dict:
    """gts: {"boxes" (N, 7) with GRAVITY-center z (iou_3d derives z
    extents as cz -/+ h/2), "labels_name", optional "num_points" (N,),
    optional "difficulty" (N,), optional "velocity" (N, 2)}; preds add
    "scores" and optionally "overlap_nlz" (M,) bool (unmatched
    NLZ-overlapping detections are ignored, not FPs).

    Returns {"{cls}_AP_L1", "{cls}_APH_L1", "{cls}_AP_L2", "{cls}_APH_L2",
    "mAPH_L1", "mAPH_L2"} plus, when range_breakdown=True,
    "{cls}_AP[H]_L{1,2}_{0_30,30_50,50_inf}" per-range shards, and when
    velocity_breakdown=True, "{cls}_AP[H]_L{1,2}_{stationary,slow,medium,
    fast,very_fast}" per-speed shards.  Every shard re-runs matching on
    its own subset (predictions sharded by their own value, GTs by
    theirs — official per-shard Matcher semantics); a cross-shard pair
    is an FN in the GT's shard and an FP in the prediction's shard.
    device: where iou_3d runs (`resolve_device`: the card by default).
    """
    dev = resolve_device(device)
    out = {}
    shard_names: Tuple[Optional[str], ...] = (None,)
    if range_breakdown:
        shard_names = shard_names + RANGE_NAMES
    if velocity_breakdown:
        shard_names = shard_names + VELOCITY_NAMES

    def shard_mask(d: Dict, sel: np.ndarray, s: Optional[str]
                   ) -> np.ndarray:
        """Membership of rows `sel` of frame-dict d in shard s (each
        object shards by its OWN range/velocity)."""
        if s is None:
            return np.ones(len(sel), bool)
        if s in RANGE_NAMES:
            vals = _bucketize(_bev_range(d["boxes"]), RANGE_BUCKETS,
                              RANGE_NAMES)
        else:
            vals = _bucketize(_speed(d), VELOCITY_BUCKETS,
                              VELOCITY_NAMES)
        return vals[sel] == s

    for cls in class_names:
        thr = IOU_THRESHOLDS.get(cls, 0.5)
        # IoU depends only on (frame, class) — compute once, reuse for
        # both levels and every shard
        frames = []
        for g, p in zip(gts, preds):
            g_sel = np.nonzero(g["labels_name"] == cls)[0]
            p_sel = np.nonzero(p["labels_name"] == cls)[0]
            p_order = p_sel[np.argsort(-p["scores"][p_sel])]
            if len(g_sel) and len(p_order):
                ious = _iou3d_np(p["boxes"][p_order], g["boxes"][g_sel],
                                 dev)
            else:
                ious = np.zeros((len(p_order), len(g_sel)))
            frames.append((g, p, g_sel, p_order, ious))
        for level in (1, 2):
            acc = {s: _Accum() for s in shard_names}
            for g, p, g_sel, p_order, ious in frames:
                npts = np.asarray(g.get("num_points",
                                        np.full(len(g["boxes"]), 100)))
                diff = np.asarray(g.get("difficulty",
                                        np.zeros(len(g["boxes"]))))
                nlz = np.asarray(p.get("overlap_nlz",
                                       np.zeros(len(p["boxes"]), bool)))
                if level == 1:
                    lvl_ok = (npts > 5) & (diff < 2)
                else:
                    lvl_ok = np.ones(len(g["boxes"]), bool)

                for s in shard_names:
                    # per-shard subsets; matching is re-run inside each
                    g_in = np.nonzero(shard_mask(g, g_sel, s))[0]
                    p_in = np.nonzero(shard_mask(p, p_order, s))[0]
                    a = acc[s]
                    a.npos += int(np.sum(lvl_ok[g_sel[g_in]]))
                    if len(p_in) == 0:
                        continue
                    taken = np.zeros(len(g_in), bool)

                    def best(pi, want_valid):
                        bi, bv = -1, thr
                        for k in range(len(g_in)):
                            gi = g_in[k]
                            if taken[k] or \
                                    bool(lvl_ok[g_sel[gi]]) != want_valid:
                                continue
                            if ious[pi, gi] >= bv:
                                bv, bi = ious[pi, gi], k
                        return bi

                    for pi in p_in:
                        score = float(p["scores"][p_order[pi]])
                        # valid (in-level) GTs first: an out-of-level GT
                        # must not steal a detection a counted GT can
                        # claim
                        k = best(pi, True)
                        if k >= 0:
                            taken[k] = True
                            h = _heading_acc(
                                float(p["boxes"][p_order[pi]][6]),
                                float(g["boxes"][g_sel[g_in[k]]][6]))
                            a.add(True, score, h)
                            continue
                        k = best(pi, False)
                        if k >= 0:       # ignored GT absorbs the det
                            taken[k] = True
                            continue
                        if nlz[p_order[pi]]:
                            continue     # unmatched NLZ det: ignored
                        a.add(False, score, 0.0)
            for s in shard_names:
                ap, aph = acc[s].result()
                sfx = f"_L{level}" + (f"_{s}" if s else "")
                out[f"{cls}_AP{sfx}"] = ap
                out[f"{cls}_APH{sfx}"] = aph
    for level in (1, 2):
        out[f"mAPH_L{level}"] = float(np.mean(
            [out[f"{c}_APH_L{level}"] for c in class_names]))
    return out
