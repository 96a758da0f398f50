"""Native nuScenes detection metrics (mAP / NDS) — no devkit dependency
(a numpy copy of the JAX package's `evals/nuscenes_eval.py`).

Reimplements the official nuscenes-devkit detection evaluation the reference
reaches through `dataset.evaluate()` (tools/test.py:243-252):

  - greedy matching by 2D BEV center distance at thresholds {0.5, 1, 2, 4} m,
  - AP = normalized area of the 101-point interpolated precision curve with
    10% recall/precision floors (devkit `calc_ap`),
  - TP metrics at the 2.0 m threshold averaged over achieved recalls above
    10% (devkit `calc_tp`): ATE (center dist), ASE (1 - iou of aligned
    boxes), AOE (yaw delta, period 2pi; pi for barriers), AVE (velocity L2),
    AAE (attribute error; 1 - acc, skipped for cones/barriers),
  - per-class detection range filtering (devkit `class_range`),
  - NDS = (5*mAP + sum(1 - min(1, tp_err))) / 10.

Inputs are plain numpy dicts — no file formats — so the same module serves
unit tests, the synthetic benchmark, and evaluation on real data.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

DIST_THRESHOLDS = (0.5, 1.0, 2.0, 4.0)
TP_THRESHOLD = 2.0
MIN_RECALL = 0.1
MIN_PRECISION = 0.1
N_RECALL_SAMPLES = 101

NUS_CLASS_RANGES = {
    "car": 50.0, "truck": 50.0, "bus": 50.0, "trailer": 50.0,
    "construction_vehicle": 50.0, "pedestrian": 40.0, "motorcycle": 40.0,
    "bicycle": 40.0, "traffic_cone": 30.0, "barrier": 30.0,
}
# classes without meaningful orientation / velocity / attribute
NO_VELOCITY = ("barrier", "traffic_cone")
NO_ATTRIBUTE = ("barrier", "traffic_cone")
YAW_PERIOD_PI = ("barrier",)


def _yaw_diff(a: float, b: float, period: float = 2 * np.pi) -> float:
    d = (a - b) % period
    return min(d, period - d)


def _aligned_iou_1d(s1: np.ndarray, s2: np.ndarray) -> float:
    """3D IoU of two size-aligned, center-aligned boxes (devkit scale_iou)."""
    inter = np.prod(np.minimum(s1, s2))
    union = np.prod(s1) + np.prod(s2) - inter
    return float(inter / max(union, 1e-9))


def _no_predictions():
    """Devkit DetectionMetricData.no_predictions: zero precision/
    confidence, unit errors — used both for classes absent from the GT
    and for classes with no predictions.  calc_ap -> 0, calc_tp -> 1."""
    return dict(recall=np.linspace(0, 1, N_RECALL_SAMPLES),
                precision=np.zeros(N_RECALL_SAMPLES),
                trans_err=np.ones(N_RECALL_SAMPLES),
                scale_err=np.ones(N_RECALL_SAMPLES),
                orient_err=np.ones(N_RECALL_SAMPLES),
                vel_err=np.ones(N_RECALL_SAMPLES),
                attr_err=np.ones(N_RECALL_SAMPLES),
                max_recall_ind=0)


def _class_match_cache(gts: List[Dict], preds: List[Dict],
                       class_name: str):
    """Per-class precomputation shared by all 4 distance thresholds:
    global score-ordered prediction rows and per-frame center-distance
    matrices (the devkit recomputes these per threshold; at real-data
    scale the O(P*G) python inner loop dominated eval wall time)."""
    npos = sum(
        int(np.sum(g["labels_name"] == class_name)) for g in gts)
    rows = []       # (score, sample_idx, box_idx, local pred row)
    dmats = []      # per frame: (gsel, (n_pred_sel, n_gt_sel) dists)
    for si, (g, p) in enumerate(zip(gts, preds)):
        psel = np.nonzero(p["labels_name"] == class_name)[0]
        gsel = np.nonzero(g["labels_name"] == class_name)[0]
        d = np.hypot(
            p["boxes"][psel, 0][:, None] - g["boxes"][gsel, 0][None, :],
            p["boxes"][psel, 1][:, None] - g["boxes"][gsel, 1][None, :])             if len(psel) and len(gsel) else np.zeros((len(psel), 0))
        dmats.append((gsel, d))
        for row, bi in enumerate(psel):
            rows.append((float(p["scores"][bi]), si, int(bi), row))
    rows.sort(key=lambda r: -r[0])
    return npos, rows, dmats


def _accumulate(gts: List[Dict], preds: List[Dict], class_name: str,
                dist_th: float, cache=None):
    """Devkit `accumulate`: greedy match in score order; returns the
    101-point metric curves for one (class, threshold)."""
    npos, rows, dmats = cache if cache is not None else         _class_match_cache(gts, preds, class_name)
    if npos == 0:
        # devkit algo.py: missing classes still contribute AP=0 and unit
        # TP errors to the means — they are NOT skipped
        return _no_predictions()

    taken_mask = [np.zeros(len(gsel), bool) for gsel, _ in dmats]
    tp, fp = [], []
    tp_conf = []
    err_trans, err_scale, err_orient, err_vel, err_attr = [], [], [], [], []
    for score, si, bi, row in rows:
        pb = preds[si]["boxes"][bi]
        g = gts[si]
        gsel, dmat = dmats[si]
        free = ~taken_mask[si]
        if free.any():
            d = np.where(free, dmat[row], np.inf)
            j = int(np.argmin(d))
            best, best_gi = float(d[j]), int(gsel[j])
        else:
            best, best_gi, j = np.inf, None, -1
        if best < dist_th:
            taken_mask[si][j] = True
            tp.append(1)
            fp.append(0)
            tp_conf.append(score)
            gb = g["boxes"][best_gi]
            err_trans.append(best)
            err_scale.append(1.0 - _aligned_iou_1d(pb[3:6], gb[3:6]))
            period = np.pi if class_name in YAW_PERIOD_PI else 2 * np.pi
            err_orient.append(_yaw_diff(pb[6], gb[6], period))
            if class_name in NO_VELOCITY or pb.shape[0] < 9 or \
                    gb.shape[0] < 9:
                err_vel.append(np.nan)
            else:
                err_vel.append(float(np.hypot(pb[7] - gb[7], pb[8] - gb[8])))
            if class_name in NO_ATTRIBUTE:
                err_attr.append(np.nan)
            else:
                pa = preds[si].get("attrs")
                ga = g.get("attrs")
                if pa is None or ga is None or str(ga[best_gi]) == "":
                    # devkit attr_acc: GTs without an annotated attribute
                    # return nan and are EXCLUDED from AAE, not errors
                    err_attr.append(np.nan)
                else:
                    err_attr.append(0.0 if pa[bi] == ga[best_gi] else 1.0)
        else:
            tp.append(0)
            fp.append(1)

    if not tp_conf:
        return _no_predictions()

    conf = [r[0] for r in rows]
    tp = np.cumsum(tp).astype(float)
    fp = np.cumsum(fp).astype(float)
    prec = tp / (tp + fp)
    rec = tp / npos

    rec_interp = np.linspace(0, 1, N_RECALL_SAMPLES)
    precision = np.interp(rec_interp, rec, prec, right=0)
    # devkit algo.py: confidence curve over the recall axis; the last
    # nonzero-confidence index bounds the achieved-recall averaging window
    conf_interp = np.interp(rec_interp, rec, conf, right=0)
    nz = np.nonzero(conf_interp)[0]
    max_recall_ind = int(nz[-1]) if len(nz) else 0

    def cummean_interp(errs):
        # devkit utils.cummean (nan-aware running mean over TP events)
        # interpolated AGAINST CONFIDENCE, not recall (algo.py accumulate)
        errs = np.asarray(errs, float)
        if np.all(np.isnan(errs)):
            return np.ones(N_RECALL_SAMPLES)
        cm = np.nancumsum(np.nan_to_num(errs, nan=0.0)) / \
            np.maximum(np.cumsum(~np.isnan(errs)), 1)
        tc = np.asarray(tp_conf, float)
        return np.interp(conf_interp[::-1], tc[::-1], cm[::-1])[::-1]

    return dict(recall=rec_interp, precision=precision,
                trans_err=cummean_interp(err_trans),
                scale_err=cummean_interp(err_scale),
                orient_err=cummean_interp(err_orient),
                vel_err=cummean_interp(err_vel),
                attr_err=cummean_interp(err_attr),
                max_recall_ind=max_recall_ind)


def _calc_ap(md: Dict) -> float:
    prec = md["precision"].copy()
    prec = prec[round(100 * MIN_RECALL) + 1:]
    prec -= MIN_PRECISION
    prec[prec < 0] = 0
    return float(np.mean(prec)) / (1.0 - MIN_PRECISION)


def _calc_tp(md: Dict, field: str) -> float:
    first = round(100 * MIN_RECALL) + 1
    last = md["max_recall_ind"]
    if last < first:
        return 1.0
    return float(np.mean(md[field][first:last + 1]))


def _filter_by_range(frame: Dict, class_ranges: Dict[str, float]) -> Dict:
    boxes = frame["boxes"]
    names = frame["labels_name"]
    if len(boxes) == 0:
        return frame
    dist = np.hypot(boxes[:, 0], boxes[:, 1])
    # strict <, matching devkit filter_eval_boxes (ego_dist < max_dist)
    keep = np.array([
        d < class_ranges.get(str(n), 50.0) for d, n in zip(dist, names)])
    out = {k: (np.asarray(v)[keep] if k in
               ("boxes", "scores", "labels_name", "attrs") and
               v is not None else v) for k, v in frame.items()}
    return out


def nuscenes_eval(gts: List[Dict], preds: List[Dict],
                  class_names: Sequence[str],
                  class_ranges: Optional[Dict[str, float]] = None) -> Dict:
    """Evaluate per-frame lists of dicts.

    Each gt frame: {"boxes" (N, 7|9) gravity-center z, "labels_name" (N,)
    str array, optional "attrs"}.  Each pred frame adds "scores".

    Returns {"mAP", "NDS", "mATE", ..., "per_class": {...}}.
    """
    class_ranges = class_ranges or NUS_CLASS_RANGES
    gts = [_filter_by_range(g, class_ranges) for g in gts]
    preds = [_filter_by_range(p, class_ranges) for p in preds]

    per_class: Dict[str, Dict] = {}
    tp_fields = ("trans_err", "scale_err", "orient_err", "vel_err",
                 "attr_err")
    for cls in class_names:
        cache = _class_match_cache(gts, preds, cls)
        aps = []
        mds = {}
        for th in DIST_THRESHOLDS:
            md = _accumulate(gts, preds, cls, th, cache=cache)
            aps.append(_calc_ap(md))
            if th == TP_THRESHOLD:
                mds = md
        entry = {"AP": float(np.mean(aps))}
        for f in tp_fields:
            if (f == "vel_err" and cls in NO_VELOCITY) or \
                    (f == "attr_err" and cls in NO_ATTRIBUTE) or \
                    (f == "orient_err" and cls == "traffic_cone"):
                entry[f] = np.nan
            else:
                entry[f] = _calc_tp(mds, f)
        per_class[cls] = entry

    if not per_class:
        return {"mAP": 0.0, "NDS": 0.0, "per_class": {}, "mATE": 1.0,
                "mASE": 1.0, "mAOE": 1.0, "mAVE": 1.0, "mAAE": 1.0}

    mAP = float(np.mean([e["AP"] for e in per_class.values()]))
    tp_means = {}
    for f in tp_fields:
        vals = [e[f] for e in per_class.values() if not np.isnan(e[f])]
        tp_means["m" + f] = float(np.mean(vals)) if vals else 1.0
    nds = (5 * mAP + sum(
        max(0.0, 1.0 - min(1.0, tp_means["m" + f])) for f in tp_fields)
    ) / 10.0
    out = {"mAP": mAP, "NDS": float(nds), "per_class": per_class}
    out.update({("mATE", "mASE", "mAOE", "mAVE", "mAAE")[i]:
                tp_means["m" + f] for i, f in enumerate(tp_fields)})
    return out
