"""Native KITTI 3D AP (R40) evaluation — faithful port of the official
protocol (a copy of the JAX package's `evals/kitti_eval.py` on the port's
own `geometry.iou.iou_3d`, which runs on the device `resolve_device`
gives: the card unless the caller names another).

Replaces the mmdet3d kitti eval the reference reaches via
`dataset.evaluate()` (tools/test.py:243-252).  This is a structure-
faithful port of the official KITTI C++ benchmark (as mirrored by
mmdet3d's `kitti_eval` python port), NOT a greedy PR sweep:

  - class-specific 3D IoU thresholds: Car 0.7, Pedestrian/Cyclist 0.5,
    STRICT `>` comparison like the official code,
  - three difficulty buckets (easy/moderate/hard) from 2D bbox height /
    occlusion / truncation when provided (absent -> every GT valid in all
    buckets, so the three APs coincide),
  - `get_thresholds`: ~41 score thresholds chosen from the matched-TP
    score distribution so recall advances in 1/40 steps,
  - per-threshold RE-MATCHING (`compute_statistics`): detections below
    the threshold are invisible; matching loops over GTs IN ORDER, each
    valid GT taking its best-overlap unassigned detection; out-of-bucket
    and neighboring-class GTs ("Van" for Car, "Person_sitting" for
    Pedestrian) are `ignored` — they absorb their best detection (neither
    TP nor FP),
  - AP_R40 = mean of the monotone precision envelope at threshold slots
    1..40 (slot 0 excluded; unfilled slots are ZERO — on toy datasets
    with < ~41 valid GTs the official metric therefore under-reads;
    use >= 41 GTs per class when asserting toy parity).

Not applied (no 2D detection boxes exist in this 3D-only pipeline,
matching how mmdet3d invokes the 3D metric): DontCare 2D regions and the
minimum-2D-height detection ignore.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..geometry.iou import iou_3d

IOU_THRESHOLDS = {"Car": 0.7, "Pedestrian": 0.5, "Cyclist": 0.5}
# official eval's ignored neighboring classes (absorb, never FP/TP)
NEIGHBOR_IGNORED = {"Car": ("Van",), "Pedestrian": ("Person_sitting",)}
# (min bbox height px, max occlusion, max truncation)
DIFFICULTY = {
    "easy": (40, 0, 0.15),
    "moderate": (25, 1, 0.30),
    "hard": (25, 2, 0.50),
}
N_SAMPLE_PTS = 41
_NO_DETECTION = -10_000_000.0


def _gt_difficulty_ok(frame: Dict, diff: str) -> np.ndarray:
    n = len(frame["boxes"])
    h_min, occ_max, tr_max = DIFFICULTY[diff]
    heights = frame.get("bbox_heights")
    occ = frame.get("occluded")
    tru = frame.get("truncated")
    if heights is None or occ is None or tru is None:
        return np.ones(n, bool)
    return ((np.asarray(heights) >= h_min) &
            (np.asarray(occ) <= occ_max) &
            (np.asarray(tru) <= tr_max))


def _iou3d_np(b1: np.ndarray, b2: np.ndarray,
              device: torch.device) -> np.ndarray:
    """Pairwise float32 3D IoU (len(b1), len(b2)) of gravity-center boxes,
    computed on `device`."""
    if len(b1) == 0 or len(b2) == 0:
        return np.zeros((len(b1), len(b2)), np.float32)
    t1 = torch.as_tensor(np.asarray(b1[:, :7], np.float32), device=device)
    t2 = torch.as_tensor(np.asarray(b2[:, :7], np.float32), device=device)
    return iou_3d(t1, t2).cpu().numpy()


def get_thresholds(scores: np.ndarray, num_gt: int,
                   num_sample_pts: int = N_SAMPLE_PTS) -> List[float]:
    """Official `get_thresholds`: walk the descending TP-score list and
    keep a score whenever skipping it would move recall further from the
    next 1/(pts-1) grid step than keeping it."""
    scores = np.sort(np.asarray(scores, float))[::-1]
    current_recall = 0.0
    thresholds: List[float] = []
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if ((r_recall - current_recall) < (current_recall - l_recall)) \
                and (i < len(scores) - 1):
            continue
        thresholds.append(float(score))
        current_recall += 1.0 / (num_sample_pts - 1.0)
    return thresholds


def compute_statistics(ious: np.ndarray, gt_ign: np.ndarray,
                       det_ign: np.ndarray, det_scores: np.ndarray,
                       min_overlap: float, thresh: float,
                       compute_fp: bool
                       ) -> Tuple[int, int, int, List[float]]:
    """Official `compute_statistics_jit` for the 3D metric: one frame —
    detection loop vectorized with numpy (the official port numba-jits
    the same double loop; `compute_statistics_ref` below keeps the
    literal scalar form as the fuzz oracle).

    ious (n_det, n_gt); gt_ign/det_ign in {0 valid, 1 ignored, -1 skip};
    detections below `thresh` are invisible when compute_fp.  GT loop runs
    IN INDEX ORDER (the official semantics — an ignored GT earlier in the
    frame absorbs a detection a later valid GT could have claimed).
    Returns (tp, fp, fn, matched-TP scores).

    Selection semantics reproduced exactly (derivation from the official
    scan: `assigned_ignored_det` makes any valid candidate override an
    ignored one, and strict `>` comparisons make ties resolve to the
    FIRST maximum — which is what np.argmax returns):
      - compute_fp=False: among visible unassigned dets with
        overlap > min_overlap, the highest-SCORE one (first on ties);
      - compute_fp=True: the highest-OVERLAP det_ign==0 candidate; if
        none, the FIRST det_ign==1 candidate (absorbs, neither TP/FP).
    """
    n_det, n_gt = ious.shape
    assigned = np.zeros(n_det, bool)
    ignored_threshold = (det_scores < thresh) if compute_fp else \
        np.zeros(n_det, bool)
    base_ok = (det_ign != -1) & ~ignored_threshold
    ov = ious > min_overlap
    tp = fp = fn = 0
    tp_scores: List[float] = []
    for i in range(n_gt):
        if gt_ign[i] == -1:
            continue
        cand = base_ok & ~assigned & ov[:, i]
        det_idx = -1
        if not compute_fp:
            idxs = np.nonzero(cand)[0]
            if len(idxs):
                det_idx = int(idxs[np.argmax(det_scores[idxs])])
        else:
            vi = np.nonzero(cand & (det_ign == 0))[0]
            if len(vi):
                det_idx = int(vi[np.argmax(ious[vi, i])])
            else:
                ii = np.nonzero(cand & (det_ign == 1))[0]
                if len(ii):
                    det_idx = int(ii[0])
        if det_idx == -1:
            if gt_ign[i] == 0:
                fn += 1
        elif gt_ign[i] == 1 or det_ign[det_idx] == 1:
            assigned[det_idx] = True
        else:
            tp += 1
            tp_scores.append(float(det_scores[det_idx]))
            assigned[det_idx] = True
    if compute_fp:
        fp = int(np.sum(~assigned & (det_ign == 0) & ~ignored_threshold))
    return tp, fp, fn, tp_scores


def compute_statistics_ref(ious: np.ndarray, gt_ign: np.ndarray,
                           det_ign: np.ndarray, det_scores: np.ndarray,
                           min_overlap: float, thresh: float,
                           compute_fp: bool
                           ) -> Tuple[int, int, int, List[float]]:
    """Literal scalar-loop port of the official `compute_statistics_jit`
    — kept as the oracle for the vectorized version above (fuzz-tested
    equal in tests/test_torch_port_evals.py)."""
    n_det, n_gt = ious.shape
    assigned = np.zeros(n_det, bool)
    ignored_threshold = (det_scores < thresh) if compute_fp else \
        np.zeros(n_det, bool)
    tp = fp = fn = 0
    tp_scores: List[float] = []
    for i in range(n_gt):
        if gt_ign[i] == -1:
            continue
        det_idx = -1
        valid_detection = _NO_DETECTION
        max_overlap = 0.0
        assigned_ignored_det = False
        for j in range(n_det):
            if det_ign[j] == -1 or assigned[j] or ignored_threshold[j]:
                continue
            overlap = float(ious[j, i])
            score = float(det_scores[j])
            if not compute_fp and overlap > min_overlap and \
                    score > valid_detection:
                det_idx, valid_detection = j, score
            elif compute_fp and overlap > min_overlap and \
                    (overlap > max_overlap or assigned_ignored_det) and \
                    det_ign[j] == 0:
                max_overlap, det_idx = overlap, j
                valid_detection, assigned_ignored_det = 1.0, False
            elif compute_fp and overlap > min_overlap and \
                    valid_detection == _NO_DETECTION and det_ign[j] == 1:
                det_idx, valid_detection = j, 1.0
                assigned_ignored_det = True
        if valid_detection == _NO_DETECTION and gt_ign[i] == 0:
            fn += 1
        elif valid_detection != _NO_DETECTION and \
                (gt_ign[i] == 1 or det_ign[det_idx] == 1):
            assigned[det_idx] = True
        elif valid_detection != _NO_DETECTION:
            tp += 1
            tp_scores.append(float(det_scores[det_idx]))
            assigned[det_idx] = True
    if compute_fp:
        for j in range(n_det):
            if not (assigned[j] or det_ign[j] == -1 or det_ign[j] == 1 or
                    ignored_threshold[j]):
                fp += 1
    return tp, fp, fn, tp_scores


def _clean_frame(g: Dict, p: Dict, cls: str, diff: str):
    """Official `clean_data`: per-frame ignore triage + IoU matrix."""
    ign_names = NEIGHBOR_IGNORED.get(cls, ())
    gnames = g["labels_name"]
    diff_ok = _gt_difficulty_ok(g, diff)
    gt_ign = np.full(len(gnames), -1, np.int32)
    for i, name in enumerate(gnames):
        if str(name) == cls:
            gt_ign[i] = 0 if diff_ok[i] else 1
        elif str(name) in ign_names:
            gt_ign[i] = 1
    det_ign = np.where(p["labels_name"] == cls, 0, -1).astype(np.int32)
    return gt_ign, det_ign


def kitti_eval(gts: List[Dict], preds: List[Dict],
               class_names: Sequence[str] = ("Pedestrian", "Cyclist",
                                             "Car"), device=None) -> Dict:
    """gts/preds: per-frame dicts with "boxes" (N, 7) with GRAVITY-center
    z — iou_3d derives z extents as cz -/+ h/2, so bottom-center inputs
    get wrong z overlaps whenever pred and GT heights differ (consistency
    between the two is NOT sufficient); "labels_name"; preds add
    "scores"; gts may add "bbox_heights"/"occluded"/"truncated".

    Returns {"{cls}_3d_{difficulty}": AP_R40, ..., "mAP_3d_moderate": ...}.
    device: where iou_3d runs (`resolve_device`: the card by default).
    """
    dev = resolve_device(device)
    results = {}
    for cls in class_names:
        thr = IOU_THRESHOLDS.get(cls, 0.5)
        # the IoU matrix depends only on (frame, class): compute it once
        # and reuse across difficulty buckets and thresholds
        iou_cache = []
        for g, p in zip(gts, preds):
            iou_cache.append(_iou3d_np(p["boxes"], g["boxes"], dev))
        for diff in DIFFICULTY:
            frames = []
            npos = 0
            for (g, p), ious in zip(zip(gts, preds), iou_cache):
                gt_ign, det_ign = _clean_frame(g, p, cls, diff)
                npos += int(np.sum(gt_ign == 0))
                frames.append((ious, gt_ign, det_ign,
                               np.asarray(p["scores"], float)))
            # pass 1: matched-TP scores at thresh 0 -> threshold grid
            all_tp_scores: List[float] = []
            for ious, gt_ign, det_ign, scores in frames:
                _, _, _, s = compute_statistics(
                    ious, gt_ign, det_ign, scores, thr,
                    thresh=0.0, compute_fp=False)
                all_tp_scores.extend(s)
            if npos == 0:
                results[f"{cls}_3d_{diff}"] = 0.0
                continue
            thresholds = get_thresholds(np.asarray(all_tp_scores), npos)
            # pass 2: per-threshold re-matching
            precision = np.zeros(N_SAMPLE_PTS)
            for ti, t in enumerate(thresholds):
                tp_t = fp_t = 0
                for ious, gt_ign, det_ign, scores in frames:
                    tp, fp, _, _ = compute_statistics(
                        ious, gt_ign, det_ign, scores, thr,
                        thresh=t, compute_fp=True)
                    tp_t += tp
                    fp_t += fp
                precision[ti] = tp_t / max(tp_t + fp_t, 1)
            for i in range(N_SAMPLE_PTS):
                precision[i] = np.max(precision[i:])
            results[f"{cls}_3d_{diff}"] = float(np.mean(precision[1:]))
    for diff in DIFFICULTY:
        results[f"mAP_3d_{diff}"] = float(np.mean(
            [results[f"{c}_3d_{diff}"] for c in class_names]))
    return results
