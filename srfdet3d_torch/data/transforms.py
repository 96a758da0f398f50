"""Host-side point-cloud pipeline transforms (numpy).

A copy of the JAX package's `data/transforms.py`: the same numpy code and
the same `np.random.Generator` draws.  As in the JAX package, the .bin load
goes through `native.py`, whose C++ route (the default) equals the JAX
package's C++ extension and whose numpy route (SRFDET_POINT_IO=numpy)
its numpy fallback; `filter_pad` here is the numpy route of the range
filter with shuffle and pad, which `native.filter_pad_fast` takes on that
route.

Replacements for the mmdet3d pipeline ops the reference configs
compose (cfg srfdet_voxel_nusc_L.py:193-262): LoadPointsFromFile,
LoadPointsFromMultiSweeps, ObjectSample (GT-paste), GlobalRotScaleTrans,
RandomFlip3D, Points/Object range filters, PointShuffle — plus the
capacity-padding collate steps the static-shape model contract needs.

Boxes here are numpy (N, 7|9) [cx, cy, cz(bottom), w, l, h, yaw(, vx, vy)]
in LiDAR frame — same layout as mmdet3d LiDARInstance3DBoxes.tensor; model
GTs use gravity-center z (converted in the collate step, mirroring
`gt_bboxes.gravity_center` at reference srfdet_head.py:794,1062).
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def limit_period(val: np.ndarray, offset: float = 0.5,
                 period: float = 2 * np.pi) -> np.ndarray:
    """Wrap angles into [-offset*period, (1-offset)*period)."""
    return val - np.floor(val / period + offset) * period


def load_points_bin(path: str, load_dim: int = 5,
                    use_dim: Optional[Sequence[int]] = None) -> np.ndarray:
    """Read a .bin float32 point file (KITTI/nuScenes layout), through
    the route `native.py` selects."""
    from .native import load_points_fast
    pts = load_points_fast(path, load_dim)
    if use_dim is not None and list(use_dim) != list(range(load_dim)):
        pts = pts[:, list(use_dim)]
    return pts


def remove_close(points: np.ndarray, radius: float = 1.0) -> np.ndarray:
    """Drop points within `radius` of the sensor in x/y (ego returns)."""
    keep = ~((np.abs(points[:, 0]) < radius) &
             (np.abs(points[:, 1]) < radius))
    return points[keep]


def multi_sweep_aggregate(points: np.ndarray,
                          sweeps: Sequence[Dict],
                          sweeps_num: int = 10,
                          use_dim: Sequence[int] = (0, 1, 2, 3, 4),
                          rng: Optional[np.random.Generator] = None,
                          test_mode: bool = False,
                          load_dim: int = 5,
                          key_timestamp_us: float = 0.0,
                          remove_close_sweeps: bool = False) -> np.ndarray:
    """LoadPointsFromMultiSweeps: concat transformed past sweeps.

    Each sweep dict: {"data_path", "sensor2lidar_rotation" (3,3),
    "sensor2lidar_translation" (3,), "timestamp" (microseconds), ...}.
    The key frame's time-lag channel (dim 4) is zeroed; sweep points get
    their lag in seconds relative to `key_timestamp_us` (the key frame's
    microsecond timestamp, mmdet3d convention).  Train mode samples
    sweeps_num without replacement; test mode takes the first sweeps_num.
    remove_close_sweeps mirrors mmdet3d's LoadPointsFromMultiSweeps
    remove_close flag, default False — no shipped reference config
    enables it (srfdet_voxel_nusc_LC.py even comments it out), so
    applying it unconditionally would drop every sweep point within 1 m
    of the sensor and diverge the point composition.
    """
    use_dim = list(use_dim)
    if points.shape[1] != len(use_dim):
        raise ValueError(
            f"key points have {points.shape[1]} dims, use_dim selects "
            f"{len(use_dim)} — the caller must load the key frame with the "
            f"same use_dim")
    points = points.copy()
    # the time-lag channel is RAW column 4; locate it in the use_dim slice
    tpos = use_dim.index(4) if 4 in use_dim else None
    if tpos is not None:
        points[:, tpos] = 0.0
    out = [points]
    if len(sweeps) > 0:
        if len(sweeps) <= sweeps_num:
            choices = np.arange(len(sweeps))
        elif test_mode:
            choices = np.arange(sweeps_num)
        else:
            rng = rng or np.random.default_rng()
            choices = rng.choice(len(sweeps), sweeps_num, replace=False)
        ts = key_timestamp_us * 1e-6
        for idx in choices:
            sweep = sweeps[idx]
            pts = load_points_bin(sweep["data_path"], load_dim,
                                  list(range(load_dim)))
            if remove_close_sweeps:
                pts = remove_close(pts)
            xyz = pts[:, :3] @ np.asarray(
                sweep["sensor2lidar_rotation"]).T + np.asarray(
                sweep["sensor2lidar_translation"])
            pts[:, :3] = xyz
            if load_dim > 4:
                # KeyError on a malformed sweep like mmdet3d — a silent
                # default would poison the lag channel with ~1.7e9 s
                pts[:, 4] = ts - sweep["timestamp"] * 1e-6
            out.append(pts[:, use_dim])
    return np.concatenate(out, axis=0)


def global_rot_scale_trans(points: np.ndarray,
                           boxes: Optional[np.ndarray],
                           rng: np.random.Generator,
                           rot_range: Tuple[float, float] = (-0.785, 0.785),
                           scale_range: Tuple[float, float] = (0.9, 1.1),
                           trans_std: Tuple[float, float, float] = (0.5,) * 3):
    """GlobalRotScaleTrans (order rotate -> scale -> translate, mmdet3d).

    Rotation about +z by angle a: [x, y] -> [x cos - y sin, x sin + y cos];
    box yaw += a.  Scaling multiplies xyz, sizes and velocities; translation
    adds noise to xyz.
    """
    angle = rng.uniform(*rot_range)
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, -s], [s, c]], points.dtype)

    points = points.copy()
    points[:, :2] = points[:, :2] @ rot.T
    if boxes is not None and len(boxes):
        boxes = boxes.copy()
        boxes[:, :2] = boxes[:, :2] @ rot.T
        boxes[:, 6] += angle
        if boxes.shape[1] > 7:
            boxes[:, 7:9] = boxes[:, 7:9] @ rot.T

    scale = rng.uniform(*scale_range)
    points[:, :3] *= scale
    if boxes is not None and len(boxes):
        boxes[:, :6] *= scale
        if boxes.shape[1] > 7:
            boxes[:, 7:9] *= scale

    trans = rng.normal(scale=trans_std, size=3).astype(points.dtype)
    points[:, :3] += trans
    if boxes is not None and len(boxes):
        boxes[:, :3] += trans
    return points, boxes


def flip_horizontal_3d(points: np.ndarray, boxes: Optional[np.ndarray]):
    """In-place horizontal (y-axis) flip of points and boxes: y -> -y,
    yaw -> -yaw, vy -> -vy (mmdet3d LiDARInstance3DBoxes.flip)."""
    points[:, 1] = -points[:, 1]
    if boxes is not None and len(boxes):
        boxes[:, 1] = -boxes[:, 1]
        boxes[:, 6] = -boxes[:, 6]
        if boxes.shape[1] > 7:
            boxes[:, 8] = -boxes[:, 8]
    return points, boxes


def random_flip_3d(points: np.ndarray,
                   boxes: Optional[np.ndarray],
                   rng: np.random.Generator,
                   flip_ratio_horizontal: float = 0.5,
                   flip_ratio_vertical: float = 0.5):
    """RandomFlip3D. Horizontal = flip y (yaw -> -yaw), vertical = flip x
    (yaw -> -yaw + pi); velocities flip with their axis (mmdet3d)."""
    points = points.copy()
    boxes = boxes.copy() if boxes is not None else None
    flip_h = rng.uniform() < flip_ratio_horizontal
    flip_v = rng.uniform() < flip_ratio_vertical
    if flip_h:
        points, boxes = flip_horizontal_3d(points, boxes)
    if flip_v:
        points[:, 0] = -points[:, 0]
        if boxes is not None and len(boxes):
            boxes[:, 0] = -boxes[:, 0]
            boxes[:, 6] = -boxes[:, 6] + np.pi
            if boxes.shape[1] > 7:
                boxes[:, 7] = -boxes[:, 7]
    return points, boxes, (flip_h, flip_v)


def object_noise(points: np.ndarray, boxes: Optional[np.ndarray],
                 rng: np.random.Generator,
                 trans_std: Tuple[float, float, float] = (1.0, 1.0, 0.5),
                 rot_range: Tuple[float, float] = (-0.78539816, 0.78539816),
                 num_try: int = 100):
    """Per-object noise (mmdet3d ObjectNoise; reference
    srfdet_voxel_kitti_L.py:247-251): each GT box gets an independent
    random yaw rotation about its OWN center plus a gaussian translation,
    applied to the box and to the points inside it.  A candidate noise is
    rejected (up to num_try draws) if the moved box would overlap any
    other current box in BEV — an EXACT separating-axis test (mmdet3d's
    box_collision_test role; a coarse circle test would reject every
    candidate for objects with nearby neighbors and silently disable the
    aug in cluttered scenes).  Point membership is computed once up
    front, like mmdet3d's noise_per_object_v3_.
    """
    if boxes is None or len(boxes) == 0:
        return points, boxes
    from .box_np import bev_overlap_exact, points_in_boxes_3d
    boxes = boxes.copy()
    points = points.copy()
    inside = points_in_boxes_3d(points[:, :3], boxes)      # (N, M)
    for i in range(len(boxes)):
        others = np.delete(boxes, i, axis=0)
        for _ in range(num_try):
            trans = rng.normal(scale=trans_std, size=3).astype(points.dtype)
            ang = float(rng.uniform(*rot_range))
            cand = boxes[i].copy()
            cand[:3] += trans
            cand[6] += ang
            if bev_overlap_exact(cand, others).any():
                continue
            m = inside[:, i]
            c, s = np.cos(ang), np.sin(ang)
            rot = np.array([[c, -s], [s, c]], points.dtype)
            rel = points[m, :2] - boxes[i, :2]
            points[m, :2] = rel @ rot.T + boxes[i, :2] + trans[:2]
            points[m, 2] += trans[2]
            boxes[i] = cand
            break
    return points, boxes


def points_range_filter(points: np.ndarray,
                        pc_range: Sequence[float]) -> np.ndarray:
    m = ((points[:, 0] >= pc_range[0]) & (points[:, 0] <= pc_range[3]) &
         (points[:, 1] >= pc_range[1]) & (points[:, 1] <= pc_range[4]) &
         (points[:, 2] >= pc_range[2]) & (points[:, 2] <= pc_range[5]))
    return points[m]


def object_range_filter(boxes: np.ndarray, labels: np.ndarray,
                        pc_range: Sequence[float]):
    """Keep boxes with BEV center in range; wrap yaw to [-pi, pi]
    (mmdet3d ObjectRangeFilter)."""
    if len(boxes) == 0:
        return boxes, labels
    m = ((boxes[:, 0] >= pc_range[0]) & (boxes[:, 0] <= pc_range[3]) &
         (boxes[:, 1] >= pc_range[1]) & (boxes[:, 1] <= pc_range[4]))
    boxes, labels = boxes[m].copy(), labels[m]
    boxes[:, 6] = limit_period(boxes[:, 6], 0.5, 2 * np.pi)
    return boxes, labels


def object_name_filter(boxes: np.ndarray, labels: np.ndarray,
                       num_classes: int):
    m = (labels >= 0) & (labels < num_classes)
    return boxes[m], labels[m]


def point_shuffle(points: np.ndarray,
                  rng: np.random.Generator) -> np.ndarray:
    return points[rng.permutation(len(points))]


def pad_points(points: np.ndarray, cap: int):
    """Pad/truncate to (cap, D) + mask. Truncation keeps a random-free
    prefix (callers shuffle first in train mode)."""
    n, d = points.shape
    out = np.zeros((cap, d), np.float32)
    k = min(n, cap)
    out[:k] = points[:k]
    mask = np.zeros((cap,), bool)
    mask[:k] = True
    return out, mask


def filter_pad(points: np.ndarray, pc_range: Sequence[float], cap: int,
               shuffle: bool = True, seed: int = 0
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Range filter, then (optionally) a shuffle drawn from
    default_rng(seed), then pad to the capacity: (cap, D) float32 and its
    (cap,) mask.  Over capacity the shuffle picks the random subset kept."""
    pts = points_range_filter(points, pc_range)
    if shuffle:
        pts = point_shuffle(pts, np.random.default_rng(seed))
    return pad_points(pts, cap)


def pad_gts(boxes: np.ndarray, labels: np.ndarray, cap: int,
            box_dim: int = 9):
    """Pad GTs to (cap, box_dim) with gravity-center z (model convention)."""
    out = np.zeros((cap, box_dim), np.float32)
    lab = np.zeros((cap,), np.int32)
    mask = np.zeros((cap,), bool)
    k = min(len(boxes), cap)
    if k:
        b = boxes[:k, :box_dim].astype(np.float32).copy()
        if boxes.shape[1] < box_dim:
            b = np.zeros((k, box_dim), np.float32)
            b[:, :boxes.shape[1]] = boxes[:k]
        b[:, 2] += 0.5 * b[:, 5]           # bottom -> gravity center
        out[:k] = b
        lab[:k] = labels[:k]
        mask[:k] = True
    return out, lab, mask


@dataclasses.dataclass
class DBSampler:
    """GT-database paste augmentation (mmdet3d ObjectSample/DataBaseSampler).

    info_path: pickle of {class_name: [{"path", "box3d_lidar" (7|9,),
    "num_points_in_gt", ...}, ...]}.  For each class, samples up to
    sample_groups[cls] - n_existing objects, rejecting BEV-overlapping
    candidates, and pastes their points (translated to the box) into the
    scene.
    """
    info_path: str
    data_root: str
    classes: Sequence[str]
    sample_groups: Dict[str, int]
    min_points: Dict[str, int] = dataclasses.field(default_factory=dict)
    rate: float = 1.0
    points_load_dim: int = 5
    points_use_dim: Sequence[int] = (0, 1, 2, 3, 4)

    def __post_init__(self):
        with open(self.info_path, "rb") as f:
            infos = pickle.load(f)
        self.db: Dict[str, List[Dict]] = {}
        for cls in self.classes:
            items = infos.get(cls, [])
            min_pts = self.min_points.get(cls, 0)
            self.db[cls] = [
                it for it in items
                if it.get("num_points_in_gt", min_pts) >= min_pts and
                it.get("difficulty", 0) != -1]

    @staticmethod
    def _collides(box: np.ndarray, others: np.ndarray) -> bool:
        """Exact rotated-BEV overlap vs any existing box (mmdet3d's
        box_collision_test semantics; see box_np.bev_overlap_exact)."""
        from .box_np import bev_overlap_exact
        if len(others) == 0:
            return False
        return bool(bev_overlap_exact(box, others).any())

    def sample(self, gt_boxes: np.ndarray, gt_labels: np.ndarray,
               rng: np.random.Generator):
        """Returns (extra_boxes, extra_labels, extra_points)."""
        new_boxes, new_labels, new_points = [], [], []
        all_boxes = gt_boxes.copy() if len(gt_boxes) else \
            np.zeros((0, 7), np.float32)
        for ci, cls in enumerate(self.classes):
            want = self.sample_groups.get(cls, 0)
            have = int(np.sum(gt_labels == ci)) if len(gt_labels) else 0
            need = int((want - have) * self.rate)
            pool = self.db.get(cls, [])
            if need <= 0 or not pool:
                continue
            idxs = rng.choice(len(pool), min(need, len(pool)), replace=False)
            for i in idxs:
                item = pool[i]
                box = np.asarray(item["box3d_lidar"], np.float32)
                if self._collides(box, all_boxes):
                    continue
                path = os.path.join(self.data_root, item["path"])
                try:
                    pts = load_points_bin(path, self.points_load_dim,
                                          self.points_use_dim)
                except (FileNotFoundError, ValueError):
                    # a wrong data_root would otherwise silently disable
                    # the whole paste augmentation
                    if not getattr(self, "_warned_missing", False):
                        self._warned_missing = True
                        print(f"DBSampler: cannot load {path} — check "
                              f"data_root vs the dbinfos' gt_database "
                              f"location (warning printed once)",
                              flush=True)
                    continue
                pts = pts.copy()
                pts[:, :3] += box[:3]          # db points are box-relative
                new_boxes.append(box)
                new_labels.append(ci)
                new_points.append(pts)
                # pad narrower db boxes (7-dim) to the scene width (9-dim
                # with velocities) — slicing alone crashes the concat when
                # the db is narrower than the scene boxes
                row = box[None, :all_boxes.shape[1]]
                if row.shape[1] < all_boxes.shape[1]:
                    row = np.pad(
                        row, ((0, 0), (0, all_boxes.shape[1] - row.shape[1])))
                all_boxes = np.concatenate([all_boxes, row], axis=0)
        if not new_boxes:
            return (np.zeros((0, all_boxes.shape[1]), np.float32),
                    np.zeros((0,), np.int64),
                    np.zeros((0, len(self.points_use_dim)), np.float32))
        nb = np.stack(new_boxes)
        if nb.shape[1] < all_boxes.shape[1]:
            nb = np.pad(nb, ((0, 0), (0, all_boxes.shape[1] - nb.shape[1])))
        return (nb, np.asarray(new_labels, np.int64),
                np.concatenate(new_points, axis=0))

    def apply(self, points, gt_boxes, gt_labels, rng):
        """ObjectSample: paste sampled objects, remove scene points inside
        their boxes, prepend object points (mmdet3d behavior)."""
        extra_boxes, extra_labels, extra_points = self.sample(
            gt_boxes, gt_labels, rng)
        if len(extra_boxes) == 0:
            return points, gt_boxes, gt_labels
        from .box_np import points_in_boxes_3d
        inside = points_in_boxes_3d(points[:, :3], extra_boxes)
        points = points[~inside.any(axis=1)]
        if extra_points.shape[1] < points.shape[1]:
            pad = np.zeros((len(extra_points),
                            points.shape[1] - extra_points.shape[1]),
                           np.float32)
            extra_points = np.concatenate([extra_points, pad], axis=1)
        points = np.concatenate(
            [extra_points[:, :points.shape[1]], points], axis=0)
        gt_boxes = np.concatenate([gt_boxes, extra_boxes], axis=0) \
            if len(gt_boxes) else extra_boxes
        gt_labels = np.concatenate([gt_labels, extra_labels]) \
            if len(gt_labels) else extra_labels
        return points, gt_boxes, gt_labels
