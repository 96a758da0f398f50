"""Seeded dataset roots in the real on-disk formats, for smoke runs and
tests of the data path when no dataset is at hand.

Each writer lays out a directory the way the mmdet3d data-prep step does
and the datasets of `datasets.py` read it: `.bin` float32 point files, an
info pickle per split (data_root-relative paths), camera frames, and for
nuScenes and KITTI a GT-database pickle with its object point files.
Sizes are arguments, so one writer serves a test at a few hundred points
and a run at a real frame's density.  Camera frames are `.npy` uint8
(H, W, 3) arrays unless `image_ext` names a format PIL writes (PIL is
imported only then).

    write_nuscenes_root(root, n_train=4, n_val=2, cams=True)
    write_kitti_root(root, n_train=4, n_val=2)
    write_waymo_root(root, n_train=2, n_val=1)
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

NUS_CLASSES = ("car", "truck", "construction_vehicle", "bus", "trailer",
               "barrier", "motorcycle", "bicycle", "pedestrian",
               "traffic_cone")
NUS_CAMS = ("CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_FRONT_LEFT", "CAM_BACK",
            "CAM_BACK_LEFT", "CAM_BACK_RIGHT")
# (w, l, h) in metres of a typical object of each class
_SIZES = {"car": (1.9, 4.6, 1.7), "truck": (2.5, 7.0, 2.9),
          "construction_vehicle": (2.8, 6.4, 3.2), "bus": (2.9, 11.0, 3.5),
          "trailer": (2.9, 12.0, 3.9), "barrier": (2.5, 0.5, 1.0),
          "motorcycle": (0.8, 2.1, 1.5), "bicycle": (0.6, 1.7, 1.3),
          "pedestrian": (0.7, 0.7, 1.8), "traffic_cone": (0.4, 0.4, 1.1),
          "Car": (1.6, 3.9, 1.6), "Pedestrian": (0.6, 0.8, 1.7),
          "Cyclist": (0.6, 1.8, 1.7)}


def _points(rng, n: int, dim: int, lo: Sequence[float],
            hi: Sequence[float]) -> np.ndarray:
    """n points uniform in the box [lo, hi] (xyz), intensity in [0, 1),
    further channels zero (the time lag of a key frame)."""
    pts = np.zeros((n, dim), np.float32)
    for d in range(3):
        pts[:, d] = rng.uniform(lo[d], hi[d], n)
    pts[:, 3] = rng.uniform(0, 1, n)
    return pts


def _boxes(rng, names: Sequence[str], lo, hi) -> np.ndarray:
    """(N, 7) [cx, cy, cz, w, l, h, yaw] with bottom-centre z on the
    ground (z = lo[2] + 0.3 m) and each class's size, +-10 %."""
    n = len(names)
    b = np.zeros((n, 7), np.float64)
    b[:, 0] = rng.uniform(lo[0], hi[0], n)
    b[:, 1] = rng.uniform(lo[1], hi[1], n)
    b[:, 3:6] = np.array([_SIZES[c] for c in names]) * \
        rng.uniform(0.9, 1.1, (n, 3))
    b[:, 2] = lo[2] + 0.3
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


def _plant(rng, pts: np.ndarray, boxes: np.ndarray, per_box: int) -> None:
    """Overwrite the first per_box * N points with points inside each box
    (bottom-centre z), so every object has LiDAR returns."""
    for i, b in enumerate(boxes):
        sl = slice(i * per_box, (i + 1) * per_box)
        loc = rng.uniform(-0.5, 0.5, (per_box, 3)) * b[3:6]
        c, s = np.cos(b[6]), np.sin(b[6])
        pts[sl, 0] = b[0] + loc[:, 0] * c - loc[:, 1] * s
        pts[sl, 1] = b[1] + loc[:, 0] * s + loc[:, 1] * c
        pts[sl, 2] = b[2] + b[5] / 2 + loc[:, 2]


def _per_box(per_box: Optional[int], points: int, boxes: int) -> int:
    """Points planted a box: `per_box`, or min(20, points // boxes)."""
    if per_box is None:
        return min(20, points // max(boxes, 1))
    if per_box * boxes > points:
        raise ValueError(f"{per_box} points in each of {boxes} boxes exceed "
                         f"the frame's {points}")
    return per_box


def _write_image(path: str, img: np.ndarray) -> str:
    if path.endswith(".npy"):
        np.save(path, img)
    else:
        from PIL import Image
        Image.fromarray(img).save(path)
    return path


def _frame(rng, hw: Tuple[int, int]) -> np.ndarray:
    """A uint8 (H, W, 3) frame: a smooth seeded gradient plus noise."""
    h, w = hw
    y = np.linspace(0, 1, h, dtype=np.float32)[:, None, None]
    x = np.linspace(0, 1, w, dtype=np.float32)[None, :, None]
    base = 255 * (0.25 + 0.5 * y * rng.uniform(0.2, 1, 3) +
                  0.25 * x * rng.uniform(0.2, 1, 3))
    noise = rng.integers(-20, 21, (h, w, 3))
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def surround_rig(rng, n_cam: int, hw: Tuple[int, int]):
    """Per camera (sensor2lidar rotation (3, 3), translation (3,),
    intrinsic (3, 3)): pinholes evenly spaced in yaw, nuScenes' field of
    view (f = 1266 px at 1600 px wide), 1.5 m above the ground with the
    LiDAR at 1.84 m, small seeded jitter."""
    h, w = hw
    f = 1266.0 * w / 1600.0
    k = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]])
    out = []
    for cam in range(n_cam):
        yaw = 2 * np.pi * cam / n_cam + np.deg2rad(rng.uniform(-2, 2))
        pos = np.array([0.0, 0.0, -0.34]) + rng.uniform(-0.05, 0.05, 3)
        # camera axes in the LiDAR frame: x right, y down, z forward
        lidar2cam = np.array([[np.sin(yaw), -np.cos(yaw), 0.0],
                              [0.0, 0.0, -1.0],
                              [np.cos(yaw), np.sin(yaw), 0.0]])
        out.append((lidar2cam.T, pos, k))
    return out


def _dump(path: str, obj) -> str:
    with open(path, "wb") as f:
        pickle.dump(obj, f)
    return path


def _gt_database(rng, root: str, classes: Sequence[str], per_class: int,
                 dim: int, box_dim: int, name: str) -> str:
    """{class: [{path, box3d_lidar, num_points_in_gt, difficulty}]} with
    box-relative object points; returns the pickle's path."""
    os.makedirs(os.path.join(root, "gt_database"), exist_ok=True)
    db: Dict[str, List[Dict]] = {}
    for cls in classes:
        items = []
        for j in range(per_class):
            box = np.zeros(box_dim, np.float32)
            box[:7] = _boxes(rng, [cls], (-40, -40, -2.0), (40, 40, 0))[0]
            n = int(rng.integers(20, 200))
            pts = _points(rng, n, dim, -box[3:6] / 2, box[3:6] / 2)
            pts[:, 2] += box[5] / 2
            rel = f"gt_database/{cls}_{j}.bin"
            pts.tofile(os.path.join(root, rel))
            items.append({"path": rel, "box3d_lidar": box,
                          "num_points_in_gt": n, "difficulty": 0})
        db[cls] = items
    return _dump(os.path.join(root, name), db)


def write_nuscenes_root(root: str, n_train: int = 4, n_val: int = 2,
                        points: int = 34688, sweeps: int = 10,
                        boxes: int = 35, cams: bool = False,
                        img_hw: Tuple[int, int] = (900, 1600),
                        image_ext: str = ".npy", db_per_class: int = 3,
                        seed: int = 0, per_box: Optional[int] = None
                        ) -> Dict[str, str]:
    """nuScenes in the mmdet3d info format: each keyframe a (points, 5)
    .bin, `sweeps` past sweeps of the same density with their
    sensor2lidar poses and timestamps, `boxes` GT boxes over the ten
    classes (gravity-centre z, velocities, LiDAR point counts, a few with
    none), and with `cams` the six camera frames and their calibration.
    `per_box` keyframe points are planted in each box (default
    min(20, points // boxes), and random LiDAR point counts); given, it is
    every box's num_lidar_pts too, so no box drops out of the GT.  Returns
    the paths: root, train, val, db."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "samples"), exist_ok=True)
    lo, hi = (-54.0, -54.0, -4.0), (54.0, 54.0, 2.0)
    splits = {}
    for split, count in (("train", n_train), ("val", n_val)):
        infos = []
        for i in range(count):
            tag = f"{split}{i:03d}"
            ts = 1_533_151_603_547_590 + 500_000 * i
            names = [NUS_CLASSES[k % len(NUS_CLASSES)]
                     for k in rng.permutation(boxes)]
            gt = _boxes(rng, names, (-45, -45, lo[2]), (45, 45, 0))
            key = _points(rng, points, 5, lo, hi)
            _plant(rng, key, gt, _per_box(per_box, points, boxes))
            rel = f"samples/{tag}.bin"
            key.tofile(os.path.join(root, rel))
            sw = []
            for k in range(sweeps):
                sp = _points(rng, points, 5, lo, hi)
                srel = f"samples/{tag}_sweep{k}.bin"
                sp.tofile(os.path.join(root, srel))
                a = rng.uniform(-0.02, 0.02)
                rot = np.array([[np.cos(a), -np.sin(a), 0],
                                [np.sin(a), np.cos(a), 0], [0, 0, 1]])
                sw.append({"data_path": srel,
                           "sensor2lidar_rotation": rot,
                           "sensor2lidar_translation":
                               np.array([-0.5 * (k + 1), 0.0, 0.0]) +
                               rng.normal(0, 0.02, 3),
                           "timestamp": ts - 50_000 * (k + 1)})
            centre = gt.copy()
            centre[:, 2] += centre[:, 5] / 2         # gravity centre
            npts = rng.integers(0, 400, len(names))
            npts[rng.random(len(names)) < 0.1] = 0
            if per_box is not None:       # each box holds what was planted
                npts[:] = per_box
            info = {"token": tag, "lidar_path": rel, "sweeps": sw,
                    "timestamp": ts, "gt_boxes": centre,
                    "gt_names": np.array(names),
                    "gt_velocity": rng.normal(0, 2, (len(names), 2)),
                    "num_lidar_pts": npts,
                    "valid_flag": npts > 0}
            if cams:
                info["cams"] = {}
                for cam, (r, t, k) in zip(NUS_CAMS,
                                          surround_rig(rng, 6, img_hw)):
                    crel = f"samples/{tag}_{cam}{image_ext}"
                    _write_image(os.path.join(root, crel),
                                 _frame(rng, img_hw))
                    info["cams"][cam] = {
                        "data_path": crel, "sensor2lidar_rotation": r,
                        "sensor2lidar_translation": t, "cam_intrinsic": k}
            infos.append(info)
        splits[split] = _dump(
            os.path.join(root, f"nuscenes_infos_{split}.pkl"),
            {"infos": infos, "metadata": {"version": "v1.0-trainval"}})
    db = _gt_database(rng, root, NUS_CLASSES, db_per_class, 5, 9,
                      "nuscenes_dbinfos_train.pkl")
    return {"root": root, "train": splits["train"], "val": splits["val"],
            "db": db}


def _kitti_calib(rng, hw: Tuple[int, int], n_views: int = 1) -> Dict:
    """P0..P{n-1} (3, 4) with P2 the front camera, R0_rect (3, 3) and
    Tr_velo_to_cam (3, 4): camera z forward along LiDAR x."""
    h, w = hw
    f = 721.5 * w / 1242.0
    calib = {}
    for v in range(max(n_views, 3)):
        p = np.zeros((3, 4))
        p[:3, :3] = [[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]]
        p[0, 3] = rng.uniform(-50, 50)
        calib[f"P{v}"] = p
    a = np.deg2rad(rng.uniform(-0.5, 0.5))
    calib["R0_rect"] = np.array([[np.cos(a), -np.sin(a), 0],
                                 [np.sin(a), np.cos(a), 0], [0, 0, 1]])
    tr = np.zeros((3, 4))
    tr[:3, :3] = [[0, -1, 0], [0, 0, -1], [1, 0, 0]]
    tr[:, 3] = [0.0, -0.08, -0.27] + rng.normal(0, 0.01, 3)
    calib["Tr_velo_to_cam"] = tr
    return calib


def _kitti_like_root(root: str, prefix: str, n_train: int, n_val: int,
                     points: int, dim: int, boxes: int, classes,
                     lo, hi, views: int, img_hw, image_ext: str,
                     db_per_class: int, seed: int,
                     per_box: Optional[int] = None) -> Dict[str, str]:
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "velodyne"), exist_ok=True)
    for v in range(views):
        os.makedirs(os.path.join(root, f"image_{v}"), exist_ok=True)
    splits = {}
    idx = 0
    for split, count in (("train", n_train), ("val", n_val)):
        infos = []
        for _ in range(count):
            names = [classes[k % len(classes)] for k in
                     rng.permutation(boxes)]
            gt = _boxes(rng, names, (lo[0] + 2, lo[1] + 2, lo[2]),
                        (hi[0] - 2, hi[1] - 2, 0))
            pts = _points(rng, points, dim, lo, hi)
            _plant(rng, pts, gt, _per_box(per_box, points, boxes))
            rel = f"velodyne/{idx:06d}.bin"
            pts.tofile(os.path.join(root, rel))
            for v in range(views):
                _write_image(
                    os.path.join(root, f"image_{v}/{idx:06d}{image_ext}"),
                    _frame(rng, img_hw))
            # stock infos keep trailing DontCare rows in `name`
            info = {"point_cloud": {"velodyne_path": rel},
                    "image": {"image_path": f"image_0/{idx:06d}{image_ext}",
                              "image_shape": np.array(img_hw)},
                    "calib": _kitti_calib(rng, img_hw, views),
                    "annos": {"gt_boxes_lidar": gt.astype(np.float32),
                              "name": np.array(names + ["DontCare"])}}
            infos.append(info)
            idx += 1
        splits[split] = _dump(
            os.path.join(root, f"{prefix}_infos_{split}.pkl"), infos)
    out = {"root": root, "train": splits["train"], "val": splits["val"]}
    if db_per_class:
        out["db"] = _gt_database(rng, root, classes, db_per_class, dim, 7,
                                 f"{prefix}_dbinfos_train.pkl")
    return out


def write_kitti_root(root: str, n_train: int = 4, n_val: int = 2,
                     points: int = 120_000, boxes: int = 12,
                     img_hw: Tuple[int, int] = (375, 1242),
                     image_ext: str = ".npy", db_per_class: int = 3,
                     seed: int = 0, per_box: Optional[int] = None
                     ) -> Dict[str, str]:
    """KITTI in the mmdet3d info format: (points, 4) velodyne .bin files in
    the forward field of view, the front camera's frame (image_0/), calib
    (P0-P2, R0_rect, Tr_velo_to_cam) and annos (gt_boxes_lidar, bottom-
    centre z, and names with a trailing DontCare); `per_box` as in
    write_nuscenes_root."""
    return _kitti_like_root(root, "kitti", n_train, n_val, points, 4, boxes,
                            ("Pedestrian", "Cyclist", "Car"),
                            (0.0, -40.0, -3.0), (70.4, 40.0, 1.0), 1, img_hw,
                            image_ext, db_per_class, seed, per_box)


def write_waymo_root(root: str, n_train: int = 2, n_val: int = 1,
                     points: int = 150_000, boxes: int = 20, views: int = 5,
                     img_hw: Tuple[int, int] = (1280, 1920),
                     image_ext: str = ".npy", seed: int = 0,
                     per_box: Optional[int] = None) -> Dict[str, str]:
    """Waymo through the mmdet3d kitti-format conversion: (points, 6) .bin
    files around the car, `views` camera frames (image_0/ ... image_{n-1}/,
    projections P0 ...) and annos with the three classes; `per_box` as in
    write_nuscenes_root."""
    return _kitti_like_root(root, "waymo", n_train, n_val, points, 6, boxes,
                            ("Car", "Pedestrian", "Cyclist"),
                            (-75.2, -75.2, -2.0), (75.2, 75.2, 4.0), views,
                            img_hw, image_ext, 0, seed, per_box)
