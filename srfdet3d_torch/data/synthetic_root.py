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

Two more writers lay out RAW published trees, the input of
`tools/create_data.py`, which turns them into the info pickles and the GT
database:

    write_raw_kitti_root(root, n_train=4, n_val=2)
        training/{velodyne,label_2,calib,image_2}/, ImageSets/{train,val}.txt
    write_raw_nuscenes_root(root, n_train=4, n_val=2, sweeps=10)
        v1.0-*/ JSON tables (scenes, samples, the sample_data chain of
        each keyframe's sweeps, ego poses, calibrated sensors,
        annotations of instances that move through a scene), samples/,
        sweeps/
"""

from __future__ import annotations

import json
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


# ------------------------------------------------------------ raw trees

def _rot_z(t: float) -> np.ndarray:
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float64)


def _fmt(mat, rows: int, cols: int) -> str:
    return " ".join(f"{v:.12e}" for v in
                    np.asarray(mat, np.float64)[:rows, :cols].reshape(-1))


def write_raw_kitti_root(root: str, n_train: int = 4, n_val: int = 2,
                         points: int = 120_000, boxes: int = 12,
                         seed: int = 0, per_box: Optional[int] = None
                         ) -> Dict[str, object]:
    """A raw KITTI object tree: per frame a (points, 4) velodyne .bin in
    the forward field of view, a calib file (P0-P3, R0_rect,
    Tr_velo_to_cam: the axis swap with a small seeded rotation and offset)
    and a label_2 file written FORWARD from seeded LiDAR boxes (Car,
    Pedestrian, Cyclist; camera-frame bottom centres, h w l, rotation_y;
    2D heights, occlusion and truncation spread over the difficulty
    levels, one trailing DontCare row); `per_box` points planted in each
    box (default min(20, points // boxes)); ImageSets/train.txt and
    val.txt.  image_2/ stays empty: the tool records its paths only.
    Returns {"root", "train", "val": frame ids, "boxes": {id: (N, 7)
    LiDAR boxes [x, y, z, l, w, h, yaw], bottom-centre z}, "names":
    {id: [...]}}."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "ImageSets"), exist_ok=True)
    for sub in ("velodyne", "label_2", "calib", "image_2"):
        os.makedirs(os.path.join(root, "training", sub), exist_ok=True)
    ids = {"train": [f"{i:06d}" for i in range(n_train)],
           "val": [f"{i:06d}" for i in range(n_train, n_train + n_val)]}
    for split, rows in ids.items():
        with open(os.path.join(root, "ImageSets", f"{split}.txt"), "w") as f:
            f.write("".join(f"{r}\n" for r in rows))
    classes = ("Car", "Pedestrian", "Cyclist")
    lo, hi = (0.0, -40.0, -3.0), (70.4, 40.0, 1.0)
    out_boxes, out_names = {}, {}
    for idx in ids["train"] + ids["val"]:
        tr = np.eye(4)
        tr[:3, :3] = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]],
                              np.float64) @ _rot_z(rng.uniform(-0.03, 0.03))
        tr[:3, 3] = [0.27, -0.08, -0.9] + rng.normal(0, 0.01, 3)
        a = rng.uniform(-0.02, 0.02)
        r0 = np.eye(4)
        r0[:3, :3] = _rot_z(a / 2) @ np.array(
            [[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]])
        p2 = np.array([[721.5, 0, 609.6, 44.9], [0, 721.5, 172.9, 0.2],
                       [0, 0, 1, 0.003]])
        with open(os.path.join(root, "training", "calib", f"{idx}.txt"),
                  "w") as f:
            for k in ("P0", "P1", "P2", "P3"):
                f.write(f"{k}: {_fmt(p2, 3, 4)}\n")
            f.write(f"R0_rect: {_fmt(r0, 3, 3)}\n")
            f.write(f"Tr_velo_to_cam: {_fmt(tr, 3, 4)}\n")

        names = [classes[k % len(classes)] for k in rng.permutation(boxes)]
        # [x, y, z, l, w, h, yaw]: the length along the heading, as the
        # tool's gt_boxes_lidar
        gt = _boxes(rng, names, (lo[0] + 2, lo[1] + 2, lo[2]),
                    (hi[0] - 2, hi[1] - 2, 0))[:, [0, 1, 2, 4, 3, 5, 6]]
        lines = []
        for b, name in zip(gt, names):
            x, y, z, l, w, h, yaw = b
            loc = (r0 @ tr @ np.array([x, y, z, 1.0]))[:3]
            rot_y = -yaw - np.pi / 2
            rot_y = rot_y - np.floor(rot_y / (2 * np.pi) + 0.5) * 2 * np.pi
            h2d = rng.uniform(15.0, 80.0)
            occ = int(rng.integers(0, 4))
            trunc = rng.choice([0.0, 0.1, 0.25, 0.45, 0.7])
            top = rng.uniform(100.0, 200.0)
            left = rng.uniform(0.0, 1100.0)
            lines.append(
                f"{name} {trunc:.2f} {occ} {rng.uniform(-3, 3):.2f} "
                f"{left:.2f} {top:.2f} {left + rng.uniform(10, 140):.2f} "
                f"{top + h2d:.2f} {h:.6f} {w:.6f} {l:.6f} "
                f"{loc[0]:.6f} {loc[1]:.6f} {loc[2]:.6f} {rot_y:.6f}")
        lines.append("DontCare -1 -1 -10 500.00 170.00 540.00 200.00 -1 -1 "
                     "-1 -1000 -1000 -1000 -10")
        with open(os.path.join(root, "training", "label_2", f"{idx}.txt"),
                  "w") as f:
            f.write("\n".join(lines) + "\n")
        pts = _points(rng, points, 4, lo, hi)
        _plant(rng, pts, gt, _per_box(per_box, points, boxes))
        pts.tofile(os.path.join(root, "training", "velodyne", f"{idx}.bin"))
        out_boxes[idx] = gt
        out_names[idx] = names
    return {"root": root, "train": ids["train"], "val": ids["val"],
            "boxes": out_boxes, "names": out_names}


# nuScenes category -> detection class of the devkit, one raw name each
NUS_RAW_CATEGORIES = {
    "car": "vehicle.car", "truck": "vehicle.truck",
    "construction_vehicle": "vehicle.construction",
    "bus": "vehicle.bus.rigid", "trailer": "vehicle.trailer",
    "barrier": "movable_object.barrier", "motorcycle": "vehicle.motorcycle",
    "bicycle": "vehicle.bicycle", "pedestrian": "human.pedestrian.adult",
    "traffic_cone": "movable_object.trafficcone"}


def _yaw_quat(t: float) -> List[float]:
    return [float(np.cos(t / 2)), 0.0, 0.0, float(np.sin(t / 2))]


def _pose(yaw: float, xyz) -> np.ndarray:
    m = np.eye(4)
    m[:3, :3] = _rot_z(yaw)
    m[:3, 3] = xyz
    return m


def write_raw_nuscenes_root(root: str, n_train: int = 4, n_val: int = 2,
                            points: int = 34688, sweeps: int = 10,
                            boxes: int = 35, train_scenes: int = 1,
                            val_scenes: int = 1,
                            version: str = "v1.0-trainval", seed: int = 0,
                            per_box: Optional[int] = None
                            ) -> Dict[str, object]:
    """A raw nuScenes tree: the `version` JSON tables and the LiDAR files.
    Scenes scene-0001 ... hold the n_train keyframes (train_scenes of
    them, in turn), then the n_val ones (val_scenes more), 0.5 s apart;
    names sort the val scenes last, where the tool's --val-scene-frac
    takes them from.  Each keyframe is a (points, 5) .bin under
    samples/LIDAR_TOP/ (ring index in channel 4) with `sweeps` earlier
    LIDAR_TOP sweeps of the same density under sweeps/LIDAR_TOP/, chained
    by `prev` from the keyframe's sample_data, each with its own ego pose
    on the ego's path.  `boxes` instances a scene, over the ten classes
    and one category the tool drops ("animal"), move at constant
    velocity; each keyframe annotates them (prev/next chains, LiDAR and
    radar counts) and carries `per_box` points planted in each (default
    min(20, points // boxes)).  No cameras.  Returns {"root", "version",
    "scenes": {"train": [...], "val": [...]} names, "lidar_boxes":
    {sample token: (N, 7) gravity-centre LiDAR boxes of the ten classes},
    "names": {token: [...]}}."""
    rng = np.random.default_rng(seed)
    vdir = os.path.join(root, version)
    for d in (vdir, os.path.join(root, "samples", "LIDAR_TOP"),
              os.path.join(root, "sweeps", "LIDAR_TOP")):
        os.makedirs(d, exist_ok=True)
    t = {k: [] for k in ("scene", "sample", "sample_data", "ego_pose",
                         "calibrated_sensor", "sensor", "sample_annotation",
                         "instance", "category", "attribute", "visibility",
                         "log", "map")}
    l2e = _pose(0.01, [0.943, 0.0, 1.841])
    t["sensor"].append({"token": "sen_lidar", "channel": "LIDAR_TOP",
                        "modality": "lidar"})
    t["calibrated_sensor"].append({
        "token": "cs_lidar", "sensor_token": "sen_lidar",
        "rotation": _yaw_quat(0.01), "translation": [0.943, 0.0, 1.841],
        "camera_intrinsic": []})
    cats = list(NUS_RAW_CATEGORIES.values()) + ["animal"]
    t["category"] = [{"token": f"cat{i}", "name": n}
                     for i, n in enumerate(cats)]
    cat_token = {NUS_CLASSES[i]: f"cat{i}" for i in range(10)}
    cat_token["animal"] = f"cat{len(cats) - 1}"
    t["log"].append({"token": "log0", "location": "synthetic"})

    n_scenes = train_scenes + val_scenes
    frames = [[] for _ in range(n_scenes)]
    for i in range(n_train):
        frames[i % max(train_scenes, 1)].append(i)
    for i in range(n_val):
        frames[train_scenes + i % max(val_scenes, 1)].append(n_train + i)
    scenes = {"train": [], "val": []}
    lidar_boxes, box_names = {}, {}
    for sc, keys in enumerate(frames):
        if not keys:
            continue
        name = f"scene-{sc + 1:04d}"
        scenes["train" if sc < train_scenes else "val"].append(name)
        t0 = 1_533_151_600_000_000 + 100_000_000 * sc
        ego_yaw0 = rng.uniform(-np.pi, np.pi)
        ego_xy0 = rng.uniform(300, 1500, 2)
        speed = rng.uniform(2.0, 8.0)

        def ego(ts_us):
            dt = (ts_us - t0) / 1e6
            yaw = ego_yaw0 + 0.02 * dt
            xy = ego_xy0 + speed * dt * np.array([np.cos(ego_yaw0),
                                                  np.sin(ego_yaw0)])
            return yaw, [float(xy[0]), float(xy[1]), 0.0]

        # the scene's instances in the global frame at t0: centre
        # (gravity), velocity, yaw, size (w, l, h), category
        kinds = [(NUS_CLASSES + ("animal",))[k % 11]
                 for k in rng.permutation(boxes)]
        sizes = np.array([_SIZES.get(k, (0.5, 1.0, 0.8)) for k in kinds]) * \
            rng.uniform(0.9, 1.1, (boxes, 3))
        e2g = _pose(*ego(t0))
        # ego frame: the ground at z = 0
        local = np.stack([rng.uniform(-40, 40, boxes),
                          rng.uniform(-40, 40, boxes),
                          sizes[:, 2] / 2 + rng.uniform(-0.2, 0.2, boxes)],
                         1)
        centre0 = (e2g @ np.concatenate(
            [local, np.ones((boxes, 1))], 1).T).T[:, :3]
        vel = np.concatenate([rng.normal(0, 1.5, (boxes, 2)),
                              np.zeros((boxes, 1))], 1)
        yaw_g = rng.uniform(-np.pi, np.pi, boxes)
        for b in range(boxes):
            t["instance"].append({
                "token": f"inst{sc}_{b}",
                "category_token": cat_token[kinds[b]],
                "nbr_annotations": len(keys)})
        stoks = [f"smp{k:04d}" for k in keys]
        t["scene"].append({
            "token": f"scene{sc}", "name": name, "log_token": "log0",
            "nbr_samples": len(keys), "first_sample_token": stoks[0],
            "last_sample_token": stoks[-1]})
        for j, (k, stok) in enumerate(zip(keys, stoks)):
            ts = t0 + 500_000 * j
            anns = [f"ann{sc}_{b}_{j}" for b in range(boxes)]
            t["sample"].append({
                "token": stok, "timestamp": ts, "scene_token": f"scene{sc}",
                "prev": stoks[j - 1] if j else "",
                "next": stoks[j + 1] if j + 1 < len(keys) else "",
                "anns": anns})
            chain = [(f"sd_l{k}", ts, True)] + [
                (f"sd_l{k}_s{s}", ts - 45_000 * (s + 1), False)
                for s in range(sweeps)]
            for c, (sd, sts, key) in enumerate(chain):
                yaw, xyz = ego(sts)
                t["ego_pose"].append({"token": f"ep_{sd}", "timestamp": sts,
                                      "rotation": _yaw_quat(yaw),
                                      "translation": xyz})
                rel = (f"samples/LIDAR_TOP/{stok}.bin" if key else
                       f"sweeps/LIDAR_TOP/{stok}_{c - 1}.bin")
                t["sample_data"].append({
                    "token": sd, "sample_token": stok,
                    "ego_pose_token": f"ep_{sd}",
                    "calibrated_sensor_token": "cs_lidar",
                    "filename": rel, "fileformat": "pcd",
                    "is_key_frame": key, "timestamp": sts,
                    "prev": chain[c + 1][0] if c + 1 < len(chain) else "",
                    "next": chain[c - 1][0] if c else ""})
                pts = _points(rng, points, 5, (-54.0, -54.0, -4.0),
                              (54.0, 54.0, 2.0))
                pts[:, 4] = rng.integers(0, 32, points)
                if key:
                    l2g = _pose(*ego(ts)) @ l2e
                    g2l = np.linalg.inv(l2g)
                    dt = (ts - t0) / 1e6
                    c_g = centre0 + vel * dt
                    c_l = (g2l @ np.concatenate(
                        [c_g, np.ones((boxes, 1))], 1).T).T[:, :3]
                    yaw_l = yaw_g - np.arctan2(l2g[1, 0], l2g[0, 0])
                    yaw_l = np.arctan2(np.sin(yaw_l), np.cos(yaw_l))
                    # [x, y, z, l, w, h, yaw]: the length along the heading
                    lb = np.concatenate([c_l, sizes[:, [1, 0, 2]],
                                         yaw_l[:, None]], 1)
                    bottom = lb.copy()
                    bottom[:, 2] -= sizes[:, 2] / 2
                    _plant(rng, pts, bottom,
                           _per_box(per_box, points, boxes))
                    keep = [b for b in range(boxes) if kinds[b] != "animal"]
                    lidar_boxes[stok] = lb[keep]
                    box_names[stok] = [kinds[b] for b in keep]
                pts.tofile(os.path.join(root, rel))
            n_pts = _per_box(per_box, points, boxes)
            for b in range(boxes):
                c_g = centre0[b] + vel[b] * (ts - t0) / 1e6
                t["sample_annotation"].append({
                    "token": anns[b], "sample_token": stok,
                    "instance_token": f"inst{sc}_{b}",
                    "translation": [float(v) for v in c_g],
                    "size": [float(v) for v in sizes[b]],
                    "rotation": _yaw_quat(yaw_g[b]),
                    "prev": f"ann{sc}_{b}_{j - 1}" if j else "",
                    "next": (f"ann{sc}_{b}_{j + 1}" if j + 1 < len(keys)
                             else ""),
                    "num_lidar_pts": n_pts,
                    "num_radar_pts": int(rng.integers(0, 3)),
                    "visibility_token": "4", "attribute_tokens": []})
    for name, rows in t.items():
        with open(os.path.join(vdir, f"{name}.json"), "w") as f:
            json.dump(rows, f)
    return {"root": root, "version": version, "scenes": scenes,
            "lidar_boxes": lidar_boxes, "names": box_names}

