"""Create info pickles (and GT databases) from RAW dataset trees (the
port's copy of the JAX package's `tools/create_data.py`: the same
arguments, the same files, field for field).

The reference defers data preparation to mmdet3d's `create_data`
(README "Prepare the nuScenes/KITTI dataset as per mmdet3d"); this tool
removes that last mm-stack dependency: it produces the same
mmdet3d-1.0.0rc6-style `{dataset}_infos_{split}.pkl` /
`{dataset}_dbinfos_train.pkl` files this framework (and the reference)
consume, from the raw published trees.

Usage:
  # KITTI: root has training/{velodyne,label_2,calib,image_2}, ImageSets/
  python -m srfdet3d_torch.tools.create_data kitti --root data/kitti \
      [--with-db]

  # nuScenes: root has v1.0-trainval/{*.json}, samples/, sweeps/
  python -m srfdet3d_torch.tools.create_data nuscenes \
      --root data/nuscenes [--version v1.0-trainval] [--max-sweeps 10] \
      [--with-db]

Waymo is consumed through its public kitti-format conversion (the
reference does the same, CustomWaymoDataset num_views=5) — run this
tool's `kitti` mode over that tree with --dataset-name waymo.

Field conventions match mmdet3d exactly where this framework reads them:
KITTI `gt_boxes_lidar` = (x, y, z_bottom, l, w, h, yaw=-rot_y-pi/2
wrapped) in the lidar frame; nuScenes `gt_boxes` = (x, y, z_gravity,
l, w, h, yaw) in the lidar frame plus `gt_velocity` (vx, vy); db points
are box-relative.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle

import numpy as np

from ..data.box_np import points_in_boxes_3d
from ..data.transforms import load_points_bin


# --------------------------------------------------------------------- KITTI

def _parse_calib(path: str) -> dict:
    vals = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            k, v = line.split(":", 1)
            vals[k.strip()] = np.array([float(x) for x in v.split()],
                                       np.float32)
    calib = {}
    for k in ("P0", "P1", "P2", "P3"):
        if k in vals:
            m = np.eye(4, dtype=np.float32)
            m[:3, :4] = vals[k].reshape(3, 4)
            calib[k] = m
    r0 = np.eye(4, dtype=np.float32)
    r0[:3, :3] = vals["R0_rect"].reshape(3, 3)
    calib["R0_rect"] = r0
    tr = np.eye(4, dtype=np.float32)
    tr[:3, :4] = vals["Tr_velo_to_cam"].reshape(3, 4)
    calib["Tr_velo_to_cam"] = tr
    return calib


def _parse_label(path: str) -> dict:
    rows = []
    if os.path.exists(path):
        with open(path) as f:
            rows = [line.split() for line in f if line.strip()]
    ann = {
        "name": np.array([r[0] for r in rows]),
        "truncated": np.array([float(r[1]) for r in rows], np.float32),
        "occluded": np.array([int(float(r[2])) for r in rows], np.int32),
        "alpha": np.array([float(r[3]) for r in rows], np.float32),
        "bbox": np.array([[float(x) for x in r[4:8]] for r in rows],
                         np.float32).reshape(-1, 4),
        # label order h, w, l -> mmdet3d 'dimensions' (l, h, w)
        "dimensions": np.array([[float(r[10]), float(r[8]), float(r[9])]
                                for r in rows], np.float32).reshape(-1, 3),
        "location": np.array([[float(x) for x in r[11:14]] for r in rows],
                             np.float32).reshape(-1, 3),
        "rotation_y": np.array([float(r[14]) for r in rows], np.float32),
    }
    return ann


def _kitti_difficulty(ann: dict) -> np.ndarray:
    """mmdet3d add_difficulty_to_annos: easy/moderate/hard by 2D height,
    occlusion and truncation; -1 when even 'hard' is violated."""
    h = ann["bbox"][:, 3] - ann["bbox"][:, 1]
    occ, trunc = ann["occluded"], ann["truncated"]
    diff = np.full(len(h), -1, np.int32)
    for level, (min_h, max_occ, max_tr) in enumerate(
            [(40.0, 0, 0.15), (25.0, 1, 0.30), (25.0, 2, 0.50)]):
        ok = (h >= min_h) & (occ <= max_occ) & (trunc <= max_tr)
        diff = np.where((diff == -1) & ok, level, diff)
    return diff


def camera_to_lidar_boxes(loc, dims, rot_y, r0, tr):
    """KITTI camera-frame labels -> lidar gt_boxes_lidar
    (mmdet3d box_np_ops.box_camera_to_lidar): bottom-center xyz through
    inv(R0 @ Tr), dims (l, h, w) -> (l, w, h), yaw = -rot_y - pi/2
    wrapped to [-pi, pi)."""
    n = len(loc)
    if n == 0:
        return np.zeros((0, 7), np.float32)
    hom = np.concatenate([loc, np.ones((n, 1), np.float32)], axis=1)
    xyz = (hom @ np.linalg.inv(r0 @ tr).T)[:, :3]
    l, h, w = dims[:, 0:1], dims[:, 1:2], dims[:, 2:3]
    yaw = -rot_y.reshape(-1, 1) - np.pi / 2
    yaw = yaw - np.floor(yaw / (2 * np.pi) + 0.5) * 2 * np.pi
    return np.concatenate([xyz, l, w, h, yaw], axis=1).astype(np.float32)


def create_kitti_infos(root: str, out_dir: str, dataset_name: str = "kitti",
                       splits=("train", "val"), with_db: bool = False,
                       relative_paths: bool = True):
    os.makedirs(out_dir, exist_ok=True)
    written = {}
    for split in splits:
        ids_file = os.path.join(root, "ImageSets", f"{split}.txt")
        with open(ids_file) as f:
            ids = [line.strip() for line in f if line.strip()]
        infos = []
        for idx in ids:
            calib = _parse_calib(
                os.path.join(root, "training", "calib", f"{idx}.txt"))
            ann = _parse_label(
                os.path.join(root, "training", "label_2", f"{idx}.txt"))
            ann["difficulty"] = _kitti_difficulty(ann)
            keep = ann["name"] != "DontCare"
            ann = {k: v[keep] for k, v in ann.items()}
            ann["index"] = np.arange(len(ann["name"]), dtype=np.int32)
            ann["gt_boxes_lidar"] = camera_to_lidar_boxes(
                ann["location"], ann["dimensions"], ann["rotation_y"],
                calib["R0_rect"], calib["Tr_velo_to_cam"])
            velo = os.path.join("training", "velodyne", f"{idx}.bin")
            img = os.path.join("training", "image_2", f"{idx}.png")
            if not relative_paths:
                velo = os.path.join(root, velo)
                img = os.path.join(root, img)
            infos.append({
                "image": {"image_idx": int(idx), "image_path": img},
                "point_cloud": {"num_features": 4, "velodyne_path": velo},
                "calib": calib,
                "annos": ann,
            })
        out = os.path.join(out_dir, f"{dataset_name}_infos_{split}.pkl")
        with open(out, "wb") as f:
            pickle.dump(infos, f)
        print(f"{out}: {len(infos)} frames", flush=True)
        written[split] = infos

    if with_db and "train" in written:
        _create_gt_database(
            root, out_dir, dataset_name, written["train"],
            load_dim=4, box_key="kitti")
    return written


# ---------------------------------------------------------- GT database

def _create_gt_database(data_root: str, out_dir: str, dataset_name: str,
                        infos, load_dim: int, box_key: str):
    """Crop each GT's points into gt_database/ bins + dbinfos pickle
    (mmdet3d create_groundtruth_database; points stored box-relative)."""
    # bins live under DATA_ROOT (mmdet3d layout): DBSampler resolves db
    # paths against data_root, so an --out-dir elsewhere must not orphan
    # them into a directory the sampler never looks at
    db_dir = os.path.join(data_root, "gt_database")
    os.makedirs(db_dir, exist_ok=True)
    db: dict = {}
    for info in infos:
        if box_key == "kitti":
            frame = info["image"]["image_idx"]
            pts_path = info["point_cloud"]["velodyne_path"]
            boxes = info["annos"]["gt_boxes_lidar"]
            names = info["annos"]["name"]
            diffs = info["annos"]["difficulty"]
        else:
            frame = info["token"]
            pts_path = info["lidar_path"]
            boxes = np.asarray(info["gt_boxes"], np.float32).copy()
            if len(boxes):
                # nuScenes infos store gravity-center z; crop with the
                # bottom-center convention points_in_boxes_3d expects
                boxes[:, 2] -= 0.5 * boxes[:, 5]
            names = info["gt_names"]
            diffs = np.zeros(len(boxes), np.int32)
        if not os.path.isabs(pts_path):
            pts_path = os.path.join(data_root, pts_path)
        points = load_points_bin(pts_path, load_dim,
                                 tuple(range(load_dim)))
        if box_key == "nuscenes" and points.shape[1] > 4:
            # raw column 4 is the RING INDEX (0-31); the pipeline's 5th
            # channel is the sweep time-lag (0 for key frames) — pasted
            # db points must carry lag semantics, not ring values
            points = points.copy()
            points[:, 4] = 0.0
        if len(boxes) == 0:
            continue
        inside = points_in_boxes_3d(points[:, :3], boxes)
        for i, name in enumerate(names):
            obj = points[inside[:, i]].copy()
            obj[:, :3] -= boxes[i, :3]
            rel = os.path.join("gt_database", f"{frame}_{name}_{i}.bin")
            obj.astype(np.float32).tofile(os.path.join(data_root, rel))
            db.setdefault(str(name), []).append({
                "name": str(name), "path": rel,
                "image_idx": frame, "gt_idx": i,
                "box3d_lidar": np.asarray(boxes[i], np.float32),
                "num_points_in_gt": int(inside[:, i].sum()),
                "difficulty": int(diffs[i]),
            })
    out = os.path.join(out_dir, f"{dataset_name}_dbinfos_train.pkl")
    with open(out, "wb") as f:
        pickle.dump(db, f)
    print(f"{out}: " + ", ".join(f"{k}:{len(v)}" for k, v in db.items()),
          flush=True)


# ------------------------------------------------------------- nuScenes

def _quat_to_rot(q) -> np.ndarray:
    """nuScenes [w, x, y, z] quaternion -> 3x3 rotation matrix."""
    w, x, y, z = [float(v) for v in q]
    n = (w * w + x * x + y * y + z * z) ** 0.5
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float64)


def _pose_mat(rotation, translation) -> np.ndarray:
    m = np.eye(4)
    m[:3, :3] = _quat_to_rot(rotation)
    m[:3, 3] = np.asarray(translation, np.float64)
    return m


def _load_table(version_dir: str, name: str) -> dict:
    with open(os.path.join(version_dir, f"{name}.json")) as f:
        rows = json.load(f)
    return {r["token"]: r for r in rows}


NUS_CAM_NAMES = ("CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_FRONT_LEFT",
                 "CAM_BACK", "CAM_BACK_LEFT", "CAM_BACK_RIGHT")

# nuScenes detection-category mapping (devkit category_to_detection_name)
NUS_NAME_MAP = {
    "vehicle.car": "car", "vehicle.truck": "truck",
    "vehicle.construction": "construction_vehicle", "vehicle.bus.bendy":
    "bus", "vehicle.bus.rigid": "bus", "vehicle.trailer": "trailer",
    "movable_object.barrier": "barrier", "vehicle.motorcycle":
    "motorcycle", "vehicle.bicycle": "bicycle",
    "human.pedestrian.adult": "pedestrian", "human.pedestrian.child":
    "pedestrian", "human.pedestrian.construction_worker": "pedestrian",
    "human.pedestrian.police_officer": "pedestrian",
    "movable_object.trafficcone": "traffic_cone",
}


def create_nuscenes_infos(root: str, out_dir: str,
                          version: str = "v1.0-trainval",
                          max_sweeps: int = 10, with_db: bool = False,
                          val_scene_frac: float = 0.15,
                          val_scene_names=None):
    """Raw nuScenes JSON tables -> mmdet3d-style infos.

    Boxes transform global -> ego -> lidar; z converts to GRAVITY center
    (mmdet3d nuScenes infos convention, see datasets.py:302).  Velocity is
    the devkit's central difference of the annotation's global positions
    across its prev/next, rotated into the lidar frame (z dropped).
    Scene split: nuScenes publishes a fixed train/val scene list in the
    devkit; without it, the last `val_scene_frac` of scenes (by name
    order) become val — pass explicit lists via --val-scenes to override.
    """
    vdir = os.path.join(root, version)
    scene = _load_table(vdir, "scene")
    sample = _load_table(vdir, "sample")
    sample_data = _load_table(vdir, "sample_data")
    ego_pose = _load_table(vdir, "ego_pose")
    calib = _load_table(vdir, "calibrated_sensor")
    sensor = _load_table(vdir, "sensor")
    ann_t = _load_table(vdir, "sample_annotation")
    inst = _load_table(vdir, "instance")
    cat = _load_table(vdir, "category")

    # channel lookup for sample_data rows
    def channel(sd):
        return sensor[calib[sd["calibrated_sensor_token"]]
                      ["sensor_token"]]["channel"]

    # per-sample -> its sample_data rows (keyframes)
    by_sample: dict = {}
    for sd in sample_data.values():
        if sd["is_key_frame"]:
            by_sample.setdefault(sd["sample_token"], []).append(sd)

    def sd_for(stoken, chan):
        for sd in by_sample.get(stoken, []):
            if channel(sd) == chan:
                return sd
        raise KeyError(f"no keyframe sample_data for {chan}")

    def global_from_sd(sd):
        """(lidar/global transforms for a sample_data row)"""
        ego = _pose_mat(ego_pose[sd["ego_pose_token"]]["rotation"],
                        ego_pose[sd["ego_pose_token"]]["translation"])
        sens = _pose_mat(calib[sd["calibrated_sensor_token"]]["rotation"],
                         calib[sd["calibrated_sensor_token"]]["translation"])
        return ego @ sens                       # sensor -> global

    names = sorted(scene.values(), key=lambda s: s["name"])
    if val_scene_names is not None:
        # the official devkit split (nuscenes.utils.splits.val) — pass
        # its scene-name list for metrics comparable to published ones
        wanted = set(val_scene_names)
        val_scenes = {s["token"] for s in names if s["name"] in wanted}
        missing = wanted - {s["name"] for s in names}
        if missing:
            print(f"warning: {len(missing)} --val-scenes names not in "
                  f"{version}: {sorted(missing)[:5]}...", flush=True)
    else:
        n_val = max(int(len(names) * val_scene_frac), 1) \
            if len(names) > 1 else 0
        val_scenes = {s["token"] for s in names[len(names) - n_val:]}

    infos = {"train": [], "val": []}
    for sc in names:
        split = "val" if sc["token"] in val_scenes else "train"
        stoken = sc["first_sample_token"]
        while stoken:
            s = sample[stoken]
            lidar_sd = sd_for(stoken, "LIDAR_TOP")
            l2g = global_from_sd(lidar_sd)
            g2l = np.linalg.inv(l2g)

            cams = {}
            for cam_name in NUS_CAM_NAMES:
                try:
                    cam_sd = sd_for(stoken, cam_name)
                except KeyError:
                    continue
                c2g = global_from_sd(cam_sd)
                s2l = g2l @ c2g                 # cam sensor -> lidar
                cams[cam_name] = {
                    "data_path": cam_sd["filename"],
                    "sensor2lidar_rotation": s2l[:3, :3],
                    "sensor2lidar_translation": s2l[:3, 3],
                    "cam_intrinsic": np.asarray(
                        calib[cam_sd["calibrated_sensor_token"]]
                        ["camera_intrinsic"], np.float64),
                }

            # non-keyframe lidar sweeps walking prev from the keyframe
            sweeps = []
            sd_prev = sample_data.get(lidar_sd["prev"] or "")
            while sd_prev is not None and len(sweeps) < max_sweeps:
                p2g = global_from_sd(sd_prev)
                s2l = g2l @ p2g
                sweeps.append({
                    "data_path": sd_prev["filename"],
                    "sensor2lidar_rotation": s2l[:3, :3],
                    "sensor2lidar_translation": s2l[:3, 3],
                    "timestamp": sd_prev["timestamp"],
                })
                sd_prev = sample_data.get(sd_prev["prev"] or "")

            boxes, nm, vels, valid, npts = [], [], [], [], []
            for atok in s["anns"]:
                a = ann_t[atok]
                raw = cat[inst[a["instance_token"]]["category_token"]
                          ]["name"]
                name = NUS_NAME_MAP.get(raw)
                if name is None:
                    continue
                center_g = np.asarray(a["translation"], np.float64)
                size = np.asarray(a["size"], np.float64)     # w, l, h
                c_l = (g2l @ np.append(center_g, 1.0))[:3]
                # exact orientation composition into the lidar frame,
                # then yaw about +z (devkit yaw_pitch_roll[0] of the
                # lidar-frame box — mmdet3d 1.0.0rc converter semantics)
                r_l = g2l[:3, :3] @ _quat_to_rot(a["rotation"])
                yaw_l = float(np.arctan2(r_l[1, 0], r_l[0, 0]))
                # mmdet3d 1.0.0rc infos store dims as (l, w, h): devkit
                # wlh reordered [1, 0, 2] (x_size along heading)
                boxes.append(np.concatenate(
                    [c_l, [size[1], size[0], size[2]], [yaw_l]]))
                nm.append(name)
                # central-difference global velocity (devkit box_velocity)
                vel = np.zeros(2, np.float64)
                prev_a = ann_t.get(a["prev"] or "")
                next_a = ann_t.get(a["next"] or "")
                pa = prev_a if prev_a is not None else a
                na = next_a if next_a is not None else a
                if pa is not na:
                    p_pos = np.asarray(pa["translation"], np.float64)
                    n_pos = np.asarray(na["translation"], np.float64)
                    p_t = sample[pa["sample_token"]]["timestamp"]
                    n_t = sample[na["sample_token"]]["timestamp"]
                    dt = (n_t - p_t) / 1e6
                    if dt <= 0 or dt > 1.5:
                        # devkit box_velocity max_time_diff=1.5 s -> nan
                        # (the dataset nan_to_nums it to 0, like mmdet3d)
                        vel = np.full(2, np.nan)
                    else:
                        v_g = (n_pos - p_pos) / dt
                        vel = (g2l[:3, :3] @ v_g)[:2]
                vels.append(vel)
                npts.append(int(a["num_lidar_pts"]))
                valid.append(int(a["num_lidar_pts"]) +
                             int(a["num_radar_pts"]) > 0)

            infos[split].append({
                "token": stoken,
                "lidar_path": lidar_sd["filename"],
                "sweeps": sweeps,
                "cams": cams,
                "timestamp": s["timestamp"],
                "gt_boxes": np.asarray(boxes, np.float32).reshape(-1, 7),
                "gt_names": np.asarray(nm),
                "gt_velocity": np.asarray(vels, np.float32).reshape(-1, 2),
                "valid_flag": np.asarray(valid, bool),
                # the dataset's GT filter (reference use_valid_flag=False
                # semantics) reads this: num_lidar_pts > 0
                "num_lidar_pts": np.asarray(npts, np.int32),
            })
            stoken = s["next"]

    os.makedirs(out_dir, exist_ok=True)
    for split, lst in infos.items():
        out = os.path.join(out_dir, f"nuscenes_infos_{split}.pkl")
        with open(out, "wb") as f:
            pickle.dump(lst, f)
        print(f"{out}: {len(lst)} frames", flush=True)
    if with_db:
        _create_gt_database(root, out_dir, "nuscenes", infos["train"],
                            load_dim=5, box_key="nuscenes")
    return infos


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="dataset", required=True)
    k = sub.add_parser("kitti")
    k.add_argument("--root", required=True)
    k.add_argument("--out-dir", default=None)
    k.add_argument("--dataset-name", default="kitti",
                   help="'waymo' for a waymo kitti-format tree")
    k.add_argument("--with-db", action="store_true")
    n = sub.add_parser("nuscenes")
    n.add_argument("--root", required=True)
    n.add_argument("--out-dir", default=None)
    n.add_argument("--version", default="v1.0-trainval")
    n.add_argument("--max-sweeps", type=int, default=10)
    n.add_argument("--val-scene-frac", type=float, default=0.15)
    n.add_argument("--val-scenes", default=None,
                   help="comma-separated scene names OR a text file (one "
                        "name per line) fixing the val split — use the "
                        "devkit's official list for published-comparable "
                        "metrics")
    n.add_argument("--with-db", action="store_true")
    args = ap.parse_args(argv)

    out_dir = args.out_dir or args.root
    if args.dataset == "kitti":
        create_kitti_infos(args.root, out_dir,
                           dataset_name=args.dataset_name,
                           with_db=args.with_db)
    else:
        val_names = None
        if args.val_scenes:
            if os.path.exists(args.val_scenes):
                with open(args.val_scenes) as f:
                    val_names = [line.strip() for line in f
                                 if line.strip()]
            else:
                val_names = [s for s in args.val_scenes.split(",") if s]
        create_nuscenes_infos(args.root, out_dir, version=args.version,
                              max_sweeps=args.max_sweeps,
                              with_db=args.with_db,
                              val_scene_frac=args.val_scene_frac,
                              val_scene_names=val_names)


if __name__ == "__main__":
    main()
