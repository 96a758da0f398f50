"""Result formatters: nuScenes submission JSON, KITTI label lines (a copy
of the JAX package's `evals/formatters.py`).

Replaces mmdet3d's `dataset.format_results` (reference tools/test.py:240-252
reaches it for submission generation).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

# mmdet3d's velocity->attribute heuristic defaults
DEFAULT_ATTR = {
    "car": "vehicle.parked", "truck": "vehicle.parked",
    "bus": "vehicle.stopped", "trailer": "vehicle.parked",
    "construction_vehicle": "vehicle.parked",
    "pedestrian": "pedestrian.standing", "motorcycle": "cycle.without_rider",
    "bicycle": "cycle.without_rider", "traffic_cone": "", "barrier": "",
}
MOVING_ATTR = {
    "car": "vehicle.moving", "truck": "vehicle.moving",
    "bus": "vehicle.moving", "trailer": "vehicle.moving",
    "construction_vehicle": "vehicle.moving",
    "pedestrian": "pedestrian.moving", "motorcycle": "cycle.with_rider",
    "bicycle": "cycle.with_rider",
}


def _yaw_to_quaternion(yaw: float) -> List[float]:
    """z-axis rotation quaternion [w, x, y, z]."""
    return [float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))]


def format_nuscenes_results(frames: List[Dict], out_path: Optional[str]
                            = None, meta: Optional[Dict] = None) -> Dict:
    """frames: [{"sample_token", "boxes" (N, 9) gravity-center z,
    "scores", "labels_name"}].  Box layout [cx,cy,cz,w,l,h,yaw,vx,vy] in
    the GLOBAL frame (caller transforms from lidar frame using ego poses).

    Returns (and optionally writes) the submission dict.
    """
    results = {}
    for fr in frames:
        anns = []
        for i in range(len(fr["boxes"])):
            b = fr["boxes"][i]
            name = str(fr["labels_name"][i])
            speed = float(np.hypot(b[7], b[8])) if len(b) > 8 else 0.0
            attr = MOVING_ATTR.get(name, "") if speed > 0.2 else \
                DEFAULT_ATTR.get(name, "")
            anns.append({
                "sample_token": fr["sample_token"],
                "translation": [float(x) for x in b[:3]],
                "size": [float(b[3]), float(b[4]), float(b[5])],
                "rotation": _yaw_to_quaternion(float(b[6])),
                "velocity": [float(b[7]), float(b[8])] if len(b) > 8
                else [0.0, 0.0],
                "detection_name": name,
                "detection_score": float(fr["scores"][i]),
                "attribute_name": attr,
            })
        results[fr["sample_token"]] = anns
    sub = {"meta": meta or {"use_lidar": True, "use_camera": False,
                            "use_radar": False, "use_map": False,
                            "use_external": False},
           "results": results}
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(sub, f)
    return sub


def format_kitti_results(frames: List[Dict], out_dir: Optional[str] = None
                         ) -> List[str]:
    """frames: [{"frame_id", "boxes" (N, 7) lidar bottom-center,
    "scores", "labels_name", "lidar2cam" (4, 4), "P2" (4, 4)}].

    Emits standard KITTI label lines (camera-frame boxes h, w, l, x, y, z,
    ry + image bbox from projected corners + score).
    """
    from ..data.box_np import box_corners_bev

    all_lines = []
    for fr in frames:
        lines = []
        l2c = fr["lidar2cam"]
        p2 = fr["P2"]
        img_hw = fr.get("img_shape")           # optional (H, W) clip
        for i in range(len(fr["boxes"])):
            b = fr["boxes"][i]
            # lidar bottom-center -> camera frame
            ctr = l2c @ np.array([b[0], b[1], b[2], 1.0])
            # lidar yaw -> camera ry (camera y is down, x right, z forward)
            ry = -b[6] - np.pi / 2
            ry = float((ry + np.pi) % (2 * np.pi) - np.pi)
            # observation angle (KITTI devkit: alpha = ry - atan2(x, z))
            alpha = ry - np.arctan2(float(ctr[0]), float(ctr[2]))
            alpha = float((alpha + np.pi) % (2 * np.pi) - np.pi)
            h, w, l = float(b[5]), float(b[3]), float(b[4])
            # project 3D corners for the 2D bbox; corners BEHIND the image
            # plane are culled (a 1e-3 depth clamp would blow uv up ~1000x
            # into absurd label boxes) — a fully-behind box projects to a
            # degenerate zero-area bbox
            bev = box_corners_bev(b[None, :7])[0]              # (4, 2)
            zs = np.array([b[2], b[2] + b[5]])
            corners = np.array([[x, y, z, 1.0] for (x, y) in bev
                                for z in zs])
            cam = corners @ l2c.T
            uvw = (cam @ p2.T)
            front = uvw[:, 2] > 1e-3
            if front.any():
                uv = uvw[front, :2] / uvw[front, 2:3]
                x1, y1 = uv.min(axis=0)
                x2, y2 = uv.max(axis=0)
                if img_hw is not None:
                    x1 = float(np.clip(x1, 0, img_hw[1] - 1))
                    x2 = float(np.clip(x2, 0, img_hw[1] - 1))
                    y1 = float(np.clip(y1, 0, img_hw[0] - 1))
                    y2 = float(np.clip(y2, 0, img_hw[0] - 1))
            else:
                x1 = y1 = x2 = y2 = 0.0
            name = str(fr["labels_name"][i])
            lines.append(
                f"{name} 0.0 0 {alpha:.2f} "
                f"{x1:.2f} {y1:.2f} {x2:.2f} {y2:.2f} "
                f"{h:.2f} {w:.2f} {l:.2f} {ctr[0]:.2f} {ctr[1]:.2f} "
                f"{ctr[2]:.2f} {ry:.2f} {float(fr['scores'][i]):.4f}")
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            fid = fr["frame_id"]
            fname = f"{fid:06d}.txt" if isinstance(fid, (int, np.integer)) \
                else f"{fid}.txt"
            with open(os.path.join(out_dir, fname), "w") as f:
                f.write("\n".join(lines))
        all_lines.append(lines)
    return all_lines
