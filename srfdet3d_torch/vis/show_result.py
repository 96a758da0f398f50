"""Result visualization: BEV raster, camera projection, mesh export.

Functional equivalents of the reference's core/visualizer/show_result.py
(1109 LoC): `show_bev_result*` (:443,634,827) -> :func:`show_bev_result`,
`show_multi_modality_result` (:242) -> :func:`show_multi_modality_result`,
obj/ply point+box writers (:16,38) -> :func:`write_obj` / :func:`write_ply`.

All functions take plain numpy boxes (N, 7+) [cx, cy, cz, w, l, h, yaw]
(bottom-center z) in LiDAR frame and render with cv2 — no trimesh/mayavi.
A copy of the JAX package's `vis/show_result.py`: the same pixels and the
same files.  cv2 is imported inside the functions that draw, so importing
the port needs none; the card machine has no cv2, and a call there raises
ImportError naming it.  The obj and ply writers need no cv2.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from ..data.box_np import box_corners_bev

GT_COLOR = (61, 102, 255)      # BGR orange-red
PRED_COLOR = (80, 200, 80)     # BGR green
# per-class BGR palette (cycled)
PALETTE = [(80, 200, 80), (200, 80, 80), (80, 80, 200), (200, 200, 80),
           (200, 80, 200), (80, 200, 200), (120, 160, 60), (60, 120, 160),
           (160, 60, 120), (128, 128, 128)]


def _corners_3d(boxes: np.ndarray) -> np.ndarray:
    """(N, 7) bottom-center -> (N, 8, 3); bottom 4 then top 4."""
    bev = box_corners_bev(boxes)                     # (N, 4, 2)
    z0 = boxes[:, 2:3]
    z1 = boxes[:, 2:3] + boxes[:, 5:6]
    bot = np.concatenate([bev, np.repeat(z0[:, :, None], 4, 1)[..., 0:1]],
                         axis=-1)
    top = np.concatenate([bev, np.repeat(z1[:, :, None], 4, 1)[..., 0:1]],
                         axis=-1)
    return np.concatenate([bot, top], axis=1)


def show_bev_result(points: Optional[np.ndarray],
                    gt_boxes: Optional[np.ndarray],
                    pred_boxes: Optional[np.ndarray],
                    out_path: str,
                    pc_range: Sequence[float] = (
                        -55.2, -55.2, -5.0, 55.2, 55.2, 3.0),
                    pixels_per_meter: float = 8.0,
                    pred_labels: Optional[np.ndarray] = None,
                    gt_labels: Optional[np.ndarray] = None) -> np.ndarray:
    """Render a BEV raster: points in gray, GT orange, predictions green
    (per-class colors when labels given).  Returns the BGR image."""
    import cv2

    w = int((pc_range[3] - pc_range[0]) * pixels_per_meter)
    h = int((pc_range[4] - pc_range[1]) * pixels_per_meter)
    img = np.zeros((h, w, 3), np.uint8)

    def to_px(xy):
        px = (xy[..., 0] - pc_range[0]) * pixels_per_meter
        py = (xy[..., 1] - pc_range[1]) * pixels_per_meter
        return np.stack([px, h - 1 - py], axis=-1).astype(np.int32)

    if points is not None and len(points):
        px = to_px(points[:, :2])
        ok = (px[:, 0] >= 0) & (px[:, 0] < w) & (px[:, 1] >= 0) & \
            (px[:, 1] < h)
        img[px[ok, 1], px[ok, 0]] = (90, 90, 90)

    def draw(boxes, color, labels=None):
        corners = to_px(box_corners_bev(boxes))
        for i, quad in enumerate(corners):
            c = PALETTE[int(labels[i]) % len(PALETTE)] \
                if labels is not None else color
            cv2.polylines(img, [quad.reshape(-1, 1, 2)], True, c, 2)
            # heading tick: center -> front edge midpoint
            ctr = to_px(boxes[i:i + 1, :2])[0]
            front = ((quad[0] + quad[3]) / 2).astype(np.int32)
            cv2.line(img, tuple(ctr), tuple(front), c, 2)

    if gt_boxes is not None and len(gt_boxes):
        draw(gt_boxes, GT_COLOR, gt_labels)
    if pred_boxes is not None and len(pred_boxes):
        draw(pred_boxes, PRED_COLOR, pred_labels)

    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    cv2.imwrite(out_path, img)
    return img


def _draw_projected(img, boxes, lidar2img, color, labels=None,
                    thickness=2) -> None:
    import cv2
    if boxes is None or len(boxes) == 0:
        return
    corners = _corners_3d(boxes)                    # (N, 8, 3)
    hom = np.concatenate([corners, np.ones_like(corners[..., :1])], -1)
    cam = hom @ lidar2img.T                         # (N, 8, 4)
    z = cam[..., 2]
    uv = cam[..., :2] / np.maximum(z[..., None], 1e-5)
    edges = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7),
             (7, 4), (0, 4), (1, 5), (2, 6), (3, 7)]
    h, w = img.shape[:2]
    for n in range(len(boxes)):
        if (z[n] <= 0.1).any():
            continue
        pts = uv[n].astype(np.int32)
        if (pts[:, 0] < -2 * w).any() or (pts[:, 0] > 3 * w).any():
            continue
        c = PALETTE[int(labels[n]) % len(PALETTE)] if labels is not None \
            else color
        for a, b in edges:
            cv2.line(img, tuple(pts[a]), tuple(pts[b]), c, thickness)


def show_multi_modality_result(img: np.ndarray,
                               boxes: np.ndarray,
                               lidar2img: np.ndarray,
                               out_path: str,
                               color=(80, 200, 80),
                               gt_boxes: Optional[np.ndarray] = None,
                               labels: Optional[np.ndarray] = None
                               ) -> np.ndarray:
    """Project 3D boxes onto a camera image and draw the 12 edges
    (reference show_result.py:242-441).  GT boxes (when given) draw in the
    fixed GT color; predictions take per-class palette colors when
    `labels` is given, else `color`."""
    import cv2

    img = np.ascontiguousarray(img.astype(np.uint8))
    _draw_projected(img, gt_boxes, lidar2img, GT_COLOR)
    _draw_projected(img, boxes, lidar2img, color, labels)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    cv2.imwrite(out_path, img)
    return img


def show_result(points: Optional[np.ndarray],
                gt_boxes: Optional[np.ndarray],
                pred_boxes: Optional[np.ndarray],
                out_dir: str,
                filename: str) -> None:
    """Headless equivalent of the reference's trimesh 3D viewer
    (show_result.py:80-240): writes the scene as mesh files any 3D viewer
    opens — `{filename}_points.obj`, `{filename}_gt.ply`,
    `{filename}_pred.ply`."""
    os.makedirs(out_dir, exist_ok=True)
    if points is not None and len(points):
        write_obj(points, os.path.join(out_dir, f"{filename}_points.obj"))
    if gt_boxes is not None and len(gt_boxes):
        write_ply(gt_boxes, os.path.join(out_dir, f"{filename}_gt.ply"))
    if pred_boxes is not None and len(pred_boxes):
        write_ply(pred_boxes, os.path.join(out_dir, f"{filename}_pred.ply"))


def write_obj(points: np.ndarray, out_path: str) -> None:
    """Wavefront .obj point dump (reference show_result.py:16-36)."""
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        for p in points:
            rgb = (int(p[3]), int(p[4]), int(p[5])) if p.shape[0] >= 6 \
                else (128, 128, 128)
            f.write(f"v {p[0]} {p[1]} {p[2]} {rgb[0]} {rgb[1]} {rgb[2]}\n")


def write_ply(boxes: np.ndarray, out_path: str) -> None:
    """Boxes as a wireframe .ply (reference show_result.py:38-78)."""
    corners = _corners_3d(boxes)
    edges = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7),
             (7, 4), (0, 4), (1, 5), (2, 6), (3, 7)]
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    n = len(boxes)
    with open(out_path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n * 8}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element edge {n * 12}\n")
        f.write("property int vertex1\nproperty int vertex2\n")
        f.write("end_header\n")
        for c in corners.reshape(-1, 3):
            f.write(f"{c[0]} {c[1]} {c[2]}\n")
        for i in range(n):
            for a, b in edges:
                f.write(f"{i * 8 + a} {i * 8 + b}\n")
