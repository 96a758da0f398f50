"""Numpy box geometry helpers for the host-side data pipeline (a copy of
the JAX package's `data/box_np.py`, which the port may not import)."""

from __future__ import annotations

import numpy as np


def points_in_boxes_bev(points: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """Rotated-BEV membership: points (N, >=2), boxes (M, >=7 bottom-z)
    -> bool (N, M)."""
    if len(boxes) == 0:
        return np.zeros((len(points), 0), bool)
    d = points[:, None, :2] - boxes[None, :, :2]
    c, s = np.cos(boxes[:, 6]), np.sin(boxes[:, 6])
    u = d[..., 0] * c + d[..., 1] * s
    v = -d[..., 0] * s + d[..., 1] * c
    return (np.abs(u) <= boxes[:, 3] / 2) & (np.abs(v) <= boxes[:, 4] / 2)


def points_in_boxes_3d(points: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """3D membership (rotated BEV x z slab): points (N, >=3),
    boxes (M, >=7) with BOTTOM-center z -> bool (N, M).  Matches mmdet3d
    points_in_rbbox (ObjectSample removes only points inside the 3D box,
    not the whole vertical column)."""
    bev = points_in_boxes_bev(points, boxes)
    if bev.shape[1] == 0:
        return bev
    z0 = boxes[:, 2]
    z1 = z0 + boxes[:, 5]
    in_z = (points[:, 2:3] >= z0[None]) & (points[:, 2:3] <= z1[None])
    return bev & in_z


def box_corners_bev(boxes: np.ndarray) -> np.ndarray:
    """(M, >=7) -> (M, 4, 2) BEV corners."""
    hw, hl = boxes[:, 3] / 2, boxes[:, 4] / 2
    lx = np.stack([hw, -hw, -hw, hw], axis=-1)
    ly = np.stack([hl, hl, -hl, -hl], axis=-1)
    c, s = np.cos(boxes[:, 6])[:, None], np.sin(boxes[:, 6])[:, None]
    x = lx * c - ly * s + boxes[:, 0:1]
    y = lx * s + ly * c + boxes[:, 1:2]
    return np.stack([x, y], axis=-1)


def bev_overlap_exact(box: np.ndarray, others: np.ndarray) -> np.ndarray:
    """Exact rotated-BEV rectangle overlap (separating-axis test) of one
    box (>=7,) against (M, >=7) others -> (M,) bool; touching counts as
    overlap.  Mirrors mmdet3d's box_collision_test role for ObjectNoise /
    ObjectSample (the circumscribed-circle test over-rejects: two parked
    cars 2 m apart 'collide' at radius-sum ~3.4 m)."""
    if len(others) == 0:
        return np.zeros(0, bool)
    c1 = box_corners_bev(box[None, :7])[0]          # (4, 2)
    c2 = box_corners_bev(others[:, :7])             # (M, 4, 2)
    m = len(others)
    # candidate axes = edge directions of both rects (normals unneeded:
    # a rectangle's edges ARE the other pair's normals)
    ax1 = np.stack([c1[1] - c1[0], c1[2] - c1[1]])  # (2, 2)
    ax2 = np.stack([c2[:, 1] - c2[:, 0], c2[:, 2] - c2[:, 1]], axis=1)
    axes = np.concatenate(
        [np.broadcast_to(ax1[None], (m, 2, 2)), ax2], axis=1)  # (M, 4, 2)
    p1 = np.einsum("maj,kj->mak", axes, c1)         # (M, 4, 4)
    p2 = np.einsum("maj,mkj->mak", axes, c2)
    sep = ((p1.max(-1) < p2.min(-1)) |
           (p2.max(-1) < p1.min(-1))).any(-1)       # (M,)
    return ~sep
