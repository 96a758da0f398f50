"""3D box codecs and corner math (batched tensor code).

Box code: raw [cx, cy, cz, w, l, h, yaw (, vx, vy)]; normalized
[cx, cy, cz, log w, log l, log h, sin, cos (, vx, vy)].
"""

from __future__ import annotations

import torch


def normalize_bbox(bboxes: torch.Tensor) -> torch.Tensor:
    """Raw [cx, cy, cz, w, l, h, yaw (, vx, vy)] -> normalized box code
    (reference util.py:4-38; the center passes through)."""
    rot = bboxes[..., 6:7]
    parts = [bboxes[..., 0:3], torch.log(bboxes[..., 3:6]), torch.sin(rot),
             torch.cos(rot)]
    if bboxes.shape[-1] > 7:
        parts.append(bboxes[..., 7:9])
    return torch.cat(parts, -1)


def denormalize_bbox(normalized: torch.Tensor) -> torch.Tensor:
    """Normalized box code -> raw [cx, cy, cz, w, l, h, yaw (, vx, vy)]."""
    rot = torch.atan2(normalized[..., 6:7], normalized[..., 7:8])
    parts = [normalized[..., 0:3], torch.exp(normalized[..., 3:6]), rot]
    if normalized.shape[-1] > 8:
        parts.append(normalized[..., 8:10])
    return torch.cat(parts, -1)


def boxes3d_to_corners3d(boxes3d: torch.Tensor, bottom_center: bool = True,
                         yaw_as_sincos: bool = False,
                         log_size: bool = True) -> torch.Tensor:
    """(..., 7) or, with yaw_as_sincos, (..., 8) boxes -> (..., 8, 3)
    corners (reference util.py:84-176; sizes exponentiated when
    log_size)."""
    cx, cy, cz = boxes3d[..., 0], boxes3d[..., 1], boxes3d[..., 2]
    w, l, h = boxes3d[..., 3], boxes3d[..., 4], boxes3d[..., 5]
    if yaw_as_sincos:
        ry = torch.atan2(boxes3d[..., 6], boxes3d[..., 7])
    else:
        ry = boxes3d[..., 6]
    if log_size:
        w, l, h = torch.exp(w), torch.exp(l), torch.exp(h)
    hw, hl, hh = w / 2.0, l / 2.0, h / 2.0
    sx = torch.stack([hw, -hw, -hw, hw, hw, -hw, -hw, hw], -1)
    sy = torch.stack([-hl, -hl, hl, hl, -hl, -hl, hl, hl], -1)
    if bottom_center:
        zero = torch.zeros_like(h)
        sz = torch.stack([zero, zero, zero, zero, h, h, h, h], -1)
    else:
        sz = torch.stack([-hh, -hh, -hh, -hh, hh, hh, hh, hh], -1)
    # the reference's row-vector rotation: x' = x cos + y sin,
    # y' = -x sin + y cos
    cos_r, sin_r = torch.cos(ry)[..., None], torch.sin(ry)[..., None]
    rx = sx * cos_r + sy * sin_r
    ry_ = -sx * sin_r + sy * cos_r
    return torch.stack([rx + cx[..., None], ry_ + cy[..., None],
                        sz + cz[..., None]], -1)
