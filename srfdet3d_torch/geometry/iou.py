"""Rotated BEV and 3D IoU and rotated multiclass NMS, static shapes.

The intersection of two rotated rectangles is a Green's-theorem boundary
integral: box A's edges clipped to box B plus B's edges clipped to A, each
clipped in closed form (Liang-Barsky), with a separating-axis gate for boxes
that merely touch.  NMS is the fixed point of "keep i iff no higher-scored
kept box overlaps i", which equals exact greedy NMS; it runs as the
`while_loop` operator (called directly, with its loop-invariant tensors
passed in: the public `torch._higher_order_ops.while_loop` compiles its
body with dynamo on every eager call), so `torch.export` traces it.
"""

from __future__ import annotations

import functools

import torch
from torch._higher_order_ops.while_loop import while_loop_op

from ..utils import profiling

_EPS = 1e-8


def _clipped_edge_circulation(hw_a, hl_a, hw_b, hl_b, tx, ty, cos_t, sin_t,
                              gx, gy, cos_a, sin_a, shrink):
    """Sum over box A's 4 edges of cross(p(t0), p(t1)), [t0, t1] the clip
    of the edge to |u| <= hw_b - shrink, |v| <= hl_b - shrink in B's frame
    (A's center (tx, ty), relative yaw (cos_t, sin_t) there); the integral
    is taken in a frame shared by both passes ((gx, gy), (cos_a, sin_a))."""
    lx = (hw_a, -hw_a, -hw_a, hw_a)
    ly = (hl_a, hl_a, -hl_a, -hl_a)
    px = [tx + lx[i] * cos_t - ly[i] * sin_t for i in range(4)]
    py = [ty + lx[i] * sin_t + ly[i] * cos_t for i in range(4)]
    wx = [gx + lx[i] * cos_a - ly[i] * sin_a for i in range(4)]
    wy = [gy + lx[i] * sin_a + ly[i] * cos_a for i in range(4)]
    bu, bv = hw_b - shrink, hl_b - shrink
    total = torch.zeros_like(tx)
    for i in range(4):
        x0, y0 = px[i], py[i]
        dx, dy = px[(i + 1) % 4] - x0, py[(i + 1) % 4] - y0
        t_lo = torch.zeros_like(x0)
        t_hi = torch.ones_like(x0)
        feasible = torch.ones_like(x0, dtype=torch.bool)
        for den, num in ((dx, bu - x0), (-dx, bu + x0),
                         (dy, bv - y0), (-dy, bv + y0)):
            par = den.abs() < _EPS
            r = num / torch.where(par, torch.ones_like(den), den)
            t_lo = torch.where(~par & (den < 0), torch.maximum(t_lo, r), t_lo)
            t_hi = torch.where(~par & (den > 0), torch.minimum(t_hi, r), t_hi)
            feasible = feasible & ((par & (num >= 0)) | ~par)
        valid = feasible & (t_hi > t_lo)
        cx0, cy0 = wx[i], wy[i]
        cdx, cdy = wx[(i + 1) % 4] - cx0, wy[(i + 1) % 4] - cy0
        ax0, ay0 = cx0 + t_lo * cdx, cy0 + t_lo * cdy
        ax1, ay1 = cx0 + t_hi * cdx, cy0 + t_hi * cdy
        total = total + torch.where(valid, ax0 * ay1 - ax1 * ay0,
                                    torch.zeros_like(ax0))
    return total


def rotated_intersection_pairs(b1: torch.Tensor, b2: torch.Tensor,
                               shrink: float = 1e-4) -> torch.Tensor:
    """Elementwise intersection area of broadcast (..., 5) [cx, cy, w, l,
    yaw] rectangles."""
    b1, b2 = torch.broadcast_tensors(b1, b2)
    cx1, cy1 = b1[..., 0], b1[..., 1]
    hw1, hl1, yaw1 = b1[..., 2] * 0.5, b1[..., 3] * 0.5, b1[..., 4]
    cx2, cy2 = b2[..., 0], b2[..., 1]
    hw2, hl2, yaw2 = b2[..., 2] * 0.5, b2[..., 3] * 0.5, b2[..., 4]
    c1, s1 = torch.cos(yaw1), torch.sin(yaw1)
    c2, s2 = torch.cos(yaw2), torch.sin(yaw2)
    dxw, dyw = cx1 - cx2, cy1 - cy2
    tx_ab = dxw * c2 + dyw * s2           # A in B's frame
    ty_ab = -dxw * s2 + dyw * c2
    cos_ab = c1 * c2 + s1 * s2
    sin_ab = s1 * c2 - c1 * s2
    tx_ba = -(dxw * c1 + dyw * s1)        # B in A's frame
    ty_ba = dxw * s1 - dyw * c1
    gx1, gy1 = 0.5 * dxw, 0.5 * dyw       # common frame: the midpoint
    circ = _clipped_edge_circulation(hw1, hl1, hw2, hl2, tx_ab, ty_ab,
                                     cos_ab, sin_ab, gx1, gy1, c1, s1, shrink)
    circ = circ + _clipped_edge_circulation(hw2, hl2, hw1, hl1, tx_ba, ty_ba,
                                            cos_ab, -sin_ab, -gx1, -gy1, c2,
                                            s2, -shrink)
    inter = (0.5 * circ).clamp_min(0.0)
    abs_c, abs_s = cos_ab.abs(), sin_ab.abs()
    pen_bx = hw2 + hw1 * abs_c + hl1 * abs_s - tx_ab.abs()
    pen_by = hl2 + hw1 * abs_s + hl1 * abs_c - ty_ab.abs()
    pen_ax = hw1 + hw2 * abs_c + hl2 * abs_s - tx_ba.abs()
    pen_ay = hl1 + hw2 * abs_s + hl2 * abs_c - ty_ba.abs()
    min_pen = torch.minimum(torch.minimum(pen_bx, pen_by),
                            torch.minimum(pen_ax, pen_ay))
    return torch.where(min_pen > shrink, inter, torch.zeros_like(inter))


def rotated_iou_bev(boxes1: torch.Tensor, boxes2: torch.Tensor
                    ) -> torch.Tensor:
    """Pairwise rotated IoU of BEV rects (..., N, 5) x (..., M, 5) ->
    (..., N, M)."""
    inter = rotated_intersection_pairs(boxes1[..., :, None, :],
                                       boxes2[..., None, :, :])
    a1 = (boxes1[..., 2] * boxes1[..., 3])[..., :, None]
    a2 = (boxes2[..., 2] * boxes2[..., 3])[..., None, :]
    return inter / (a1 + a2 - inter).clamp_min(_EPS)


def iou_3d(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise 3D IoU of LiDAR boxes with gravity-center z: (..., N, 7+)
    x (..., M, 7+) [cx, cy, cz, w, l, h, yaw, ...] raw sizes ->
    (..., N, M).  Both inputs use the same z convention."""
    bev1 = torch.cat([boxes1[..., 0:2], boxes1[..., 3:5], boxes1[..., 6:7]],
                     -1)
    bev2 = torch.cat([boxes2[..., 0:2], boxes2[..., 3:5], boxes2[..., 6:7]],
                     -1)
    inter_bev = rotated_intersection_pairs(bev1[..., :, None, :],
                                           bev2[..., None, :, :])
    z1, h1 = boxes1[..., 2], boxes1[..., 5]
    z2, h2 = boxes2[..., 2], boxes2[..., 5]
    zmin1, zmax1 = (z1 - h1 / 2)[..., :, None], (z1 + h1 / 2)[..., :, None]
    zmin2, zmax2 = (z2 - h2 / 2)[..., None, :], (z2 + h2 / 2)[..., None, :]
    overlap_z = (torch.minimum(zmax1, zmax2) -
                 torch.maximum(zmin1, zmin2)).clamp_min(0.0)
    inter = inter_bev * overlap_z
    vol1 = (boxes1[..., 3] * boxes1[..., 4] * boxes1[..., 5])[..., :, None]
    vol2 = (boxes2[..., 3] * boxes2[..., 4] * boxes2[..., 5])[..., None, :]
    return inter / (vol1 + vol2 - inter).clamp_min(_EPS)


# fixed-point sweeps of the last eager rotated_nms_bev call (a host-side
# count; a traced call leaves it as it was)
last_nms_sweeps = 0


def _nms_sweeping(keep, changed, it, sup, svalid, n: int):
    return changed & (it < n)


def _nms_sweep(keep, changed, it, sup, svalid, n: int):
    """One sweep: keep i iff i is valid and no kept j above it suppresses
    it; `changed` says whether the keep set moved."""
    new_keep = svalid & ~(sup & keep[..., None, :]).any(-1)
    return new_keep, (new_keep != keep).any(), it + 1


def rotated_nms_bev(boxes_bev: torch.Tensor, scores: torch.Tensor,
                    iou_thr: float, valid: torch.Tensor | None = None
                    ) -> torch.Tensor:
    """Greedy rotated NMS over the last axis: boxes (..., N, 5), scores
    (..., N) -> keep mask (..., N).  The fixed point is a `while_loop`
    over (keep, changed, sweeps) that stops when the keep set no longer
    changes, or after N sweeps, as the JAX package's `lax.while_loop`
    (`geometry/iou.py`): a traced program holds it as one loop node; in
    eager each sweep reads its predicate on the host."""
    global last_nms_sweeps
    if valid is None:
        valid = scores > -torch.inf
    key = torch.where(valid, scores, torch.full_like(scores, -torch.inf))
    order = torch.argsort(-key, dim=-1, stable=True)
    sboxes = torch.gather(boxes_bev, -2, order[..., None].expand_as(boxes_bev))
    svalid = torch.gather(valid, -1, order)
    n = boxes_bev.shape[-2]
    ious = rotated_iou_bev(sboxes, sboxes)
    lower = torch.ones(n, n, dtype=torch.bool, device=ious.device).tril(-1)
    # sup[i, j]: kept j would suppress i
    sup = (ious > iou_thr) & lower & svalid[..., None, :]
    start = (svalid, torch.ones((), dtype=torch.bool, device=sup.device),
             torch.zeros((), dtype=torch.int64, device=sup.device))
    keep, _, sweeps = while_loop_op(
        functools.partial(_nms_sweeping, n=n),
        functools.partial(_nms_sweep, n=n), start, (sup, svalid))
    if not (torch.compiler.is_exporting() or
            torch.compiler.is_compiling()):
        last_nms_sweeps = int(sweeps)
        # the loop's predicate, read after each sweep and twice before the
        # first (eager while_loop tests it, then loops on it), and the
        # count itself
        profiling.count("host_sync", last_nms_sweeps + 3)
    inv = torch.argsort(order, dim=-1)
    return torch.gather(keep, -1, inv)


def multiclass_nms_3d(boxes: torch.Tensor, boxes_bev: torch.Tensor,
                      scores: torch.Tensor, score_thr: float, max_num: int,
                      iou_thr: float):
    """Static-shape box3d_multiclass_nms, batched: boxes (B, N, D),
    boxes_bev (B, N, 5), scores (B, N, C) -> (boxes (B, max_num, D),
    scores (B, max_num), labels (B, max_num), valid (B, max_num)).
    Ties in score keep the lower index, as jax.lax.top_k does."""
    bsz, n, c = scores.shape
    cls_scores = scores.transpose(1, 2)                    # (B, C, N)
    top_s, top_i = torch.sort(cls_scores, dim=-1, descending=True,
                              stable=True)
    cls_valid = top_s > score_thr
    bev_sel = torch.gather(boxes_bev[:, None].expand(bsz, c, n, 5), 2,
                           top_i[..., None].expand(bsz, c, n, 5))
    keep = rotated_nms_bev(bev_sel, top_s, iou_thr, cls_valid)
    flat = torch.where(keep, top_s, torch.full_like(top_s, -torch.inf)
                       ).reshape(bsz, c * n)
    k_eff = min(max_num, c * n)
    fs, fi = torch.sort(flat, dim=-1, descending=True, stable=True)
    top_scores, flat_idx = fs[:, :k_eff], fi[:, :k_eff]
    if k_eff < max_num:
        pad = max_num - k_eff
        top_scores = torch.cat([top_scores, top_scores.new_full(
            (bsz, pad), -torch.inf)], 1)
        flat_idx = torch.cat([flat_idx, flat_idx.new_zeros(bsz, pad)], 1)
    labels = flat_idx // n
    box_idx = torch.gather(top_i.reshape(bsz, c * n), 1, flat_idx)
    out_boxes = torch.gather(boxes, 1,
                             box_idx[..., None].expand(-1, -1,
                                                       boxes.shape[-1]))
    out_valid = top_scores > -torch.inf
    out_scores = torch.where(out_valid, top_scores,
                             torch.zeros_like(top_scores))
    return out_boxes, out_scores, labels, out_valid
