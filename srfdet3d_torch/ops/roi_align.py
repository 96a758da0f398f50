"""Multi-level RoIAlign over flattened FPN levels, with its backward.

mmdet's SingleRoIExtractor + RoIAlign (output_size=7, sampling_ratio=2,
aligned): each RoI maps to one level,

    lvl = clamp(floor(log2(sqrt(w*h) / finest_scale + 1e-6)), 0, L-1),

and every output cell is the mean of sr x sr bilinear samples, computed
here by direct bilinear sampling of the level's (H*W, C) rows.  Samples
beyond one cell outside the map are zero; others clamp to the edge.

The patch and xpatch options reproduce the JAX package's capacity rules:
a RoI whose weighted cells do not fit a P x P window (patch), or a row of
XP cells (xpatch, which tests x alone), is a misfit; the misfits of each
image (each row of `rois`) take the first `patch_fallback` /
`xpatch_fallback` slots in RoI order (-1: all of them) and keep their
exact value, and the misfits after those slots pool to exact zeros.  The
values themselves are the pairs route's: the JAX package's window
gathers compute the same bilinear samples.  patch wins over xpatch.

The backward (`CornerPool`) gives the feature table its cotangent through
the roi_scatter kernel (K5, ops/roi_scatter.py) and the corner weights
theirs, which flow on to the RoIs: the sample positions, and so the boxes
they come from, carry gradient, as in the JAX package.

A bfloat16 table (the bfloat16 model) times the float32 weights promotes:
the pooled features are float32, as in the JAX package.  Its cotangent
takes the JAX package's route for a non-float32 cotangent
(`roi_align.py:116-140`): not K5 but the plain scatter, summed in float32
(index_add_ on a float32 table) and rounded to bfloat16 once.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from .roi_scatter import (expand_axes, roi_scatter, roi_scatter_plain,
                          sample_grads)


def _level_geometry(shapes, rois, strides, finest_scale):
    """Per-RoI level, scale, level extent (float) and row offset."""
    dev = rois.device
    num_levels = len(shapes)
    hs = torch.tensor([float(h) for h, _ in shapes], device=dev)
    ws = torch.tensor([float(w) for _, w in shapes], device=dev)
    scales = torch.tensor([1.0 / s for s in strides], dtype=torch.float32,
                          device=dev)
    sizes = [h * w for h, w in shapes]
    offsets = torch.tensor([sum(sizes[:i]) for i in range(num_levels)],
                           device=dev)
    x1, y1, x2, y2 = rois.unbind(-1)
    scale = torch.sqrt((x2 - x1).clamp_min(0) * (y2 - y1).clamp_min(0))
    lvl = torch.floor(torch.log2(scale / finest_scale + 1e-6))
    lvl = lvl.clamp(0, num_levels - 1).long()
    return lvl, scales[lvl], hs[lvl], ws[lvl], offsets[lvl]


def _sample_grid(rois, s, out_size, sampling_ratio):
    """Separable sample positions (sx, sy), each (R, out_size * sr), in the
    level's cell frame (aligned: half-pixel offset)."""
    x1, y1, x2, y2 = rois.unbind(-1)
    sr = sampling_ratio
    grid = (torch.arange(out_size, device=rois.device)[:, None] +
            (torch.arange(sr, device=rois.device)[None, :] + 0.5) / sr
            ).reshape(-1)
    bin_w = (x2 - x1) * s / out_size
    bin_h = (y2 - y1) * s / out_size
    sx = (x1 * s - 0.5)[:, None] + bin_w[:, None] * grid[None]
    sy = (y1 * s - 0.5)[:, None] + bin_h[:, None] * grid[None]
    return sx, sy


def _axis_corners(pos, size):
    """Bilinear corners along one axis: (c0, c1 int64, w0, w1, oob)."""
    size = size[:, None]
    oob = (pos < -1.0) | (pos > size)
    p = torch.minimum(pos.clamp_min(0.0), size - 1.0)
    c0 = torch.floor(p)
    lc = p - c0
    c1 = torch.minimum(c0 + 1, size - 1.0)
    edge = c0 >= size - 1.0
    w0 = torch.where(oob, 0.0, torch.where(edge, 1.0, 1.0 - lc))
    w1 = torch.where(oob, 0.0, torch.where(edge, 0.0, lc))
    return c0.long(), c1.long(), w0, w1, oob


def _axis_fits(pos, size, patch):
    """The JAX patch path's fit test along one axis: do the weighted cells
    of every sample lie in a `patch`-cell window anchored at the lowest?"""
    c0, c1, _, w1, oob = _axis_corners(pos, size)
    big = 1 << 30
    cmin = torch.where(oob, big, c0).amin(1)
    chi = torch.where(w1 > 0, c1, c0)
    cmax = torch.where(oob, -1, chi).amax(1)
    anchor = torch.minimum(cmin.clamp_min(0),
                           (size.long() - patch).clamp_min(0))
    return (cmax - anchor) <= patch - 1


def patch_fits(shapes, rois: torch.Tensor, strides: Sequence[int],
               patch: int, out_size: int = 7, sampling_ratio: int = 2,
               finest_scale: float = 56.0, x_only: bool = False
               ) -> torch.Tensor:
    """(R,) bool: does each RoI's weighted cell span fit a patch x patch
    window (x_only: a row of `patch` cells) at its level?  shapes: the
    levels' (H, W); rois (R, 4)."""
    _, s, h_l, w_l, _ = _level_geometry(shapes, rois, strides, finest_scale)
    sx, sy = _sample_grid(rois, s, out_size, sampling_ratio)
    fits = _axis_fits(sx, w_l, patch)
    return fits if x_only else fits & _axis_fits(sy, h_l, patch)


class Corners(NamedTuple):
    """The bilinear corners of every sample of every RoI: idx (R, 4, S, S)
    table rows, wgt (R, 4, S, S) weights (differentiable in the RoIs),
    drop (R,) bool; and the same per axis, as K5 takes them: cells (R, 4,
    S) int32 [y0, y1, x0, x1], cw (R, 4, S) their weights (detached),
    level (R, 2) int32 [table row of the level's cell (0, 0), level
    width].  idx, wgt = expand_axes(cells, cw, level)."""
    idx: torch.Tensor
    wgt: torch.Tensor
    drop: torch.Tensor
    cells: torch.Tensor
    cw: torch.Tensor
    level: torch.Tensor


class CornerPool(torch.autograd.Function):
    """Weighted corner gather + sr x sr mean + the capacity rule's drop.

    table (T, C); idx (R, 4, S, S) table rows of the 4 bilinear corners of
    every sample; wgt (R, 4, S, S) their weights; drop (R,) bool; cells,
    cw, level the same corners per axis (Corners) -> pooled (R, out, out,
    C), zero for dropped RoIs.  Backward: the table's cotangent is K5, from
    the per-axis corners; the weights' is sum_c table[idx] * g, plain
    torch."""

    @staticmethod
    def forward(ctx, table, idx, wgt, drop, cells, cw, level, out_size: int,
                sr: int):
        r, _, n_s, _ = idx.shape
        c = table.shape[1]
        acc = table.new_zeros(r, n_s, n_s, c, dtype=torch.promote_types(
            table.dtype, wgt.dtype))
        for q in range(4):
            acc += table[idx[:, q]] * wgt[:, q, ..., None]
        pooled = acc.reshape(r, out_size, sr, out_size, sr, c).mean((2, 4))
        pooled = torch.where(drop[:, None, None, None], 0.0, pooled)
        ctx.save_for_backward(table, idx, wgt, drop, cells, cw, level)
        ctx.sr = sr
        return pooled

    @staticmethod
    def backward(ctx, gp):
        table, idx, wgt, drop, cells, cw, level = ctx.saved_tensors
        gp = gp.contiguous()
        dtable = dwgt = None
        if ctx.needs_input_grad[0] and table.dtype == torch.float32:
            dtable = roi_scatter(gp, cells, cw, level, drop, table.shape[0],
                                 ctx.sr)
        elif ctx.needs_input_grad[0]:
            dtable = roi_scatter_plain(
                gp.float(), *expand_axes(cells, cw, level), drop,
                table.shape[0], ctx.sr).to(table.dtype)
        if ctx.needs_input_grad[2]:
            gs = sample_grads(gp, drop, ctx.sr)                # (R, S, S, C)
            dwgt = torch.stack([(table[idx[:, q]] * gs).sum(-1)
                                for q in range(4)], 1)
        return dtable, None, dwgt, None, None, None, None, None, None


def corner_samples(shapes, rois: torch.Tensor, strides: Sequence[int],
                   out_size: int = 7, sampling_ratio: int = 2,
                   finest_scale: float = 56.0, patch: int = 0,
                   patch_fallback: int = -1, xpatch: int = 0,
                   xpatch_fallback: int = -1) -> Corners:
    """The bilinear corners of every sample of every RoI.  shapes: the
    levels' (H, W); rois (B, R, 4).  Returns Corners over the B*R RoIs:
    idx (B*R, 4, S, S) rows of the (B * rows, C) table the levels flatten
    into, their weights wgt (same shape), drop (B*R,), the misfits past the
    fallback slots of their row b, and the per-axis corners."""
    b, r, _ = rois.shape
    rows = sum(h * w for h, w in shapes)
    flat = rois.reshape(b * r, 4)
    lvl, s, h_l, w_l, off = _level_geometry(shapes, flat, strides,
                                            finest_scale)
    sx, sy = _sample_grid(flat, s, out_size, sampling_ratio)
    x0, x1, wx0, wx1, _ = _axis_corners(sx, w_l)       # (BR, S)
    y0, y1, wy0, wy1, _ = _axis_corners(sy, h_l)
    base = off + torch.arange(b, device=rois.device).repeat_interleave(r) \
        * rows
    level = torch.stack([base, w_l.long()], 1).int()
    cells = torch.stack([y0, y1, x0, x1], 1).int()
    cw = torch.stack([wy0, wy1, wx0, wx1], 1)
    idx, wgt = expand_axes(cells, cw, level)
    drop = torch.zeros(b * r, dtype=torch.bool, device=rois.device)
    if patch or xpatch:
        fits = patch_fits(shapes, flat, strides, patch or xpatch, out_size,
                          sampling_ratio, finest_scale, x_only=not patch)
        fallback = patch_fallback if patch else xpatch_fallback
        cap = r if fallback < 0 else fallback
        mis = ~fits.reshape(b, r)
        slot = torch.cumsum(mis.long(), 1) - 1
        drop = (mis & (slot >= cap)).reshape(-1)
    return Corners(idx, wgt, drop, cells, cw.detach(), level)


def multilevel_roi_align(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                         strides: Sequence[int], out_size: int = 7,
                         sampling_ratio: int = 2, finest_scale: float = 56.0,
                         patch: int = 0, patch_fallback: int = -1,
                         xpatch: int = 0, xpatch_fallback: int = -1
                         ) -> torch.Tensor:
    """Batched RoIAlign.  feats: L maps (B, H_l, W_l, C); rois (B, R, 4)
    [x1, y1, x2, y2] in the stride-1 frame -> (B, R, out, out, C)."""
    b, r, _ = rois.shape
    c = feats[0].shape[-1]
    shapes = [(f.shape[1], f.shape[2]) for f in feats]
    table = torch.cat([f.reshape(b, -1, c) for f in feats], 1
                      ).reshape(-1, c)
    cs = corner_samples(shapes, rois, strides, out_size, sampling_ratio,
                        finest_scale, patch, patch_fallback, xpatch,
                        xpatch_fallback)
    pooled = CornerPool.apply(table, cs.idx, cs.wgt, cs.drop, cs.cells,
                              cs.cw, cs.level, out_size, sampling_ratio)
    return pooled.reshape(b, r, out_size, out_size, c)
