"""Multi-level RoIAlign over flattened FPN levels, forward only.

mmdet's SingleRoIExtractor + RoIAlign (output_size=7, sampling_ratio=2,
aligned): each RoI maps to one level,

    lvl = clamp(floor(log2(sqrt(w*h) / finest_scale + 1e-6)), 0, L-1),

and every output cell is the mean of sr x sr bilinear samples, computed
here by direct bilinear sampling of the level's (H*W, C) rows.  Samples
beyond one cell outside the map are zero; others clamp to the edge.

The patch option reproduces the JAX package's capacity rule: a RoI whose
weighted cells do not fit a P x P window is a misfit; misfits take the
first `patch_fallback` slots in RoI order (-1: all of them) and keep their
exact value, and the misfits after those slots pool to zeros.
"""

from __future__ import annotations

from typing import Sequence

import torch


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
               finest_scale: float = 56.0) -> torch.Tensor:
    """(R,) bool: does each RoI's weighted cell span fit a patch x patch
    window at its level?  shapes: the levels' (H, W); rois (R, 4)."""
    _, s, h_l, w_l, _ = _level_geometry(shapes, rois, strides, finest_scale)
    sx, sy = _sample_grid(rois, s, out_size, sampling_ratio)
    return _axis_fits(sx, w_l, patch) & _axis_fits(sy, h_l, patch)


def multilevel_roi_align(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                         strides: Sequence[int], out_size: int = 7,
                         sampling_ratio: int = 2, finest_scale: float = 56.0,
                         patch: int = 0, patch_fallback: int = -1
                         ) -> torch.Tensor:
    """Batched RoIAlign.  feats: L maps (B, H_l, W_l, C); rois (B, R, 4)
    [x1, y1, x2, y2] in the stride-1 frame -> (B, R, out, out, C)."""
    b, r, _ = rois.shape
    c = feats[0].shape[-1]
    shapes = [(f.shape[1], f.shape[2]) for f in feats]
    rows = sum(h * w for h, w in shapes)
    table = torch.cat([f.reshape(b, -1, c) for f in feats], 1
                      ).reshape(b * rows, c)
    flat = rois.reshape(b * r, 4)
    lvl, s, h_l, w_l, off = _level_geometry(shapes, flat, strides,
                                            finest_scale)
    sx, sy = _sample_grid(flat, s, out_size, sampling_ratio)
    x0, x1, wx0, wx1, _ = _axis_corners(sx, w_l)       # (BR, S)
    y0, y1, wy0, wy1, _ = _axis_corners(sy, h_l)
    base = (off + torch.arange(b, device=rois.device).repeat_interleave(r)
            * rows)[:, None, None]
    wl = w_l.long()[:, None, None]
    n_s = sx.shape[1]
    acc = table.new_zeros(b * r, n_s, n_s, c)
    for yy, wy in ((y0, wy0), (y1, wy1)):
        for xx, wx in ((x0, wx0), (x1, wx1)):
            idx = base + yy[:, :, None] * wl + xx[:, None, :]
            wgt = wy[:, :, None] * wx[:, None, :]
            acc += table[idx] * wgt[..., None]
    sr = sampling_ratio
    pooled = acc.reshape(b * r, out_size, sr, out_size, sr, c).mean((2, 4))
    if patch:
        fits = patch_fits(shapes, flat, strides, patch, out_size,
                          sampling_ratio, finest_scale)
        cap = r if patch_fallback < 0 else patch_fallback
        mis = ~fits.reshape(b, r)
        slot = torch.cumsum(mis.long(), 1) - 1
        drop = (mis & (slot >= cap)).reshape(-1)
        pooled = torch.where(drop[:, None, None, None], 0.0, pooled)
    return pooled.reshape(b, r, out_size, out_size, c)
