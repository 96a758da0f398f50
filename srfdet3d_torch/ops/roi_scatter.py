"""RoIAlign backward into the feature table: the roi_scatter kernel (K5)
and its plain version.

Replaces the JAX package's Pallas kernel
`ops/pallas_patch_scatter.py::roi_window_scatter_add` (kernel body
`_kernel`), the patch RoIAlign's table cotangent.  The port's RoIAlign
samples the four bilinear corners of every sample directly
(ops/roi_align.py), so the same cotangent is

    dtable[idx[r, q]] += w[r, q] * gp[r, cell(q)] / sr^2

over the RoIs r the capacity rule kept (not `drop[r]`) and their corner
samples q: gp (R, out, out, C) pooled cotangent, idx (R, 4, S, S) table
rows, w (R, 4, S, S) corner weights, S = out * sr.  The sample grid is
separable, and the kernel takes it per axis: cells (R, 4, S) int32 the
corners [y0, y1, x0, x1] of each sample row and column, cw (R, 4, S) their
weights, level (R, 2) int32 [base, width], the table row of the RoI's
level cell (0, 0) and the level's width; `expand_axes` gives idx and w
(corner q = 2 * (y corner) + (x corner)).  The plain version is
`Tensor.index_add_` of the weighted corner contributions.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

# kernel launches since the last reset (chip_smoke.py reads it)
launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
# gp, cells, cw, level, drop, dtable, R, C, out, sr, stream
_SIGNATURES = {"roi_scatter_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                   _P]}
# the kernel's block: 32 channels, 8 warps; one thread a corner candidate,
# 2 S on each axis
_THREADS = 256


def expand_axes(cells: torch.Tensor, cw: torch.Tensor, level: torch.Tensor):
    """Per-axis corners -> (idx (R, 4, S, S) int64 table rows, w (R, 4, S,
    S) weights), corner q = 2 * (y corner) + (x corner): the outer product
    of the sample rows' and columns' corners."""
    base = level[:, 0].long()[:, None, None]
    width = level[:, 1].long()[:, None, None]
    cl = cells.long()
    idx, w = [], []
    for qy in (0, 1):
        for qx in (2, 3):
            idx.append(base + cl[:, qy, :, None] * width + cl[:, qx, None, :])
            w.append(cw[:, qy, :, None] * cw[:, qx, None, :])
    return torch.stack(idx, 1), torch.stack(w, 1)


def sample_grads(gp: torch.Tensor, drop: torch.Tensor,
                 sr: int) -> torch.Tensor:
    """(R, out, out, C) pooled cotangent -> (R, S, S, C) per-sample
    cotangent of the sr x sr mean, zero for dropped RoIs."""
    gs = gp.repeat_interleave(sr, 1).repeat_interleave(sr, 2) / (sr * sr)
    return torch.where(drop[:, None, None, None], 0.0, gs)


def roi_scatter_plain(gp: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                      drop: torch.Tensor, rows: int, sr: int) -> torch.Tensor:
    """Plain version: (rows, C) table cotangent by index_add_."""
    c = gp.shape[-1]
    gs = sample_grads(gp, drop, sr)                         # (R, S, S, C)
    contrib = w[..., None] * gs[:, None]                    # (R, 4, S, S, C)
    dt = gp.new_zeros(rows, c)
    dt.index_add_(0, idx.reshape(-1).long(), contrib.reshape(-1, c))
    return dt


def roi_scatter(gp: torch.Tensor, cells: torch.Tensor, cw: torch.Tensor,
                level: torch.Tensor, drop: torch.Tensor, rows: int,
                sr: int) -> torch.Tensor:
    """The table cotangent from the per-axis corners: the CUDA kernel for
    tensors on the card, the plain version (expand_axes, then
    roi_scatter_plain) for tensors on the CPU."""
    if gp.device.type == "cpu":
        return roi_scatter_plain(gp, *expand_axes(cells, cw, level), drop,
                                 rows, sr)
    if gp.device.type != "cuda":
        raise RuntimeError(f"roi_scatter: no kernel for {gp.device}")
    global launches
    r, out, _, c = gp.shape
    s = out * sr
    dev = gp.device
    if gp.dtype != torch.float32 or cw.dtype != torch.float32:
        raise ValueError("roi_scatter: the kernel takes float32 gp and cw")
    if tuple(cells.shape) != (r, 4, s) or tuple(cw.shape) != (r, 4, s) \
            or tuple(level.shape) != (r, 2) or tuple(drop.shape) != (r,):
        raise ValueError(f"roi_scatter: shapes gp {tuple(gp.shape)}, cells "
                         f"{tuple(cells.shape)}, cw {tuple(cw.shape)}, level "
                         f"{tuple(level.shape)}, drop {tuple(drop.shape)}")
    if 4 * s > _THREADS:
        raise ValueError(f"roi_scatter: the kernel takes at most "
                         f"{_THREADS // 4} samples an axis, got {s}")
    if rows >= 2 ** 31:
        raise ValueError("roi_scatter: table rows must fit int32")
    for name, t in (("gp", gp), ("cells", cells), ("cw", cw),
                    ("level", level), ("drop", drop)):
        if t.device != dev:
            raise ValueError(f"roi_scatter: {name} is not on {dev}")
    gp = gp.contiguous()
    cells32 = cells.to(torch.int32).contiguous()
    cw = cw.contiguous()
    level32 = level.to(torch.int32).contiguous()
    drop8 = drop.to(torch.uint8).contiguous()
    dt = torch.zeros(rows, c, dtype=torch.float32, device=dev)
    lib = cuda_build.load_library("roi_scatter", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.roi_scatter_f32(gp.data_ptr(), cells32.data_ptr(),
                                 cw.data_ptr(), level32.data_ptr(),
                                 drop8.data_ptr(), dt.data_ptr(), r, c, out,
                                 sr, stream)
    cuda_build.check(lib, rc, "roi_scatter")
    launches += 1
    return dt
