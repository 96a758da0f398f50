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
rows, w (R, 4, S, S) corner weights, S = out * sr.  The plain version is
`Tensor.index_add_` of the weighted corner contributions.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

# kernel launches since the last reset (chip_smoke.py reads it)
launches = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
# gp, idx, w, drop, dtable, R, C, out, sr, stream
_SIGNATURES = {"roi_scatter_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]}


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


def roi_scatter(gp: torch.Tensor, idx: torch.Tensor, w: torch.Tensor,
                drop: torch.Tensor, rows: int, sr: int) -> torch.Tensor:
    """The table cotangent: the CUDA kernel for tensors on the card, the
    plain version for tensors on the CPU."""
    if gp.device.type == "cpu":
        return roi_scatter_plain(gp, idx, w, drop, rows, sr)
    if gp.device.type != "cuda":
        raise RuntimeError(f"roi_scatter: no kernel for {gp.device}")
    global launches
    r, out, _, c = gp.shape
    s = out * sr
    dev = gp.device
    if gp.dtype != torch.float32 or w.dtype != torch.float32:
        raise ValueError("roi_scatter: the kernel takes float32 gp and w")
    if tuple(idx.shape) != (r, 4, s, s) or tuple(w.shape) != (r, 4, s, s) \
            or tuple(drop.shape) != (r,):
        raise ValueError(f"roi_scatter: shapes gp {tuple(gp.shape)}, idx "
                         f"{tuple(idx.shape)}, w {tuple(w.shape)}, drop "
                         f"{tuple(drop.shape)}")
    if 4 * s * s * 8 > 48 * 1024:
        raise ValueError(f"roi_scatter: {s} x {s} samples do not fit the "
                         f"block's shared memory")
    if rows >= 2 ** 31:
        raise ValueError("roi_scatter: table rows must fit int32")
    for name, t in (("gp", gp), ("idx", idx), ("w", w), ("drop", drop)):
        if t.device != dev:
            raise ValueError(f"roi_scatter: {name} is not on {dev}")
    gp = gp.contiguous()
    idx32 = idx.to(torch.int32).contiguous()
    w = w.contiguous()
    drop8 = drop.to(torch.uint8).contiguous()
    dt = torch.zeros(rows, c, dtype=torch.float32, device=dev)
    lib = cuda_build.load_library("roi_scatter", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.roi_scatter_f32(gp.data_ptr(), idx32.data_ptr(),
                                 w.data_ptr(), drop8.data_ptr(),
                                 dt.data_ptr(), r, c, out, sr, stream)
    cuda_build.check(lib, rc, "roi_scatter")
    launches += 1
    return dt
