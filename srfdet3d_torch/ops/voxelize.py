"""Static-shape hard voxelization of padded point clouds.

Points stay point-major; the result gives each point its voxel slot and each
voxel slot its integer (z, y, x) coords and occupancy.  P points in, V_cap
voxel slots out per sample.  Points out of range, beyond the per-voxel cap
or in voxels beyond V_cap get the invalid slot V_cap.

Voxel order is the plan-major key ((y * nx + x) * nz + z), so the sparse
encoder's column invariant holds straight out of the voxelizer.  The sort is
stable, so the per-voxel point cap keeps the first points in input order,
and when more than V_cap voxels are occupied the V_cap smallest keys stay.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..config import VoxelizationSpec
from ..utils import profiling


@dataclasses.dataclass
class VoxelizedPoints:
    """Voxelization result (all tensors static shape, leading batch dims)."""
    point_voxel_idx: torch.Tensor   # (.., P) int64 in [0, V_cap]
    point_mask: torch.Tensor        # (.., P) bool
    voxel_coords: torch.Tensor      # (.., V_cap, 3) int64 (z, y, x); 0 if empty
    voxel_mask: torch.Tensor        # (.., V_cap) bool
    # (.., V_cap) int64 kept points a voxel (zeros without with_counts)
    num_points: Optional[torch.Tensor] = None


def compute_voxel_coords(points: torch.Tensor, spec: VoxelizationSpec):
    """points (P, >=3) -> ((P, 3) int64 zyx coords, (P,) bool in range)."""
    pc = torch.tensor(spec.point_cloud_range[:3], dtype=torch.float32,
                      device=points.device)
    vs = torch.tensor(spec.voxel_size, dtype=torch.float32,
                      device=points.device)
    # on a card each copy from host memory waits for the stream
    profiling.count("host_sync", 2)
    nx, ny, nz = spec.grid_size
    idx = torch.floor((points[:, :3].float() - pc) / vs).to(torch.int64)
    in_range = ((idx[:, 0] >= 0) & (idx[:, 0] < nx) &
                (idx[:, 1] >= 0) & (idx[:, 1] < ny) &
                (idx[:, 2] >= 0) & (idx[:, 2] < nz))
    return idx.flip(-1), in_range


def voxelize_points_batched(points: torch.Tensor, point_valid: torch.Tensor,
                            spec: VoxelizationSpec, with_counts: bool = True
                            ) -> VoxelizedPoints:
    """(B, P, C) padded points + (B, P) validity -> batched VoxelizedPoints.
    with_counts: each voxel's kept points in num_points (past the point
    cap, as the JAX package counts them); False leaves zeros there and
    skips the count (the model path, whose VFE counts its own).

    The batch folds into the sort key: sample b's keys shift by
    b * (cells + 1), so one global stable sort keeps the samples as
    contiguous blocks, each in plan-major key order.  Only the first point
    of each voxel (its head) writes the voxel's coords, so invalid points'
    coords are never read."""
    b, p = point_valid.shape
    dev = points.device
    v_cap = spec.max_voxels
    nx, ny, nz = spec.grid_size
    cells = nx * ny * nz
    shift = cells + 1

    coords, in_range = compute_voxel_coords(points.reshape(b * p, -1), spec)
    valid = point_valid.reshape(-1) & in_range
    key = (coords[:, 1] * nx + coords[:, 2]) * nz + coords[:, 0]
    sb = torch.arange(b, device=dev).repeat_interleave(p)
    key = torch.where(valid, key, cells) + sb * shift

    skey, order = torch.sort(key, stable=True)
    coords_sorted = coords[order]
    # sorted samples form contiguous blocks [b*P, (b+1)*P)
    svalid = (skey - sb * shift) != cells
    head = torch.ones_like(svalid)
    head[1:] = skey[1:] != skey[:-1]
    head &= svalid
    grank = torch.cumsum(head.to(torch.int64), 0) - 1
    starts = torch.arange(b, device=dev) * p
    base = torch.where(starts > 0, grank[(starts - 1).clamp_min(0)] + 1, 0)
    slot = grank - base[sb]
    slot = torch.where(svalid & (slot < v_cap), slot, v_cap)

    # hard point cap: sorted same-voxel points are contiguous, so point i is
    # among its voxel's first `cap` iff the point `cap` places back belongs
    # to another voxel (sample blocks have disjoint key ranges)
    cap = spec.max_num_points
    if 0 < cap < b * p:
        keep = torch.ones_like(svalid)
        keep[cap:] = skey[cap:] != skey[:-cap]
        slot = torch.where(keep & (slot < v_cap), slot, v_cap)

    trash = b * (v_cap + 1) - 1
    live = slot < v_cap
    gslot = torch.where(live, slot + sb * (v_cap + 1), trash)
    ghead = torch.where(head & live, gslot, trash)
    packed = torch.cat([coords_sorted, torch.ones_like(coords_sorted[:, :1])],
                       1)
    buf = torch.zeros(b * (v_cap + 1), 4, dtype=torch.int64, device=dev)
    buf[ghead] = packed
    buf = buf.reshape(b, v_cap + 1, 4)[:, :v_cap]

    num_points = torch.zeros(b * (v_cap + 1), dtype=torch.int64, device=dev)
    if with_counts:
        num_points.index_add_(0, gslot, torch.ones_like(gslot))
    num_points = num_points.reshape(b, v_cap + 1)[:, :v_cap]

    point_voxel_idx = torch.empty(b * p, dtype=torch.int64, device=dev)
    point_voxel_idx[order] = slot
    point_voxel_idx = point_voxel_idx.reshape(b, p)
    return VoxelizedPoints(
        point_voxel_idx=point_voxel_idx,
        point_mask=point_voxel_idx < v_cap,
        voxel_coords=buf[..., :3].contiguous(),
        voxel_mask=buf[..., 3] > 0,
        num_points=num_points.contiguous())
