"""Voxel feature encoders as point-major segment reductions.

- HardSimpleVFE (the flagship's, cfg srfdet_voxel_nusc_L.py:70): the mean
  of each voxel's capped points.
- DynamicVFE (the KITTI family's, reference voxel_encoder.py:11-240):
  cluster-centre offsets (optionally embedded by a Linear-BN-tanh MLP),
  voxel-centre offsets and distance decorate each point; stacked
  Linear + masked BN + ReLU layers with a scatter-max per voxel and a
  gather-back concat between layers.

Points and voxels are flat over the batch; invalid points carry the slot id
`v_cap` and are dropped by the segment reductions.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..config import VoxelizationSpec
from ..ops.scatter import segment_max, segment_mean
from ..ops.voxelize import VoxelizedPoints
from .layers import MaskedBatchNorm

# width of the centroid-aware MLP (the JAX module's centroid_pos_emb_dims,
# which no shipped config changes)
_CENTROID_EMB = 32


def _gather_voxel_to_point(voxel_feats: torch.Tensor,
                           point_voxel_idx: torch.Tensor) -> torch.Tensor:
    """Per-voxel rows back to points; the invalid slot reads zeros."""
    pad = voxel_feats.new_zeros(1, voxel_feats.shape[1])
    return torch.cat([voxel_feats, pad])[point_voxel_idx]


class HardSimpleVFE(nn.Module):
    """Mean of the (capped) points in each voxel.  Parameter-free."""

    def __init__(self, num_features: int = 5):
        super().__init__()
        self.num_features = num_features

    def forward(self, points: torch.Tensor, vox: VoxelizedPoints,
                v_cap: int) -> torch.Tensor:
        """points (N, C) flat, vox flat over the batch -> (v_cap, F)."""
        feats = points[:, :self.num_features]
        idx = torch.where(vox.point_mask, vox.point_voxel_idx, v_cap)
        return segment_mean(feats, idx, v_cap)


class DynamicVFELayer(nn.Module):
    """Linear (no bias) + BN over the valid points + ReLU."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.linear = nn.Linear(cin, cout, bias=False)
        self.bn = MaskedBatchNorm(cout)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.linear(x), mask))


class DynamicVFE(nn.Module):
    """Dynamic (uncapped) VFE; `in_channels` is the width of a point row."""

    def __init__(self, spec: VoxelizationSpec, in_channels: int = 4,
                 feat_channels: Sequence[int] = (64, 128),
                 with_distance: bool = False,
                 with_cluster_center: bool = True,
                 with_voxel_center: bool = True,
                 with_centroid_aware: bool = True):
        super().__init__()
        self.spec = spec
        self.with_distance = with_distance
        self.with_cluster_center = with_cluster_center
        self.with_voxel_center = with_voxel_center
        self.with_centroid_aware = with_cluster_center and with_centroid_aware
        cin = in_channels
        if with_cluster_center:
            if self.with_centroid_aware:
                e = _CENTROID_EMB
                self.centroid_fc1 = nn.Linear(3, e, bias=False)
                self.centroid_bn1 = MaskedBatchNorm(e)
                self.centroid_fc2 = nn.Linear(e, e, bias=False)
                self.centroid_bn2 = MaskedBatchNorm(e)
                cin += e
            else:
                cin += 3
        cin += 3 * with_voxel_center + with_distance
        layers = []
        for ch in feat_channels:
            layers.append(DynamicVFELayer(cin, ch))
            cin = 2 * ch        # the next layer also reads the voxel max
        self.layers = nn.ModuleList(layers)

    def forward(self, points: torch.Tensor, vox: VoxelizedPoints,
                v_cap: int) -> torch.Tensor:
        """points (N, in_channels) flat, vox flat over the batch ->
        (v_cap, feat_channels[-1])."""
        mask = vox.point_mask
        idx = torch.where(mask, vox.point_voxel_idx, v_cap)
        xyz = points[:, :3]
        feats = [points]
        if self.with_cluster_center:
            mean_xyz = segment_mean(torch.where(mask[:, None], xyz, 0.0), idx,
                                    v_cap)
            f_cluster = xyz - _gather_voxel_to_point(mean_xyz, idx)
            if self.with_centroid_aware:
                y = torch.tanh(self.centroid_bn1(self.centroid_fc1(f_cluster),
                                                 mask))
                f_cluster = torch.tanh(self.centroid_bn2(
                    self.centroid_fc2(y), mask))
            feats.append(f_cluster)
        if self.with_voxel_center:
            vs, pc = self.spec.voxel_size, self.spec.point_cloud_range
            c = vox.voxel_coords.float()
            centers = torch.stack([c[:, 2] * vs[0] + vs[0] / 2 + pc[0],
                                   c[:, 1] * vs[1] + vs[1] / 2 + pc[1],
                                   c[:, 0] * vs[2] + vs[2] / 2 + pc[2]], -1)
            feats.append(xyz - _gather_voxel_to_point(centers, idx))
        if self.with_distance:
            feats.append(torch.linalg.norm(xyz, dim=-1, keepdim=True))
        x = torch.where(mask[:, None], torch.cat(feats, -1), 0.0)
        for i, layer in enumerate(self.layers):
            x = torch.where(mask[:, None], layer(x, mask), 0.0)
            voxel_feats = segment_max(x, idx, v_cap)
            if i != len(self.layers) - 1:
                x = torch.cat([x, _gather_voxel_to_point(voxel_feats, idx)],
                              -1)
        return voxel_feats
