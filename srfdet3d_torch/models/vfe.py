"""Voxel feature encoders as point-major segment reductions.

- HardSimpleVFE (the flagship's, cfg srfdet_voxel_nusc_L.py:70): the mean
  of each voxel's capped points.
- PillarFeatureNet (the pillar family's, reference
  pillar_encoder_custom.py:14): cluster-centre and voxel-centre offsets
  decorate each point; PFN layers of Linear + masked BN + ReLU with a
  max per pillar, the non-last ones half wide with the gathered-back max
  concatenated.
- DynamicVFE (the KITTI family's, reference voxel_encoder.py:11-240):
  cluster-centre offsets (optionally embedded by a Linear-BN-tanh MLP),
  voxel-centre offsets and distance decorate each point; stacked
  Linear + masked BN + ReLU layers with a scatter-max per voxel and a
  gather-back concat between layers.

Points and voxels are flat over the batch; invalid points carry the slot id
`v_cap` and are dropped by the segment reductions.  The decorations are
float32; the Linear and BN layers run in the module's `dtype`
(layers.set_dtype), and so do the pooled features of the PFN and the
dynamic VFE.  HardSimpleVFE's means stay float32: the encoder casts them.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..config import VoxelizationSpec
from ..ops.scatter import segment_max, segment_mean
from ..ops.voxelize import VoxelizedPoints
from .layers import Linear, MaskedBatchNorm

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


class PFNLayer(nn.Module):
    """Linear (no bias) -> BN over the valid points -> ReLU -> zero the
    invalid points -> max per pillar.  A non-last layer is out // 2 wide and
    also returns its points with the pillar max concatenated."""

    def __init__(self, cin: int, cout: int, last_layer: bool = False):
        super().__init__()
        self.last_layer = last_layer
        units = cout if last_layer else cout // 2
        self.linear = Linear(cin, units, bias=False)
        self.bn = MaskedBatchNorm(units)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, idx: torch.Tensor,
                v_cap: int):
        """x (N, cin), mask (N,), idx (N,) with v_cap at invalid points ->
        (pooled (v_cap, units), the next layer's input or None)."""
        x = F.relu(self.bn(self.linear(x), mask))
        x = torch.where(mask[:, None], x, 0.0)
        pooled = segment_max(x, idx, v_cap)
        if self.last_layer:
            return pooled, None
        return pooled, torch.cat([x, _gather_voxel_to_point(pooled, idx)],
                                 -1)


class PillarFeatureNet(nn.Module):
    """PointPillars pillar encoder; `in_channels` is the width of a point
    row (the decorations add 3 + 3 + distance)."""

    def __init__(self, spec: VoxelizationSpec, in_channels: int = 4,
                 feat_channels: Sequence[int] = (64,),
                 with_distance: bool = False,
                 with_cluster_center: bool = True,
                 with_voxel_center: bool = True):
        super().__init__()
        self.spec = spec
        self.with_distance = with_distance
        self.with_cluster_center = with_cluster_center
        self.with_voxel_center = with_voxel_center
        cin = (in_channels + 3 * with_cluster_center + 3 * with_voxel_center
               + with_distance)
        n = len(feat_channels)
        layers = []
        for i, ch in enumerate(feat_channels):
            layers.append(PFNLayer(cin, ch, last_layer=i == n - 1))
            cin = ch            # out // 2 points + out // 2 pillar max
        self.layers = nn.ModuleList(layers)

    def forward(self, points: torch.Tensor, vox: VoxelizedPoints,
                v_cap: int) -> torch.Tensor:
        """points (N, in_channels) flat, vox flat over the batch ->
        (v_cap, feat_channels[-1])."""
        mask = vox.point_mask
        idx = torch.where(mask, vox.point_voxel_idx, v_cap)
        x = torch.where(mask[:, None], _decorate(self, points, vox, idx,
                                                 v_cap), 0.0)
        for layer in self.layers:
            pooled, x = layer(x, mask, idx, v_cap)
        return pooled


def _voxel_centers(spec: VoxelizationSpec, coords: torch.Tensor
                   ) -> torch.Tensor:
    """(V, 3) zyx voxel coords -> (V, 3) xyz centres."""
    vs, pc = spec.voxel_size, spec.point_cloud_range
    c = coords.float()
    return torch.stack([c[:, 2] * vs[0] + vs[0] / 2 + pc[0],
                        c[:, 1] * vs[1] + vs[1] / 2 + pc[1],
                        c[:, 0] * vs[2] + vs[2] / 2 + pc[2]], -1)


def _decorate(vfe, points, vox, idx, v_cap, cluster_mlp=None):
    """Each point row with its decorations, in the JAX order: the row,
    the offset from its voxel's point mean (through cluster_mlp where
    given), the offset from its voxel's centre, its distance."""
    mask = vox.point_mask
    xyz = points[:, :3]
    feats = [points]
    if vfe.with_cluster_center:
        mean_xyz = segment_mean(torch.where(mask[:, None], xyz, 0.0), idx,
                                v_cap)
        f_cluster = xyz - _gather_voxel_to_point(mean_xyz, idx)
        feats.append(f_cluster if cluster_mlp is None
                     else cluster_mlp(f_cluster, mask))
    if vfe.with_voxel_center:
        centers = _voxel_centers(vfe.spec, vox.voxel_coords)
        feats.append(xyz - _gather_voxel_to_point(centers, idx))
    if vfe.with_distance:
        feats.append(torch.linalg.norm(xyz, dim=-1, keepdim=True))
    return torch.cat(feats, -1)


class DynamicVFELayer(nn.Module):
    """Linear (no bias) + BN over the valid points + ReLU."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.linear = Linear(cin, cout, bias=False)
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
                self.centroid_fc1 = Linear(3, e, bias=False)
                self.centroid_bn1 = MaskedBatchNorm(e)
                self.centroid_fc2 = Linear(e, e, bias=False)
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

    def _centroid_mlp(self, f_cluster: torch.Tensor, mask: torch.Tensor
                      ) -> torch.Tensor:
        y = torch.tanh(self.centroid_bn1(self.centroid_fc1(f_cluster), mask))
        return torch.tanh(self.centroid_bn2(self.centroid_fc2(y), mask))

    def forward(self, points: torch.Tensor, vox: VoxelizedPoints,
                v_cap: int) -> torch.Tensor:
        """points (N, in_channels) flat, vox flat over the batch ->
        (v_cap, feat_channels[-1])."""
        mask = vox.point_mask
        idx = torch.where(mask, vox.point_voxel_idx, v_cap)
        mlp = self._centroid_mlp if self.with_centroid_aware else None
        x = torch.where(mask[:, None],
                        _decorate(self, points, vox, idx, v_cap, mlp), 0.0)
        for i, layer in enumerate(self.layers):
            x = torch.where(mask[:, None], layer(x, mask), 0.0)
            voxel_feats = segment_max(x, idx, v_cap)
            if i != len(self.layers) - 1:
                x = torch.cat([x, _gather_voxel_to_point(voxel_feats, idx)],
                              -1)
        return voxel_feats
