"""Voxel feature encoders as point-major segment reductions.

HardSimpleVFE (the flagship's, cfg srfdet_voxel_nusc_L.py:70): the mean of
each voxel's capped points.  Invalid points carry the slot id `v_cap` and
are dropped by the segment mean.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.scatter import segment_mean
from ..ops.voxelize import VoxelizedPoints


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
