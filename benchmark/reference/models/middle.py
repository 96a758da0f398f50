"""The pillar middle encoder: a scatter of pillar features into a dense BEV
canvas (mmdet3d's PointPillarsScatter, cfg srfdet_pillar_nusc_L.py:53-54).
The sparse 3D encoder is in sparse_encoder.py.

The canvas is (ny, nx, C) per sample, cell `y * nx + x` (y-major), the JAX
package's layout: SECOND's weights read it after one NHWC -> NCHW permute.
Invalid slots go to a dropped row.  Parameter-free.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn


def pillar_scatter(voxel_feats: torch.Tensor, voxel_coords: torch.Tensor,
                   voxel_mask: torch.Tensor,
                   output_shape: Tuple[int, int]) -> torch.Tensor:
    """One sample: voxel_feats (V, C), coords (V, 3) zyx, mask (V,) ->
    (ny, nx, C)."""
    return pillar_scatter_batched(voxel_feats[None], voxel_coords[None],
                                  voxel_mask[None], output_shape)[0]


def pillar_scatter_batched(voxel_feats: torch.Tensor,
                           voxel_coords: torch.Tensor,
                           voxel_mask: torch.Tensor,
                           output_shape: Tuple[int, int]) -> torch.Tensor:
    """(B, V, C) -> (B, ny, nx, C) through one flat scatter: the batch
    index folds into the cell key, invalid slots write the dropped row
    B * ny * nx.  Two valid slots never share a cell (the voxelizer gives a
    cell one slot), so the scatter's order does not matter."""
    ny, nx = output_shape
    b, v, c = voxel_feats.shape
    cells = ny * nx
    flat = voxel_coords[..., 1].long() * nx + voxel_coords[..., 2].long()
    offs = (torch.arange(b, device=flat.device) * cells)[:, None]
    flat = torch.where(voxel_mask, flat + offs, b * cells).reshape(-1)
    canvas = voxel_feats.new_zeros(b * cells + 1, c)
    canvas = canvas.index_copy(0, flat, voxel_feats.reshape(-1, c))
    return canvas[:-1].reshape(b, ny, nx, c)


class PointPillarsScatter(nn.Module):
    """Module form of pillar_scatter_batched, (ny, nx) fixed."""

    def __init__(self, output_shape: Tuple[int, int]):
        super().__init__()
        self.output_shape = tuple(output_shape)

    def forward(self, voxel_feats: torch.Tensor, voxel_coords: torch.Tensor,
                voxel_mask: torch.Tensor) -> torch.Tensor:
        return pillar_scatter_batched(voxel_feats, voxel_coords, voxel_mask,
                                      self.output_shape)
