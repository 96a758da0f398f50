"""Sparse 3D middle encoder on bitmap-column rulebooks.

The nuScenes layout (block_type='basicblock', reference
sparse_encoder_custom.py:20-216): conv_input (subm), then per stage
SparseBasicBlocks and, for all but the last stage, a stride-2 downsample;
then conv_out (kernel (3,1,1), stride (2,1,1), pad 0) and a scatter to a
dense BEV map (B, H, W, D*C) with z-major channel groups, the JAX package's
layout, so its SECOND weights load unpermuted.

Every conv is a gather-GEMM over a (B, M, K) rulebook of global feature rows
(ops/gather_conv.py); the submanifold rulebooks come from the eq-match
kernel (ops/eqmatch.py), the strided and conv_out ones from plain integer
math (ops/bitmap_rulebook.py).  Voxels must arrive plan-major, as the
voxelizer emits them.
"""

from __future__ import annotations

from typing import Any, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.bitmap_rulebook import (build_columns, convout_rulebook_bitmap,
                                   convout_sites_bitmap, dense_bev_coords,
                                   strided_downsample_bitmap,
                                   subm_rulebook_eqmatch)
from ..ops.sparse_conv import (gathered_conv_apply_batched,
                               sparse_to_dense_batched)
from .layers import MaskedBatchNorm


def _pad3(p):
    return (p, p, p) if isinstance(p, int) else tuple(p)


class GatheredConvBN(nn.Module):
    """Gather-GEMM conv + masked BN + optional ReLU over a rulebook.  The
    kernel keeps the JAX layout (K, Cin, Cout); `subm` marks a submanifold
    rulebook, whose backward is the symmetric one."""

    def __init__(self, cin: int, cout: int, num_offsets: int,
                 relu: bool = True, subm: bool = False):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(num_offsets, cin, cout))
        self.bn = MaskedBatchNorm(cout)
        self.relu = relu
        self.subm = subm

    def forward(self, feats, gidx, mask):
        out = gathered_conv_apply_batched(feats, gidx, self.kernel,
                                          subm=self.subm)
        out = self.bn(out, mask)
        if self.relu:
            out = F.relu(out)
        return torch.where(mask[..., None], out, 0.0)


class BitmapRulebooks:
    """The bitmap-column rulebook walk through the encoder's stages."""

    def __init__(self, coords, mask, shape):
        self.cs, self.vcol, self.vz = build_columns(coords, mask, shape)
        self.mask = mask
        self.vyx = coords[..., 1:3]

    def subm(self):
        coords = torch.cat([self.vz[..., None], self.vyx], -1)
        return subm_rulebook_eqmatch(self.cs, coords, self.mask)

    def downsample(self, pad, capacity):
        cs, vcol, vz, vm, gidx, vyx = strided_downsample_bitmap(
            self.cs, _pad3(pad), capacity)
        self.cs, self.vcol, self.vz, self.mask, self.vyx = (cs, vcol, vz, vm,
                                                            vyx)
        return gidx

    def convout(self, capacity):
        cs, vcol, vz, vm = convout_sites_bitmap(self.cs, capacity)
        gidx = convout_rulebook_bitmap(self.cs, vcol, vz, vm)
        self.cs, self.vcol, self.vz, self.mask = cs, vcol, vz, vm
        return gidx

    def dense(self, feats):
        coords = dense_bev_coords(self.cs, self.vcol, self.vz)
        return sparse_to_dense_batched(feats, coords, self.mask,
                                       self.cs.shape)


class SparseEncoder(nn.Module):
    """basicblock-layout sparse encoder; submodules carry the JAX names."""

    def __init__(self, in_channels: int, sparse_shape: Tuple[int, int, int],
                 base_channels: int = 16, output_channels: int = 128,
                 encoder_channels: Sequence[Sequence[int]] = (
                     (16, 16, 32), (32, 32, 64), (64, 64, 128), (128, 128)),
                 encoder_paddings: Sequence[Sequence[Any]] = (
                     (0, 0, 1), (0, 0, 1), (0, 0, (0, 1, 1)), (0, 0)),
                 capacities: Sequence[int] = (60000, 30000, 15000, 15000)):
        super().__init__()
        self.sparse_shape = tuple(sparse_shape)
        self.encoder_channels = encoder_channels
        self.encoder_paddings = encoder_paddings
        self.capacities = tuple(capacities)
        self.conv_input = GatheredConvBN(in_channels, base_channels, 27,
                                         subm=True)
        # (kind, name, pad) in run order; convs registered under JAX names
        self.plan: List[Tuple[str, str, Any]] = []
        cin = base_channels
        n_stages = len(encoder_channels)
        for i, blocks in enumerate(encoder_channels):
            for j, out_ch in enumerate(blocks):
                pad = encoder_paddings[i][j]
                if j == len(blocks) - 1 and i != n_stages - 1:
                    self.add_module(f"down{i}", GatheredConvBN(
                        cin, out_ch, 27))
                    self.plan.append(("down", f"down{i}", pad))
                else:
                    if cin != out_ch:
                        raise ValueError("a basic block keeps its width")
                    self.add_module(f"bb{i}_{j}_conv1", GatheredConvBN(
                        cin, out_ch, 27, subm=True))
                    self.add_module(f"bb{i}_{j}_conv2", GatheredConvBN(
                        out_ch, out_ch, 27, relu=False, subm=True))
                    self.plan.append(("block", f"bb{i}_{j}", pad))
                cin = out_ch
        self.conv_out = GatheredConvBN(cin, output_channels, 3)

    def forward(self, voxel_feats: torch.Tensor, voxel_coords: torch.Tensor,
                voxel_mask: torch.Tensor) -> torch.Tensor:
        """(B, V, C) feats, (B, V, 3) zyx plan-major coords, (B, V) mask ->
        (B, H, W, D*C) BEV map."""
        rb = BitmapRulebooks(voxel_coords, voxel_mask, self.sparse_shape)
        mask = voxel_mask
        gidx = rb.subm()
        feats = self.conv_input(voxel_feats.float(), gidx, mask)
        ds = 0
        for kind, name, pad in self.plan:
            if kind == "down":
                gidx = rb.downsample(pad, self.capacities[ds])
                ds += 1
                mask = rb.mask
                feats = getattr(self, name)(feats, gidx, mask)
                gidx = rb.subm()
            else:
                f = getattr(self, f"{name}_conv1")(feats, gidx, mask)
                f = getattr(self, f"{name}_conv2")(f, gidx, mask)
                feats = torch.where(mask[..., None], F.relu(f + feats), 0.0)
        gidx = rb.convout(self.capacities[-1])
        feats = self.conv_out(feats, gidx, rb.mask)
        dense = rb.dense(feats)                         # (B, D, H, W, C)
        b, d, h, w, c = dense.shape
        return dense.permute(0, 2, 3, 1, 4).reshape(b, h, w, d * c)
