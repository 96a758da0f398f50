"""Sparse 3D middle encoder over gathered-conv rulebooks.

Both layouts of the JAX package (reference sparse_encoder_custom.py:20-216):

  - block_type='basicblock' (nuScenes / Waymo): conv_input (subm), then per
    stage SparseBasicBlocks and, for all but the last stage, a stride-2
    downsample;
  - block_type='conv_module' (KITTI, mmdet3d's defaults): conv_input, then
    per stage a stride-2 downsample (stages 1..) and submanifold convs,
    every conv + BN + ReLU;

then conv_out (kernel (3,1,1), stride (2,1,1), pad 0) and a scatter to a
dense BEV map (B, H, W, D*C) with z-major channel groups, the JAX package's
layout, so its SECOND weights load unpermuted.

Every conv is a gather-GEMM over a (B, M, K) rulebook of global feature rows
(ops/gather_conv.py).  Two rulebook backends give the same rulebooks up to
row order (identical offset order, so weights transfer between them):

  - 'bitmap' (the default): z-bitmap columns (ops/bitmap_rulebook.py); the
    submanifold rulebooks come from the eq-match kernel (ops/eqmatch.py),
    the strided and conv_out ones from plain integer math.  Voxels must
    arrive plan-major, as the voxelizer emits them.  It needs the z-depth
    chain to fit its bit words; other grids take the table backend.
  - 'table': z-major key tables (ops/sparse_conv.py), whose lookups are the
    rulebook_lookup kernel (ops/rulebook_lookup.py); voxels in any order.
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
from ..ops.sparse_conv import (conv_out_shape, generate_output_sites,
                               gathered_conv_apply_batched, make_key_table,
                               sparse_to_dense_batched,
                               strided_gather_indices_batched,
                               subm_gather_indices_batched)
from .layers import MaskedBatchNorm


def _pad3(p):
    return (p, p, p) if isinstance(p, int) else tuple(p)


class GatheredConvBN(nn.Module):
    """Gather-GEMM conv + masked BN + optional ReLU over a rulebook.  The
    kernel keeps the JAX layout (K, Cin, Cout); `subm` marks a submanifold
    rulebook, whose backward is the symmetric one.  In bfloat16 the
    kernel is cast at use (JAX `w.astype(self.dtype)`), so its grad comes
    back rounded to bfloat16 through the cast."""

    dtype = torch.float32

    def __init__(self, cin: int, cout: int, num_offsets: int,
                 relu: bool = True, subm: bool = False):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(num_offsets, cin, cout))
        self.bn = MaskedBatchNorm(cout)
        self.relu = relu
        self.subm = subm

    def forward(self, feats, gidx, mask):
        out = gathered_conv_apply_batched(feats, gidx,
                                          self.kernel.to(self.dtype),
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
        self.coords = coords

    def subm(self):
        return subm_rulebook_eqmatch(self.cs, self.coords, self.mask)

    def downsample(self, pad, capacity):
        cs, vcol, vz, vm, gidx, vyx = strided_downsample_bitmap(
            self.cs, _pad3(pad), capacity)
        self.cs, self.vcol, self.vz, self.mask = cs, vcol, vz, vm
        self.coords = torch.cat([vz[..., None], vyx], -1)
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


class TableRulebooks:
    """The key-table rulebook walk through the encoder's stages (JAX
    `_TableRulebooks`).  One key table a stage, shared by the stage's subm
    rulebook and the next strided conv's input lookup.  Only the input
    voxels need the table's sort: every later stage's sites come out of
    generate_output_sites in key order."""

    def __init__(self, coords, mask, shape):
        self.coords, self.mask, self.shape = coords, mask, tuple(shape)
        self.table = make_key_table(coords, mask, self.shape)

    def _table(self):
        if self.table is None:
            self.table = make_key_table(self.coords, self.mask, self.shape,
                                        in_key_order=True)
        return self.table

    def subm(self):
        return subm_gather_indices_batched(self.coords, self.mask,
                                           self.shape, 3,
                                           key_table=self._table())

    def _strided(self, kernel, stride, pad, capacity):
        oshape = conv_out_shape(self.shape, kernel, stride, pad)
        oc, om = generate_output_sites(self.coords, self.mask, self.shape,
                                       kernel, stride, pad, capacity)
        gidx = strided_gather_indices_batched(
            self.coords, self.mask, self.shape, oc, om, kernel, stride, pad,
            key_table=self._table())
        self.coords, self.mask, self.shape = oc, om, oshape
        self.table = None
        return gidx

    def downsample(self, pad, capacity):
        return self._strided((3, 3, 3), (2, 2, 2), _pad3(pad), capacity)

    def convout(self, capacity):
        return self._strided((3, 1, 1), (2, 1, 1), (0, 0, 0), capacity)

    def dense(self, feats):
        return sparse_to_dense_batched(feats, self.coords, self.mask,
                                       self.shape)


def down_pads(block_type: str, encoder_channels, encoder_paddings) -> List:
    """Padding of each strided downsample, in stage order: the one
    definition of where the downsamples sit in each layout (conv_module:
    the first conv of stages 1..; basicblock: the last conv of all but the
    last stage)."""
    if block_type == "conv_module":
        return [encoder_paddings[i][0]
                for i in range(1, len(encoder_channels))]
    if block_type == "basicblock":
        return [encoder_paddings[i][len(blocks) - 1]
                for i, blocks in enumerate(encoder_channels[:-1])]
    raise ValueError(block_type)


def _bitmap_supported(shape, pads: List) -> bool:
    """The bitmap backend needs the z-depth chain to fit its bit words:
    input depth <= 64, every downsample's output depth in (0, 32], and a
    valid conv_out depth.  True for every shipped grid (41 -> 21 -> 11 -> 5
    -> 2)."""
    d = shape[0]
    if d > 64:
        return False
    for pad in pads:
        pz = _pad3(pad)[0]
        if d + pz > 64:       # decimate_bits shifts left by pz before a tap
            return False
        d = (d + 2 * pz - 3) // 2 + 1
        if d <= 0 or d > 32:
            return False
    return (d - 3) // 2 + 1 >= 1


class SparseEncoder(nn.Module):
    """Sparse encoder of either layout; submodules carry the JAX names
    (conv_input, down{i}, subm{i}_{j} or bb{i}_{j}_conv{1,2}, conv_out).
    The voxel features are cast to `dtype` on entry."""

    dtype = torch.float32

    def __init__(self, in_channels: int, sparse_shape: Tuple[int, int, int],
                 base_channels: int = 16, output_channels: int = 128,
                 encoder_channels: Sequence[Sequence[int]] = (
                     (16, 16, 32), (32, 32, 64), (64, 64, 128), (128, 128)),
                 encoder_paddings: Sequence[Sequence[Any]] = (
                     (0, 0, 1), (0, 0, 1), (0, 0, (0, 1, 1)), (0, 0)),
                 capacities: Sequence[int] = (60000, 30000, 15000, 15000),
                 block_type: str = "basicblock", rulebook: str = "bitmap"):
        super().__init__()
        self.sparse_shape = tuple(sparse_shape)
        self.encoder_channels = encoder_channels
        self.encoder_paddings = encoder_paddings
        self.capacities = tuple(capacities)
        self.block_type = block_type
        # the JAX package's backend choice: bitmap where its bit words hold
        # the grid's depth chain, the table backend otherwise
        self.use_bitmap = rulebook == "bitmap" and _bitmap_supported(
            self.sparse_shape,
            down_pads(block_type, encoder_channels, encoder_paddings))
        self.conv_input = GatheredConvBN(in_channels, base_channels, 27,
                                         subm=True)
        # (kind, name, pad) in run order; convs registered under JAX names
        self.plan: List[Tuple[str, str, Any]] = []
        cin = base_channels
        n_stages = len(encoder_channels)
        for i, blocks in enumerate(encoder_channels):
            for j, out_ch in enumerate(blocks):
                pad = encoder_paddings[i][j]
                if block_type == "conv_module":
                    is_down = i != 0 and j == 0
                else:
                    is_down = j == len(blocks) - 1 and i != n_stages - 1
                if is_down:
                    self.add_module(f"down{i}", GatheredConvBN(
                        cin, out_ch, 27))
                    self.plan.append(("down", f"down{i}", pad))
                elif block_type == "conv_module":
                    self.add_module(f"subm{i}_{j}", GatheredConvBN(
                        cin, out_ch, 27, subm=True))
                    self.plan.append(("subm", f"subm{i}_{j}", pad))
                elif block_type == "basicblock":
                    if cin != out_ch:
                        raise ValueError("a basic block keeps its width")
                    self.add_module(f"bb{i}_{j}_conv1", GatheredConvBN(
                        cin, out_ch, 27, subm=True))
                    self.add_module(f"bb{i}_{j}_conv2", GatheredConvBN(
                        out_ch, out_ch, 27, relu=False, subm=True))
                    self.plan.append(("block", f"bb{i}_{j}", pad))
                else:
                    raise ValueError(block_type)
                cin = out_ch
        self.conv_out = GatheredConvBN(cin, output_channels, 3)

    def forward(self, voxel_feats: torch.Tensor, voxel_coords: torch.Tensor,
                voxel_mask: torch.Tensor) -> torch.Tensor:
        """(B, V, C) feats, (B, V, 3) zyx coords (plan-major for the bitmap
        backend), (B, V) mask -> (B, H, W, D*C) BEV map."""
        backend = BitmapRulebooks if self.use_bitmap else TableRulebooks
        rb = backend(voxel_coords, voxel_mask, self.sparse_shape)
        mask = voxel_mask
        gidx = rb.subm()
        feats = self.conv_input(voxel_feats.to(self.dtype), gidx, mask)
        ds = 0
        for kind, name, pad in self.plan:
            if kind == "down":
                gidx = rb.downsample(pad, self.capacities[ds])
                ds += 1
                mask = rb.mask
                feats = getattr(self, name)(feats, gidx, mask)
                gidx = rb.subm()
            elif kind == "subm":
                feats = getattr(self, name)(feats, gidx, mask)
            else:
                f = getattr(self, f"{name}_conv1")(feats, gidx, mask)
                f = getattr(self, f"{name}_conv2")(f, gidx, mask)
                feats = torch.where(mask[..., None], F.relu(f + feats), 0.0)
        gidx = rb.convout(self.capacities[-1])
        feats = self.conv_out(feats, gidx, rb.mask)
        dense = rb.dense(feats)                         # (B, D, H, W, C)
        b, d, h, w, c = dense.shape
        return dense.permute(0, 2, 3, 1, 4).reshape(b, h, w, d * c)
