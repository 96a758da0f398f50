"""Multi-scale deformable attention and the deformable BEV encoder, the
optional head stage that `head.with_lidar_encoder` turns on (a port of
the JAX package's `models/deform_attn.py`; reference srfdet_head.py:228-263,
657-757, mmcv's MultiScaleDeformableAttention and DetrTransformerEncoder).

Each query samples, per head, level and point, one bilinear tap of the
value map at its reference point plus a learned offset; softmax weights
over levels x points sum the taps.  A tap reads the map at pixel
(x * w - 0.5, y * h - 0.5) of normalized (x, y), and corners outside the
map read zero: `F.grid_sample(align_corners=False, padding_mode="zeros")`,
which keeps only the (B*heads, head_dim, Q, points) result a level and
not the gathered corners (at the flagship's width 43,054 queries a
sample).

In bfloat16 (`dtype`) everything computes in bfloat16, the coordinate
arithmetic too, as in the JAX package (`deform_attn.py:113`, `:178-185`);
the taps then come from `bilinear_taps`, the JAX package's own bilinear
sample op for op (grid_sample computes its positions in float32):
the raw pixel centres fed to the position embedding are x + 0.5, which
bfloat16 holds exactly only below 128 (its spacing is 1 in [128, 256)), so
on the flagship's 184-cell level the centres past 128 round to integers,
in the JAX package and here alike.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm2d, LayerNorm, Linear, dropout, softmax


def bilinear_taps(value: torch.Tensor, loc: torch.Tensor) -> torch.Tensor:
    """The JAX package's `_bilinear_sample` in the values' dtype, op for op
    (`deform_attn.py:29-54`): value (N, C, H, W), loc (N, Q, P, 2)
    normalized (x, y) -> (N, C, Q, P).  Each op rounds to the dtype, as a
    bfloat16 program does; corners outside the map read zero.  The gather
    reads a float32 copy of the values, so its backward sums in float32
    (no bfloat16 scatter) and rounds once, through that copy's cast."""
    n, c, h, w = value.shape
    dt = value.dtype
    x = loc[..., 0] * w - 0.5
    y = loc[..., 1] * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    lx, ly = x - x0, y - y0
    flat = value.float().reshape(n, c, h * w)
    q, p = loc.shape[1:3]

    def tap(yy, xx):
        ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        idx = torch.where(ok, yy.long() * w + xx.long(), 0)
        g = torch.gather(flat, 2, idx.reshape(n, 1, q * p).expand(n, c, -1))
        g = torch.where(ok.reshape(n, 1, q * p), g, 0.0)
        return g.reshape(n, c, q, p).to(dt)

    one = torch.ones((), dtype=dt, device=value.device)
    return (tap(y0, x0) * ((one - ly) * (one - lx))[:, None] +
            tap(y0, x0 + 1) * ((one - ly) * lx)[:, None] +
            tap(y0 + 1, x0) * (ly * (one - lx))[:, None] +
            tap(y0 + 1, x0 + 1) * (ly * lx)[:, None])


class MSDeformAttention(nn.Module):
    """queries (B, Q, C) attending to levels (B, H_l, W_l, C) at reference
    points (B, Q, 2), normalized [0, 1] (x, y)."""

    dtype = torch.float32

    def __init__(self, embed_dim: int = 128, num_heads: int = 8,
                 num_levels: int = 4, num_points: int = 4):
        super().__init__()
        self.num_heads, self.num_levels = num_heads, num_levels
        self.num_points = num_points
        c = embed_dim
        self.value_proj = Linear(c, c)
        self.sampling_offsets = Linear(
            c, num_heads * num_levels * num_points * 2)
        self.attention_weights = Linear(
            c, num_heads * num_levels * num_points)
        self.output_proj = Linear(c, c)

    @torch.no_grad()
    def init_weights(self) -> None:
        """mmcv's init: zero offset and weight kernels, and a grid bias that
        points head h along angle 2*pi*h/heads, normalized to max-abs 1 and
        scaled by the point index + 1, so the taps start spread."""
        nh, nl, npt = self.num_heads, self.num_levels, self.num_points
        th = (2.0 * np.pi / nh) * np.arange(nh)
        d = np.stack([np.cos(th), np.sin(th)], -1)
        d = d / np.abs(d).max(-1, keepdims=True)
        grid = np.tile(d[:, None, None, :], (1, nl, npt, 1))
        grid = grid * np.arange(1, npt + 1)[None, None, :, None]
        for lin in (self.sampling_offsets, self.attention_weights):
            lin.weight.zero_()
            lin.bias.zero_()
        self.sampling_offsets.bias.copy_(torch.as_tensor(
            grid.reshape(-1), dtype=torch.float32))

    def forward(self, query: torch.Tensor, levels: Sequence[torch.Tensor],
                reference_points: torch.Tensor) -> torch.Tensor:
        b, q, c = query.shape
        nh, npt, nl = self.num_heads, self.num_points, len(levels)
        hd = c // nh
        off = self.sampling_offsets(query).view(b, q, nh, nl, npt, 2)
        attn = softmax(self.attention_weights(query).view(
            b, q, nh, nl * npt), -1).view(b, q, nh, nl, npt)
        out = query.new_zeros(b * nh, hd, q)
        for li, lv in enumerate(levels):
            h, w = lv.shape[1], lv.shape[2]
            value = self.value_proj(lv).view(b, h, w, nh, hd)
            value = value.permute(0, 3, 4, 1, 2).reshape(b * nh, hd, h, w)
            loc = (reference_points[:, :, None, None, :] +
                   off[:, :, :, li] / off.new_tensor([w, h]))
            loc = loc.permute(0, 2, 1, 3, 4).reshape(b * nh, q, npt, 2)
            if value.dtype == torch.float32:
                taps = F.grid_sample(value, 2.0 * loc - 1.0, mode="bilinear",
                                     padding_mode="zeros",
                                     align_corners=False)
            else:
                taps = bilinear_taps(value, loc)
            wgt = attn[:, :, :, li].permute(0, 2, 1, 3).reshape(
                b * nh, 1, q, npt)
            out = out + (taps * wgt).sum(-1)              # (B*nh, hd, Q)
        out = out.view(b, nh * hd, q).transpose(1, 2)
        return self.output_proj(out)


class PositionEmbeddingLearned(nn.Module):
    """Dense-BN-ReLU-Dense over (x, y) positions (reference
    srfdet_head.py:25-45): BatchNorm eps 1e-5, momentum 0.1 (flax 0.9),
    the biased variance in its running statistics, synced over the ranks
    under a process group (the port's BatchNorm2d)."""

    def __init__(self, num_pos_feats: int = 128):
        super().__init__()
        self.fc1 = Linear(2, num_pos_feats)
        self.bn = BatchNorm2d(num_pos_feats, eps=1e-5, momentum=0.1)
        self.fc2 = Linear(num_pos_feats, num_pos_feats)

    def forward(self, xy: torch.Tensor) -> torch.Tensor:
        x = self.fc1(xy)
        shape = x.shape
        x = self.bn(x.reshape(-1, shape[-1])[:, :, None, None])
        return self.fc2(F.relu(x.reshape(shape)))


class EncoderLayer(nn.Module):
    """One post-norm layer: deformable self-attention, then the FFN."""

    def __init__(self, c: int, ffn_dim: int, num_levels: int):
        super().__init__()
        self.attn = MSDeformAttention(c, num_levels=num_levels)
        self.norm1 = LayerNorm(c, eps=1e-5)
        self.ffn1 = Linear(c, ffn_dim)
        self.ffn2 = Linear(ffn_dim, c)
        self.norm2 = LayerNorm(c, eps=1e-5)


class LidarBEVEncoder(nn.Module):
    """Two deformable self-attention layers over the multi-level BEV maps
    (reference _get_lidar_encoder_feats, srfdet_head.py:657-757).  The
    stream holds features only: the positional term (a learned embedding of
    raw pixel centres, plus the level embedding) is added to the query in
    every layer, and the values are sampled from the stream itself.
    Reference points are the normalized pixel centres.  Dropout is 0.1,
    fixed, in train mode, from the generator the caller passes."""

    dtype = torch.float32
    dropout_rate = 0.1

    def __init__(self, embed_dim: int = 128, num_levels: int = 4,
                 num_layers: int = 2, ffn_dim: int = 256):
        super().__init__()
        self.level_embed = nn.Parameter(torch.zeros(num_levels, embed_dim))
        self.pos = nn.ModuleList(PositionEmbeddingLearned(embed_dim)
                                 for _ in range(num_levels))
        self.layers = nn.ModuleList(EncoderLayer(embed_dim, ffn_dim,
                                                 num_levels)
                                    for _ in range(num_layers))

    @torch.no_grad()
    def init_weights(self, g: torch.Generator) -> None:
        """N(0, 1) level embeddings and the attention's mmcv init."""
        self.level_embed.copy_(torch.randn(self.level_embed.shape,
                                           generator=g))
        for layer in self.layers:
            layer.attn.init_weights()

    def forward(self, levels: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None
                ) -> List[torch.Tensor]:
        """levels: (B, H_l, W_l, C) maps -> the encoded maps, same shapes."""
        b, c = levels[0].shape[0], levels[0].shape[-1]
        rate = self.dropout_rate if self.training else 0.0
        dev = levels[0].device
        shapes = [(lv.shape[1], lv.shape[2]) for lv in levels]
        poss, refs = [], []
        for li, (h, w) in enumerate(shapes):
            ys, xs = torch.meshgrid(
                torch.arange(h, device=dev, dtype=torch.float32) + 0.5,
                torch.arange(w, device=dev, dtype=torch.float32) + 0.5,
                indexing="ij")
            pix = torch.stack([xs, ys], -1).reshape(1, h * w, 2)
            emb = self.pos[li](pix.expand(b, h * w, 2).to(self.dtype))
            poss.append(emb + self.level_embed[li].to(self.dtype))
            refs.append(torch.stack([xs / w, ys / h], -1).reshape(1, h * w, 2)
                        .expand(b, h * w, 2).to(self.dtype))
        x = torch.cat([lv.reshape(b, -1, c) for lv in levels], 1)
        pos = torch.cat(poss, 1)
        ref = torch.cat(refs, 1)
        sizes = [h * w for h, w in shapes]
        for layer in self.layers:
            views = [part.reshape(b, h, w, c) for part, (h, w) in
                     zip(torch.split(x, sizes, 1), shapes)]
            attn = layer.attn(x + pos, views, ref)
            x = layer.norm1(x + dropout(attn, rate, generator))
            y = dropout(F.relu(layer.ffn1(x)), rate, generator)
            y = layer.ffn2(y)
            x = layer.norm2(x + dropout(y, rate, generator))
        return [part.reshape(b, h, w, c) for part, (h, w) in
                zip(torch.split(x, sizes, 1), shapes)]
