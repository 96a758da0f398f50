"""FPN neck with mmdet's semantics, NCHW: lateral 1x1 convs, top-down
nearest upsampling, 3x3 output convs, and num_outs - num_ins extra levels
from the last output: stride-2 3x3 convs (add_extra_convs='on_output', the
nuScenes voxel neck and the image necks; with relu_before_extra_convs a
ReLU before every extra conv but the first) or, with extra_convs=False
(mmdet's default, the KITTI and pillar necks), max_pool2d with kernel 1 and
stride 2, a parameter-free subsample.  The point-cloud neck uses BN + ReLU
in every conv; an image neck has plain convs with bias (use_norm=False),
or BN + ReLU (the Waymo LC neck, use_norm=True)."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import ConvBNReLU


def upsample_nearest(x: torch.Tensor, hw) -> torch.Tensor:
    """Nearest resize of NCHW to (h, w) by an integer factor, where it
    equals the JAX package's jax.image.resize 'nearest' (half-pixel; the
    floor indexing of F.interpolate differs at other factors, so those
    raise)."""
    h, w = x.shape[-2:]
    if hw[0] % h or hw[1] % w:
        raise ValueError(f"nearest upsample {h}x{w} -> {hw[0]}x{hw[1]} is "
                         f"not by an integer factor")
    return F.interpolate(x, size=tuple(hw), mode="nearest")


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 128,
                 num_outs: int = 4, extra_convs: bool = True,
                 use_norm: bool = True, relu_before_extra_convs: bool = False):
        super().__init__()
        self.num_extra = num_outs - len(in_channels)
        self.relu_before_extra = relu_before_extra_convs
        block = dict(bias=not use_norm, bn=use_norm, relu=use_norm)
        self.lateral = nn.ModuleList(
            ConvBNReLU(c, out_channels, 1, 1, 0, **block)
            for c in in_channels)
        self.fpn = nn.ModuleList(
            ConvBNReLU(out_channels, out_channels, 3, 1, 1, **block)
            for _ in in_channels)
        self.extra = nn.ModuleList(
            ConvBNReLU(out_channels, out_channels, 3, 2, 1, **block)
            for _ in range(self.num_extra if extra_convs else 0))

    def forward(self, inputs: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, ...]:
        laterals = [conv(x) for conv, x in zip(self.lateral, inputs)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + upsample_nearest(
                laterals[i], laterals[i - 1].shape[-2:])
        outs = [conv(x) for conv, x in zip(self.fpn, laterals)]
        for i in range(self.num_extra):
            if not self.extra:
                outs.append(outs[-1][..., ::2, ::2])
                continue
            src = outs[-1]
            if self.relu_before_extra and i > 0:
                src = F.relu(src)
            outs.append(self.extra[i](src))
        return tuple(outs)
