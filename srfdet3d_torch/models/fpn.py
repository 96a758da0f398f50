"""FPN neck with mmdet's semantics, NCHW: lateral 1x1 convs, top-down
nearest upsampling, 3x3 output convs, and num_outs - num_ins extra levels
from the last output: stride-2 3x3 convs (add_extra_convs='on_output', the
nuScenes voxel neck) or, with extra_convs=False (mmdet's default, the KITTI
and pillar necks), max_pool2d with kernel 1 and stride 2, a parameter-free
subsample.  The point-cloud neck uses BN + ReLU in every conv."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import ConvBNReLU


def upsample_nearest(x: torch.Tensor, hw) -> torch.Tensor:
    """Nearest resize of NCHW to (h, w).  For the integer factors the FPN
    uses, this equals the JAX package's jax.image.resize 'nearest'."""
    return F.interpolate(x, size=tuple(hw), mode="nearest")


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 128,
                 num_outs: int = 4, extra_convs: bool = True):
        super().__init__()
        self.num_extra = num_outs - len(in_channels)
        self.lateral = nn.ModuleList(
            ConvBNReLU(c, out_channels, 1, 1, 0) for c in in_channels)
        self.fpn = nn.ModuleList(
            ConvBNReLU(out_channels, out_channels, 3, 1, 1)
            for _ in in_channels)
        self.extra = nn.ModuleList(
            ConvBNReLU(out_channels, out_channels, 3, 2, 1)
            for _ in range(self.num_extra if extra_convs else 0))

    def forward(self, inputs: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, ...]:
        laterals = [conv(x) for conv, x in zip(self.lateral, inputs)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + upsample_nearest(
                laterals[i], laterals[i - 1].shape[-2:])
        outs = [conv(x) for conv, x in zip(self.fpn, laterals)]
        for i in range(self.num_extra):
            if self.extra:
                outs.append(self.extra[i](outs[-1]))
            else:
                outs.append(outs[-1][..., ::2, ::2])
        return tuple(outs)
