"""ResNet image backbone, NCHW (JAX `models/resnet.py`, mmdet's ResNet).

A 7x7 stride-2 stem conv + BN + ReLU and a 3x3 stride-2 max pool (padding
1), then four stages of basic or bottleneck blocks; every stage but the
first halves the map in its first block.  A bottleneck's stride sits on its
3x3 conv in "pytorch" style and on its first 1x1 conv in "caffe" style;
`stage_with_dcn` swaps a stage's 3x3 convs for DCNv2 (`deform_conv`).  A
1x1 `down` conv + BN carries the identity where the stride or the width
changes.  Returns the four stage outputs (strides 4, 8, 16, 32).  BN uses
eps 1e-5.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .deform_conv import ModulatedDeformConv
from .layers import BatchNorm2d, conv_bn

RESNET_DEPTHS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
}


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 style: str = "pytorch", dcn: bool = False):
        super().__init__()
        s1, s2 = (stride, 1) if style == "caffe" else (1, stride)
        self.dcn = dcn
        self.conv1 = conv_bn(cin, planes, 1, s1)
        if dcn:
            self.dcn2 = ModulatedDeformConv(planes, planes, 3, s2, 1)
            self.bn2 = BatchNorm2d(planes, eps=1e-5, momentum=0.1)
        else:
            self.conv2 = conv_bn(planes, planes, 3, s2)
        self.conv3 = conv_bn(planes, planes * 4, 1, relu=False)
        self.down = (conv_bn(cin, planes * 4, 1, stride, relu=False)
                     if stride != 1 or cin != planes * 4 else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv1(x)
        out = (F.relu(self.bn2(self.dcn2(out))) if self.dcn
               else self.conv2(out))
        out = self.conv3(out)
        return F.relu(out + (x if self.down is None else self.down(x)))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1, **_):
        super().__init__()
        self.conv1 = conv_bn(cin, planes, 3, stride)
        self.conv2 = conv_bn(planes, planes, 3, relu=False)
        self.down = (conv_bn(cin, planes, 1, stride, relu=False)
                     if stride != 1 or cin != planes else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2(self.conv1(x))
        return F.relu(out + (x if self.down is None else self.down(x)))


class ResNet(nn.Module):
    """forward((N, 3, H, W)) -> the four stage outputs, strides 4-32."""

    def __init__(self, depth: int = 50, style: str = "pytorch",
                 stage_with_dcn: Sequence[bool] = (False,) * 4):
        super().__init__()
        kind, layers = RESNET_DEPTHS[depth]
        block = Bottleneck if kind == "bottleneck" else BasicBlock
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64, eps=1e-5, momentum=0.1)
        self.layers = nn.ModuleList()
        cin, planes = 64, 64
        for stage, n in enumerate(layers):
            blocks = nn.Sequential()
            for i in range(n):
                stride = 2 if stage > 0 and i == 0 else 1
                blocks.append(block(cin, planes, stride, style=style,
                                    dcn=stage_with_dcn[stage]))
                cin = planes * block.expansion
            self.layers.append(blocks)
            planes *= 2
        self.out_channels = tuple(64 * block.expansion * 2 ** s
                                  for s in range(4))

    def frozen_stage_modules(self, n: int) -> Tuple[str, ...]:
        """The submodules that frozen_stages = n freezes: the root conv1 /
        bn1 and the first n stages (JAX `Conv_0`, `BatchNorm_0` and
        `layer{s}_*` for s in 1..n; mmdet ResNet._freeze_stages)."""
        if n < 1:
            return ()
        return ("conv1", "bn1") + tuple(
            f"layers.{s}" for s in range(min(n, len(self.layers))))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        outs = []
        for blocks in self.layers:
            x = blocks(x)
            outs.append(x)
        return tuple(outs)
