"""SECOND dense BEV backbone (reference second_custom.py:11-91), NCHW."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from .layers import ConvBNReLU


class SECOND(nn.Module):
    """Stages of [stride conv + N x conv]-BN-ReLU; returns every stage's
    output.  `blocks` holds the convs in run order (the JAX package's
    ConvBNReLU_0, ConvBNReLU_1, ...)."""

    def __init__(self, in_channels: int,
                 out_channels: Sequence[int] = (128, 128, 256),
                 layer_nums: Sequence[int] = (3, 5, 5),
                 layer_strides: Sequence[int] = (2, 2, 2)):
        super().__init__()
        self.blocks = nn.ModuleList()
        self.stage_ends = []
        cin = in_channels
        for cout, n, stride in zip(out_channels, layer_nums, layer_strides):
            self.blocks.append(ConvBNReLU(cin, cout, 3, stride, 1))
            for _ in range(n):
                self.blocks.append(ConvBNReLU(cout, cout, 3, 1, 1))
            self.stage_ends.append(len(self.blocks))
            cin = cout

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        outs = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i + 1 in self.stage_ends:
                outs.append(x)
        return tuple(outs)
