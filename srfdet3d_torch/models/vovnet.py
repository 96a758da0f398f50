"""VoVNetV2 (eSE) image backbone, NCHW (JAX `models/vovnet.py`).

A stem of three 3x3 convs (strides 2, 1, 2), then four stages of
one-shot-aggregation (OSA) blocks; stages 3-5 start with a 3x3 stride-2 max
pool.  An OSA block runs `layer_per_block` 3x3 convs in a chain, joins its
input and every conv's output along the channels, projects them with one
1x1 conv + BN + ReLU, weights the channels by effective squeeze-excitation
(eSE), and adds its input back after the stage's first block.  Returns the
four stage outputs (strides 4, 8, 16, 32).  BN uses eps 1e-5; predict
normalizes with the running statistics.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, conv_bn

# the public VoVNetV2 architecture constants
VOVNET_SPECS = {
    "vovnet-19-slim": dict(stem=(64, 64, 128), conv_ch=(64, 80, 96, 112),
                           out_ch=(112, 256, 384, 512), layer_per_block=3,
                           block_per_stage=(1, 1, 1, 1)),
    "vovnet-19": dict(stem=(64, 64, 128), conv_ch=(128, 160, 192, 224),
                      out_ch=(256, 512, 768, 1024), layer_per_block=3,
                      block_per_stage=(1, 1, 1, 1)),
    "vovnet-39": dict(stem=(64, 64, 128), conv_ch=(128, 160, 192, 224),
                      out_ch=(256, 512, 768, 1024), layer_per_block=5,
                      block_per_stage=(1, 1, 2, 2)),
    "vovnet-57": dict(stem=(64, 64, 128), conv_ch=(128, 160, 192, 224),
                      out_ch=(256, 512, 768, 1024), layer_per_block=5,
                      block_per_stage=(1, 1, 4, 3)),
    "vovnet-99": dict(stem=(64, 64, 128), conv_ch=(128, 160, 192, 224),
                      out_ch=(256, 512, 768, 1024), layer_per_block=5,
                      block_per_stage=(1, 3, 9, 3)),
}


def max_pool_pad_end(x: torch.Tensor) -> torch.Tensor:
    """flax max_pool((3, 3), strides (2, 2), padding [(0, 1), (0, 1)]):
    one -inf row at the bottom and one -inf column at the right only."""
    return F.max_pool2d(F.pad(x, (0, 1, 0, 1), value=float("-inf")), 3, 2)


class ESE(nn.Module):
    """Effective squeeze-excitation: the spatial mean, a 1x1 conv with
    bias, a hard sigmoid clip(s + 3, 0, 6) / 6, then x * s."""

    def __init__(self, channels: int):
        super().__init__()
        self.fc = Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.fc(x.mean((2, 3), keepdim=True))
        return x * ((s + 3.0).clamp(0.0, 6.0) / 6.0)


class OSABlock(nn.Module):
    def __init__(self, cin: int, conv_ch: int, out_ch: int,
                 layer_per_block: int, identity: bool = False):
        super().__init__()
        self.identity = identity
        self.convs = nn.ModuleList(
            conv_bn(cin if i == 0 else conv_ch, conv_ch)
            for i in range(layer_per_block))
        # the JAX package sums per-feature projections (a TPU layout
        # choice); one 1x1 conv over the joined features is the same sum,
        # with the kernel's input channels in the join's order
        self.concat = conv_bn(cin + layer_per_block * conv_ch, out_ch, 1)
        self.ese = ESE(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = [x]
        y = x
        for conv in self.convs:
            y = conv(y)
            feats.append(y)
        y = self.ese(self.concat(torch.cat(feats, 1)))
        return y + x if self.identity else y


class VoVNet(nn.Module):
    """forward((N, 3, H, W)) -> the four stage outputs, strides 4-32."""

    def __init__(self, spec_name: str = "vovnet-99"):
        super().__init__()
        spec = VOVNET_SPECS[spec_name]
        s1, s2, s3 = spec["stem"]
        self.stem1 = conv_bn(3, s1, stride=2)
        self.stem2 = conv_bn(s1, s2)
        self.stem3 = conv_bn(s2, s3, stride=2)
        self.out_channels = tuple(spec["out_ch"])
        cin = s3
        self.stages = nn.ModuleList()
        for stage in range(4):
            blocks = nn.Sequential()
            for b in range(spec["block_per_stage"][stage]):
                blocks.append(OSABlock(cin, spec["conv_ch"][stage],
                                       spec["out_ch"][stage],
                                       spec["layer_per_block"],
                                       identity=b > 0))
                cin = spec["out_ch"][stage]
            self.stages.append(blocks)

    def frozen_stage_modules(self, n: int) -> Tuple[str, ...]:
        """The submodules that frozen_stages = n freezes: the stem and the
        first n stages (JAX `stem*` and `stage{s + 1}_*` for s in 1..n;
        reference vovnet.py:353-364)."""
        if n < 1:
            return ()
        return ("stem1", "stem2", "stem3") + tuple(
            f"stages.{s}" for s in range(min(n, len(self.stages))))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = self.stem3(self.stem2(self.stem1(x)))
        outs = []
        for stage, blocks in enumerate(self.stages):
            if stage > 0:
                x = max_pool_pad_end(x)
            x = blocks(x)
            outs.append(x)
        return tuple(outs)
