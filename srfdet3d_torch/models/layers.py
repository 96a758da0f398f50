"""Shared layers: masked batch norm and the conv + BN + ReLU block.

BatchNorm everywhere uses the reference's eps=1e-3 and momentum=0.01.  The
port runs predict, so BN normalizes with its running statistics; the masked
statistics of train mode (padding rows excluded) are kept for the sparse
encoder's layers, whose rows are capacity-padded.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class MaskedBatchNorm(nn.Module):
    """BatchNorm over all leading axes of (..., C) with an optional validity
    mask (...,): train-mode statistics are taken over mask==True rows."""

    def __init__(self, channels: int, momentum: float = 0.01,
                 eps: float = 1e-3):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        xf = x.float()
        if self.training:
            red = tuple(range(x.ndim - 1))
            if mask is not None:
                m = mask.float()[..., None]
                n = m.sum().clamp_min(1.0)
                mean = (xf * m).sum(red) / n
                var = (m * (xf - mean) ** 2).sum(red) / n
            else:
                n = torch.tensor(float(xf[..., 0].numel()), device=x.device)
                mean = xf.mean(red)
                var = ((xf - mean) ** 2).mean(red)
            with torch.no_grad():
                var_u = var * (n / (n - 1.0).clamp_min(1.0))
                self.running_mean.mul_(1 - self.momentum).add_(
                    self.momentum * mean)
                self.running_var.mul_(1 - self.momentum).add_(
                    self.momentum * var_u)
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)


class ConvBNReLU(nn.Module):
    """Conv2d (no bias) + BatchNorm2d + ReLU on NCHW tensors."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 padding: int = 1, groups: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding,
                              groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3, momentum=0.01)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))
