"""Shared layers: masked batch norm and the conv + BN + ReLU block.

BatchNorm everywhere uses the reference's eps=1e-3 and momentum=0.01.  In
eval mode BN normalizes with its running statistics; in train mode with the
batch's, and updates the running ones as the JAX package does: the sparse
encoder's masked BN (padding rows excluded) stores the unbiased variance,
the dense convs' flax BatchNorm the biased one.
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


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d whose train-mode update stores the BIASED batch variance
    in running_var, as flax's nn.BatchNorm does (torch's stores the
    unbiased one).  Normalization itself is torch's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(m * mean)
            self.running_var.mul_(1 - m).add_(m * var)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)


class ConvBNReLU(nn.Module):
    """Conv2d + BatchNorm2d + ReLU on NCHW tensors (flax's ConvBNReLU of the
    JAX package).  `bn=False` leaves the conv alone (with `bias`, the image
    FPN's plain convs); `eps` and `momentum` are the BN's (1e-5 and 0.1 in
    the image backbones)."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 padding: int = 1, groups: int = 1, *, bias: bool = False,
                 bn: bool = True, relu: bool = True, eps: float = 1e-3,
                 momentum: float = 0.01):
        super().__init__()
        self.relu = relu
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding,
                              groups=groups, bias=bias)
        self.bn = (BatchNorm2d(cout, eps=eps, momentum=momentum) if bn
                   else nn.Identity())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(x))
        return F.relu(x) if self.relu else x


def conv_bn(cin: int, cout: int, kernel: int = 3, stride: int = 1,
            relu: bool = True) -> ConvBNReLU:
    """The image backbones' conv (no bias, padding kernel // 2) + BN (eps
    1e-5, flax momentum 0.9) + optional ReLU."""
    return ConvBNReLU(cin, cout, kernel, stride, kernel // 2, relu=relu,
                      eps=1e-5, momentum=0.1)
