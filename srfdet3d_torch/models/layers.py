"""Shared layers: masked batch norm and the conv + BN + ReLU block.

BatchNorm everywhere uses the reference's eps=1e-3 and momentum=0.01.  In
eval mode BN normalizes with its running statistics; in train mode with the
batch's, and updates the running ones as the JAX package does: the sparse
encoder's masked BN (padding rows excluded) stores the unbiased variance,
the dense convs' flax BatchNorm the biased one.

Under a process group (`parallel.mesh`) the train-mode statistics span
every rank's batch of the data group (the whole world without a 2-D
mesh; the model ranks of one data index hold the same rows), with their
gradient, as the JAX package's shard_map
step computes them (`psum_if_sync` in MaskedBatchNorm, flax's
`axis_name` in ConvBNReLU) and the reference's SyncBN: MaskedBatchNorm
sums the count and the sums in one collective, then the squares centred on
the global mean in a second; BatchNorm2d averages each rank's mean and
mean of squares over the ranks (flax's fast variance), and its backward
sums the gradient's two reductions over the ranks.  Without a group no
collective is issued.

Compute dtype (the JAX package's `compute_dtype`): every module has a
`dtype`, float32 unless `set_dtype` sets it, with flax's meaning of a
layer's `dtype=`.  Parameters and BN statistics stay float32; the input and
the weight are cast to `dtype` at use, the op computes in it and returns
it.  `Linear` and `Conv2d` add their bias in `dtype` after the product is
rounded, as flax does; `LayerNorm` and the BatchNorms take float32
statistics of the upcast input and round their output once.  In float32
each layer is its torch counterpart, unchanged.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ..parallel import mesh
from ..utils import profiling


def set_dtype(module: nn.Module, dtype: torch.dtype) -> None:
    """Set the compute dtype of `module` and of every module under it."""
    for mod in module.modules():
        mod.dtype = dtype


class Linear(nn.Linear):
    """flax nn.Dense: in `dtype` the input and the weight are cast, the
    product is rounded to `dtype`, then the bias (cast) is added."""

    dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        if dt == torch.float32:
            return super().forward(x.to(dt))
        y = F.linear(x.to(dt), self.weight.to(dt))
        return y if self.bias is None else y + self.bias.to(dt)


class Conv2d(nn.Conv2d):
    """flax nn.Conv on NCHW, with Linear's rounding points."""

    dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        if dt == torch.float32:
            return super().forward(x.to(dt))
        y = self._conv_forward(x.to(dt), self.weight.to(dt), None)
        return (y if self.bias is None
                else y + self.bias.to(dt)[:, None, None])


class LayerNorm(nn.LayerNorm):
    """flax nn.LayerNorm: float32 statistics and normalization of the
    upcast input, the output rounded to `dtype`."""

    dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float()).to(self.dtype)


def softmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """jax.nn.softmax along `dim`: torch's in float32; in a narrower dtype
    its rounding points, x - max, the exp, the (float32-accumulated) sum
    and the quotient each rounded to x's dtype."""
    if x.dtype == torch.float32:
        return torch.softmax(x, dim)
    e = torch.exp(x - x.amax(dim, keepdim=True))
    return e / e.sum(dim, keepdim=True)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator],
            shape: Optional[Sequence[int]] = None,
            block: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """flax's nn.Dropout: keep with probability 1 - rate, scale kept values
    by 1 / (1 - rate).  `shape` draws a mask that broadcasts over x.  The
    draws are float32 whatever x's dtype; a bfloat16 x is scaled in it.
    `block` (axis, start, length): the mask is drawn whole at `shape` and
    narrowed to that block of the axis (a model rank's proposals), so the
    generator advances as for the whole tensor."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode needs a torch.Generator")
    keep_prob = 1.0 - rate
    u = torch.rand(tuple(shape or x.shape), generator=generator,
                   device=x.device)
    if block is not None:
        u = u.narrow(*block)
    return torch.where(u < keep_prob, x / keep_prob, 0.0)


class MaskedBatchNorm(nn.Module):
    """BatchNorm over all leading axes of (..., C) with an optional validity
    mask (...,): train-mode statistics are taken over mask==True rows, in
    float32 from the upcast input; the output is `dtype`."""

    dtype = torch.float32

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
            mean, var, n = self._batch_stats(xf, mask)
            self._update_running(mean, var, n)
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(self.dtype)

    @staticmethod
    def _batch_stats(xf: torch.Tensor, mask: Optional[torch.Tensor]):
        """(mean, biased var, count) over the valid rows: the count and the
        sums, then the squares centred on the mean (JAX `layers.py:48-66`).
        Under a group both sums span every rank, each in one collective."""
        red = tuple(range(xf.ndim - 1))
        if mask is not None:
            m = mask.float()[..., None]
            count, total = m.sum(), (xf * m).sum(red)
        else:
            m = None
            count = torch.tensor(float(xf[..., 0].numel()), device=xf.device)
            # on a card the copy from host memory waits for the stream
            profiling.count("host_sync")
            total = xf.sum(red)
        stats = mesh.all_reduce_sum(torch.cat([count.reshape(1), total]))
        n = stats[0].clamp_min(1.0)
        mean = stats[1:] / n
        sq = (xf - mean) ** 2
        var = mesh.all_reduce_sum((sq if m is None else m * sq).sum(red)) / n
        return mean, var, n

    @torch.no_grad()
    def _update_running(self, mean: torch.Tensor, var: torch.Tensor,
                        n: torch.Tensor) -> None:
        var_u = var * (n / (n - 1.0).clamp_min(1.0))
        self.running_mean.mul_(1 - self.momentum).add_(self.momentum * mean)
        self.running_var.mul_(1 - self.momentum).add_(self.momentum * var_u)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d whose train-mode update stores the BIASED batch variance
    in running_var, as flax's nn.BatchNorm does (torch's stores the
    unbiased one).  Normalization itself is torch's, which takes a bfloat16
    input beside the float32 parameters, computes in float32 and returns
    the input's dtype; the batch statistics are float32, of the upcast
    input."""

    dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if not self.training:
            return super().forward(x)
        if mesh.active():
            y, mean, var = _SyncedBatchNorm2d.apply(x, self.weight,
                                                    self.bias, self.eps)
        else:
            y = F.batch_norm(x, None, None, self.weight, self.bias, True,
                             0.0, self.eps)
            with torch.no_grad():
                var, mean = torch.var_mean(x.float(), dim=(0, 2, 3),
                                           unbiased=False)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(m * mean)
            self.running_var.mul_(1 - m).add_(m * var)
            self.num_batches_tracked.add_(1)
        return y


class _SyncedBatchNorm2d(torch.autograd.Function):
    """Train-mode BatchNorm2d under a group: flax's nn.BatchNorm with
    axis_name (ranks' local shapes are equal): the ranks' mean of each
    rank's mean and mean of squares, in one collective, var = max(mean of
    squares - mean^2, 0); the normalization is one batch_norm call on
    those statistics.  The backward sums the two per-channel reductions of
    the incoming gradient over the ranks in one collective (the
    statistics' gradient, reference SyncBN), and keeps only x and the
    statistics for it.  A bfloat16 x takes float32 statistics and
    gradient sums; its dx is rounded to bfloat16 once."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        var_l, mean_l = torch.var_mean(x.float(), dim=(0, 2, 3),
                                       unbiased=False)
        stats = torch.stack([mean_l, var_l + mean_l * mean_l])
        dist.all_reduce(stats, group=mesh.data_group())
        mean, mean2 = stats / mesh.data_size()
        var = (mean2 - mean * mean).clamp_min(0.0)
        invstd = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, weight, mean, invstd)
        ctx.mark_non_differentiable(mean, var)
        y = F.batch_norm(x, mean, var, weight, bias, False, 0.0, eps)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd = ctx.saved_tensors
        shape = (1, -1, 1, 1)
        dy = dy.float()
        xhat = (x.float() - mean.view(shape)) * invstd.view(shape)
        local = torch.stack([dy.sum((0, 2, 3)), (dy * xhat).sum((0, 2, 3))])
        sums = local.clone()
        dist.all_reduce(sums, group=mesh.data_group())
        n = x.numel() // x.shape[1] * mesh.data_size()
        dx = (weight * invstd).view(shape) * (
            dy - (sums[0] / n).view(shape) - xhat * (sums[1] / n).view(shape))
        return dx.to(x.dtype), local[1], local[0], None


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
        self.conv = Conv2d(cin, cout, kernel, stride, padding,
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
