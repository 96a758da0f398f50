"""Modulated deformable convolution (DCNv2), plain PyTorch (JAX
`models/deform_conv.py`).

A regular conv at the deformable conv's stride predicts, for every output
pixel, a (dy, dx) offset and a modulation logit per kernel tap; each tap is
a bilinear sample of the input at (base grid + tap + offset), scaled by the
sigmoid of its logit, and the taps contract with the kernel as one
(kk*Cin, Cout) product.  The offset conv's 3*kk output channels hold the
offsets interleaved per tap, (dy_0, dx_0, dy_1, dx_1, ...), then the kk
logits; it starts at zero, so the layer starts as a plain conv scaled by
sigmoid(0) = 0.5.  The kernel is tap-major with Cin minor.  Each bilinear
corner outside the input reads zero on its own.  The backward is autograd
over the gathers and the product (held against JAX's autodiff).

In bfloat16 (the layer's `dtype`) the offset conv runs in bfloat16 and its
output is upcast; the base grid is built in the input's dtype, as the JAX
package builds it: bfloat16 holds its integers exactly up to 256, and no
shipped map passes that (Waymo LC's DCN stages see 40 x 60 and 20 x 30
maps).  The bilinear weights are float32, so the sampled taps and the
product promote to float32 against the bfloat16 kernel; the output is
rounded to the input's dtype once.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..utils import profiling
from .layers import Conv2d


def modulated_deform_conv(x: torch.Tensor, weight: torch.Tensor,
                          offset: torch.Tensor, mask: torch.Tensor,
                          kernel: int = 3, stride: int = 1,
                          padding: int = 1) -> torch.Tensor:
    """x (B, H, W, Cin); weight (kk*Cin, Cout); offset (B, Ho, Wo, kk, 2)
    as (dy, dx); mask (B, Ho, Wo, kk) -> (B, Ho, Wo, Cout)."""
    b, h, w, c = x.shape
    kk = kernel * kernel
    ho, wo = offset.shape[1], offset.shape[2]
    dev, dt = x.device, x.dtype
    base_y = torch.arange(ho, device=dev, dtype=dt) * stride - padding
    base_x = torch.arange(wo, device=dev, dtype=dt) * stride - padding
    tap_dy = torch.as_tensor(np.repeat(np.arange(kernel), kernel), dtype=dt,
                             device=dev)
    tap_dx = torch.as_tensor(np.tile(np.arange(kernel), kernel), dtype=dt,
                             device=dev)
    # on a card each copy from host memory waits for the stream
    profiling.count("host_sync", 2)
    py = base_y[None, :, None, None] + tap_dy + offset[..., 0]
    px = base_x[None, None, :, None] + tap_dx + offset[..., 1]

    flat = torch.cat([x.reshape(b * h * w, c), x.new_zeros(1, c)])
    pad_row = b * h * w
    boff = (torch.arange(b, device=dev) * (h * w))[:, None, None, None]
    y0, x0 = torch.floor(py), torch.floor(px)
    ly, lx = py - y0, px - x0

    def tap(yy, xx):
        ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        idx = torch.where(ok, boff + yy.long() * w + xx.long(), pad_row)
        # index_select, not flat[idx]: the same rows, and its backward is
        # an index_add_ where advanced indexing's sorts the indices first
        return flat.index_select(0, idx.reshape(-1)).reshape(
            idx.shape + (c,))                           # (B, Ho, Wo, kk, C)

    s = (tap(y0, x0) * ((1 - ly) * (1 - lx))[..., None] +
         tap(y0, x0 + 1) * ((1 - ly) * lx)[..., None] +
         tap(y0 + 1, x0) * (ly * (1 - lx))[..., None] +
         tap(y0 + 1, x0 + 1) * (ly * lx)[..., None])
    s = s * mask[..., None]
    out = s.reshape(b * ho * wo, kk * c).matmul(weight.to(s.dtype))
    return out.reshape(b, ho, wo, -1).to(dt)


class ModulatedDeformConv(nn.Module):
    """DCNv2 layer on NCHW (deform_groups 1, no bias: a norm follows)."""

    dtype = torch.float32

    def __init__(self, cin: int, cout: int, kernel: int = 3,
                 stride: int = 1, padding: int = 1):
        super().__init__()
        self.k, self.stride, self.padding = kernel, stride, padding
        kk = kernel * kernel
        self.conv_offset = Conv2d(cin, 3 * kk, kernel, stride, padding)
        self.kernel = nn.Parameter(torch.zeros(kk * cin, cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kk = self.k * self.k
        off = self.conv_offset(x).float().permute(0, 2, 3, 1)  # (B,Ho,Wo,3kk)
        offset = off[..., :2 * kk].reshape(off.shape[:-1] + (kk, 2))
        mask = torch.sigmoid(off[..., 2 * kk:])
        out = modulated_deform_conv(
            x.permute(0, 2, 3, 1), self.kernel.to(self.dtype), offset, mask,
            self.k, self.stride, self.padding)
        return out.permute(0, 3, 1, 2).contiguous()
