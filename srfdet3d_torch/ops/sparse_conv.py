"""Sparse-conv apply over a batched rulebook, and the dense scatter."""

from __future__ import annotations

from typing import Tuple

import torch

from .gather_conv import gather_conv
from .gather_conv_bwd import strided_conv_bwd, subm_conv_bwd


class GatheredConv(torch.autograd.Function):
    """The gather-GEMM with its backward: the forward is K1; the backward
    is K3 for a subm rulebook (symmetric, M == N) and K4 otherwise, as the
    JAX package's `_onehot_conv_subm` / `_onehot_conv` custom VJPs pick
    them.  The kernels' outputs carry no graph of their own, so this
    Function is what gives the encoder's weights their gradients."""

    @staticmethod
    def forward(ctx, feats, idx, weights, subm: bool):
        ctx.save_for_backward(feats, idx, weights)
        ctx.subm = subm
        return gather_conv(feats, idx, weights)

    @staticmethod
    def backward(ctx, g):
        feats, idx, weights = ctx.saved_tensors
        bwd = subm_conv_bwd if ctx.subm else strided_conv_bwd
        dfeats, dw = bwd(feats, idx, weights, g.contiguous(),
                         need_dfeats=ctx.needs_input_grad[0])
        return dfeats, None, dw, None


def gathered_conv_apply_batched(features: torch.Tensor,
                                gather_idx: torch.Tensor,
                                weights: torch.Tensor,
                                subm: bool = False) -> torch.Tensor:
    """features (B, V, Cin), gather_idx (B, M, K) int32 GLOBAL flat rows
    (B * V is the miss row), weights (K, Cin, Cout) -> (B, M, Cout).

    subm: the rulebook is a submanifold one (M == V, symmetric neighbour
    relation), which selects the symmetric backward."""
    b, v, cin = features.shape
    _, m, k = gather_idx.shape
    out = GatheredConv.apply(features.reshape(b * v, cin).contiguous(),
                             gather_idx.reshape(b * m, k).contiguous(),
                             weights.contiguous(), subm and m == v)
    return out.reshape(b, m, -1)


def sparse_to_dense_batched(features: torch.Tensor, coords: torch.Tensor,
                            mask: torch.Tensor,
                            shape: Tuple[int, int, int]) -> torch.Tensor:
    """(B, V, C) sites at (B, V, 3) zyx coords -> (B, D, H, W, C) canvas."""
    d, h, w = shape
    b, v, c = features.shape
    cells = d * h * w
    flat = (coords[..., 0] * h + coords[..., 1]) * w + coords[..., 2]
    offs = torch.arange(b, device=features.device)[:, None] * cells
    flat = torch.where(mask, flat + offs, b * cells)
    canvas = features.new_zeros(b * cells + 1, c)
    canvas[flat.reshape(-1)] = features.reshape(-1, c)
    return canvas[:-1].reshape(b, d, h, w, c)
