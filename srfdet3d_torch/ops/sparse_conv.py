"""Sparse-conv apply over a batched rulebook, and the dense scatter."""

from __future__ import annotations

from typing import Tuple

import torch

from .gather_conv import gather_conv


def gathered_conv_apply_batched(features: torch.Tensor,
                                gather_idx: torch.Tensor,
                                weights: torch.Tensor) -> torch.Tensor:
    """features (B, V, Cin), gather_idx (B, M, K) int32 GLOBAL flat rows
    (B * V is the miss row), weights (K, Cin, Cout) -> (B, M, Cout)."""
    b, v, cin = features.shape
    _, m, k = gather_idx.shape
    out = gather_conv(features.reshape(b * v, cin).contiguous(),
                      gather_idx.reshape(b * m, k).contiguous(),
                      weights.contiguous())
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
