"""The sparse-conv gather-GEMM in plain PyTorch (the port's K1 and, by
autograd, its backward K3 / K4):

    out[m] = sum_j feats[idx[m, j]] @ W[j]

with feats (N, Cin), idx (M, K) int32 in [0, N] (index N is a miss that
reads zeros) and W (K, Cin, Cout): append a zero row, gather, one
(M, K*Cin) x (K*Cin, Cout) matmul."""

from __future__ import annotations

import torch


def gather_conv_plain(feats: torch.Tensor, idx: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    n, cin = feats.shape
    m, k = idx.shape
    table = torch.cat([feats, feats.new_zeros(1, cin)])
    g = torch.index_select(table, 0, idx.reshape(-1).long()).reshape(
        m, k * cin)
    return g @ weights.reshape(k * cin, -1).to(feats.dtype)


gather_conv = gather_conv_plain
