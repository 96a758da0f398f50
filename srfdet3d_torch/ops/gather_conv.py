"""Sparse-conv gather-GEMM: the gather_conv kernel (K1) and its plain version.

Replaces the JAX package's Pallas kernel
`ops/pallas_onehot.py::gather_matmul_onehot` (kernel body `_kernel`):

    out[m] = sum_j feats[idx[m, j]] @ W[j]

with feats (N, Cin), idx (M, K) int32 in [0, N] (index N is a miss that
reads zeros) and W (K, Cin, Cout).  The plain version is the JAX package's
XLA path: append a zero row, gather, one (M, K*Cin) x (K*Cin, Cout) matmul.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

# kernel launches since the last reset (chip_smoke.py reads it)
launches = 0

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# feats, idx, W, out, N, M, K, Cin, Cout, stream
_SIGNATURES = {"gather_conv_f32": [_P, _P, _P, _P, _I, _LL, _I, _I, _I, _P]}


def gather_conv_plain(feats: torch.Tensor, idx: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (N, Cin), (M, K), (K, Cin, Cout) -> (M, Cout)."""
    n, cin = feats.shape
    m, k = idx.shape
    table = torch.cat([feats, feats.new_zeros(1, cin)])
    g = table[idx.long()].reshape(m, k * cin)
    return g @ weights.reshape(k * cin, -1).to(feats.dtype)


def gather_conv(feats: torch.Tensor, idx: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    """The gather-GEMM: the CUDA kernel for tensors on the card, the plain
    version for tensors on the CPU."""
    if feats.device.type == "cpu":
        return gather_conv_plain(feats, idx, weights)
    if feats.device.type != "cuda":
        raise RuntimeError(f"gather_conv: no kernel for {feats.device}")
    global launches
    n, cin = feats.shape
    m, k = idx.shape
    dev = feats.device
    if feats.dtype != torch.float32 or weights.dtype != torch.float32:
        raise ValueError("gather_conv: the kernel takes float32 feats and W")
    if idx.dtype != torch.int32:
        raise ValueError("gather_conv: idx must be int32")
    if weights.dim() != 3 or weights.shape[:2] != (k, cin):
        raise ValueError(f"gather_conv: W must be ({k}, {cin}, Cout), got "
                         f"{tuple(weights.shape)}")
    if idx.device != dev or weights.device != dev:
        raise ValueError("gather_conv: feats, idx and W must share a device")
    for name, t in (("feats", feats), ("idx", idx), ("W", weights)):
        if not t.is_contiguous():
            raise ValueError(f"gather_conv: {name} must be contiguous")
    if n >= 2 ** 31:
        raise ValueError("gather_conv: N must fit int32")
    if not 1 <= k <= 32:
        raise ValueError(f"gather_conv: the kernel takes 1 to 32 offsets, "
                         f"got K = {k}")
    cout = weights.shape[2]
    out = torch.empty(m, cout, dtype=torch.float32, device=dev)
    lib = cuda_build.load_library("gather_conv", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gather_conv_f32(feats.data_ptr(), idx.data_ptr(),
                                 weights.data_ptr(), out.data_ptr(), n, m, k,
                                 cin, cout, stream)
    cuda_build.check(lib, rc, "gather_conv")
    launches += 1
    return out
