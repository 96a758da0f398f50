"""Sparse-conv gather-GEMM: the gather_conv kernel (K1) and its plain version.

Replaces the JAX package's Pallas kernel
`ops/pallas_onehot.py::gather_matmul_onehot` (kernel body `_kernel`):

    out[m] = sum_j feats[idx[m, j]] @ W[j]

with feats (N, Cin), idx (M, K) int32 in [0, N] (index N is a miss that
reads zeros) and W (K, Cin, Cout).  The plain version is the JAX package's
XLA path: append a zero row, gather, one (M, K*Cin) x (K*Cin, Cout) matmul.

feats and W are both float32 (the 3xTF32 kernel) or both bfloat16 (the bf16
kernel; the bf16 model, JAX `pallas_onehot.py:114-118`): the bf16 output is
the float32 sum of the exact bf16 products, rounded once, in the kernel
and in the plain version alike (JAX's `preferred_element_type=float32`,
then `.astype`).
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

# kernel launches since the last reset, the float32 kernel's and the bf16
# kernel's (chip_smoke.py reads them)
launches = 0
bf16_launches = 0

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# feats, idx, W (bf16: Wt (K, Cout, Cin)), out, N, M, K, Cin, Cout, stream
_SIGNATURES = {"gather_conv_f32": [_P, _P, _P, _P, _I, _LL, _I, _I, _I, _P],
               "gather_conv_bf16": [_P, _P, _P, _P, _I, _LL, _I, _I, _I, _P]}
DTYPES = (torch.float32, torch.bfloat16)


def check_dtypes(name: str, *tensors: torch.Tensor) -> torch.dtype:
    """The one dtype of the float tensors: float32 or bfloat16, not mixed."""
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or not dtypes <= set(DTYPES):
        raise ValueError(f"{name}: the kernels take float32 or bfloat16 "
                         f"tensors of one dtype, got "
                         f"{sorted(str(d) for d in dtypes)}")
    return dtypes.pop()


def pad_channels(x: torch.Tensor, dim: int, multiple: int = 8
                 ) -> torch.Tensor:
    """x with zeros appended along `dim` to a multiple of `multiple`
    channels, contiguous (the bf16 kernels' 16-byte row copies)."""
    pad = -x.shape[dim] % multiple
    if pad:
        shape = list(x.shape)
        shape[dim] = pad
        x = torch.cat([x, x.new_zeros(shape)], dim)
    return x.contiguous()


def gather_conv_plain(feats: torch.Tensor, idx: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (N, Cin), (M, K), (K, Cin, Cout) -> (M, Cout)
    in feats' dtype; below float32, a float32 product rounded once."""
    n, cin = feats.shape
    m, k = idx.shape
    table = torch.cat([feats, feats.new_zeros(1, cin)])
    g = table[idx.long()].reshape(m, k * cin)
    w = weights.reshape(k * cin, -1).to(feats.dtype)
    if feats.dtype == torch.float32:
        return g @ w
    return (g.float() @ w.float()).to(feats.dtype)


def gather_conv(feats: torch.Tensor, idx: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    """The gather-GEMM: the CUDA kernel for tensors on the card, the plain
    version for tensors on the CPU.  feats and W: float32 (the 3xTF32
    kernel) or bfloat16 (the bf16 kernel), one dtype for both; the output
    has it."""
    dtype = check_dtypes("gather_conv", feats, weights)
    if feats.device.type == "cpu":
        return gather_conv_plain(feats, idx, weights)
    if feats.device.type != "cuda":
        raise RuntimeError(f"gather_conv: no kernel for {feats.device}")
    global launches, bf16_launches
    n, cin = feats.shape
    m, k = idx.shape
    dev = feats.device
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
    out = torch.empty(m, cout, dtype=dtype, device=dev)
    lib = cuda_build.load_library("gather_conv", _SIGNATURES)
    if dtype == torch.float32:
        entry, table, w = lib.gather_conv_f32, feats, weights
    else:
        # Cin padded to a multiple of 8 (zeros: they add nothing), W
        # transposed to (K, Cout, Cin) for the kernel's B operand
        entry, table = lib.gather_conv_bf16, pad_channels(feats, 1)
        w = pad_channels(weights.transpose(1, 2), 2)
        cin = table.shape[1]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = entry(table.data_ptr(), idx.data_ptr(), w.data_ptr(),
                   out.data_ptr(), n, m, k, cin, cout, stream)
    cuda_build.check(lib, rc, "gather_conv")
    if dtype == torch.float32:
        launches += 1
    else:
        bf16_launches += 1
    return out
