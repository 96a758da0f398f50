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

The wrapper calls the registered op `srfdet::gather_conv` (one op for both
dtypes): its CPU implementation is the plain version, its CUDA one the
launch, and its fake gives the (M, Cout) output to `torch.export`, so an
exported program keeps the kernel as one node.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

# kernel launches since the last reset, the float32 kernel's and the bf16
# kernel's, counted by the op's CUDA implementation, in eager and in an
# exported program alike (chip_smoke.py reads them)
launches = 0
bf16_launches = 0

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# feats, idx, W (K, Cin, Cout), out, N, M, K, Cin, Cout, stream
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
    channels, contiguous (the bf16 kernels' 16-byte row copies and the
    weights' tensor map); x itself where it needs none and is
    contiguous."""
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
    version for tensors on the CPU, through the op `srfdet::gather_conv`
    (so a traced program calls it as one node).  feats and W: float32 (the
    3xTF32 kernel) or bfloat16 (the bf16 kernel), one dtype for both; the
    output has it."""
    check_dtypes("gather_conv", feats, weights)
    cuda_build.check_device("gather_conv", feats.device)
    return gather_conv_op(feats, idx, weights)


@torch.library.custom_op("srfdet::gather_conv", mutates_args=(),
                         device_types="cpu")
def gather_conv_op(feats: torch.Tensor, idx: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """The op's CPU implementation: the plain version."""
    return gather_conv_plain(feats, idx, weights)


@gather_conv_op.register_fake
def _gather_conv_fake(feats, idx, weights):
    return feats.new_empty(idx.shape[0], weights.shape[2])


@gather_conv_op.register_kernel("cuda")
def _gather_conv_cuda(feats: torch.Tensor, idx: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """The op's CUDA implementation: checks the arguments, launches the
    float32 or the bf16 kernel and counts the launch."""
    global launches, bf16_launches
    dtype = check_dtypes("gather_conv", feats, weights)
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
    lib = cuda_build.load_library("gather_conv", _SIGNATURES)
    if dtype == torch.float32:
        entry, w = lib.gather_conv_f32, weights
    else:
        # W read as it is, (K, Cin, Cout), by the kernel's tensor map, which
        # needs Cout % 8 == 0: other widths are padded with zero columns
        # and cut back (no shipped config has one); any Cin
        entry, w = lib.gather_conv_bf16, pad_channels(weights, 2)
    out = torch.empty(m, w.shape[2], dtype=dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = entry(feats.data_ptr(), idx.data_ptr(), w.data_ptr(),
                   out.data_ptr(), n, m, k, cin, w.shape[2], stream)
    cuda_build.check(lib, rc, "gather_conv")
    if dtype == torch.float32:
        launches += 1
    else:
        bf16_launches += 1
    return out if out.shape[1] == cout else out[:, :cout].contiguous()
