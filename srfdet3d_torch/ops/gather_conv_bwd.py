"""Sparse-conv gather-GEMM backward: the K3 (subm) and K4 (strided) kernels
and their plain versions.

The forward is out[m] = sum_j feats[idx[m, j]] @ W[j] (ops/gather_conv.py).
Its backward needs dfeats (a scatter-add of g[m] @ W[j]^T at idx[m, j]) and
dW[j] = sum_m feats[idx[m, j]]^T g[m].  Both become a gather over a rulebook
that maps each input row to the output rows that read it
(csrc/gather_conv_bwd.cu):

- subm rulebooks (M == N) are symmetric, idx[m, j] = r <=> idx[r, K-1-j] = m,
  so the forward rulebook itself serves, with the offsets flipped
  (`subm_conv_bwd`, K3; replaces the JAX package's Pallas kernel
  `ops/pallas_onehot_bwd.py::gather_matmul_onehot_symbwd`);
- strided and conv_out rulebooks are transposed first:
  rev[r, j] = the unique m with idx[m, j] == r (a fixed offset maps each
  input cell to at most one output cell), else the miss M
  (`strided_conv_bwd`, K4; replaces `gather_matmul_onehot_bwd`).

Each wrapper runs its plain version for tensors on the CPU and the kernel,
or raises, for tensors on the card.  The plain versions are the JAX
package's CPU formulas: the symmetric gather (`ops/sparse_conv.py:753-765`)
and the autodiff gather + scatter-add (`:689-703`).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import cuda_build

# kernel launches since the last reset, one per backward (chip_smoke.py)
subm_launches = 0
strided_launches = 0

# rows of the input a dW block compacts and sums before its partial is
# written (the kernel takes at most 4096)
DW_CHUNK = 1024

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    # g, rb, wt, dfeats, M, N, K, Cout, Cin, stream
    "conv_bwd_dfeats_f32": [_P, _P, _P, _P, _I, _LL, _I, _I, _I, _P],
    # feats, rb, g, part, dW, N, M, K, Cin, Cout, chunk, flip, stream
    "conv_bwd_dw_f32": [_P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _I,
                        _P],
}

Grads = Tuple[Optional[torch.Tensor], torch.Tensor]


def reverse_rulebook(idx: torch.Tensor, n: int) -> torch.Tensor:
    """(M, K) forward rulebook over n input rows (n = miss) -> (n, K)
    int32 reverse rulebook: rev[r, j] = the m with idx[m, j] == r, else M.
    Each (r, j) is written at most once, so the result is deterministic."""
    m, k = idx.shape
    rev = torch.full((n * k,), m, dtype=torch.int32, device=idx.device)
    hit = idx < n
    dest = idx.long() * k + torch.arange(k, device=idx.device)
    rows = torch.arange(m, dtype=torch.int32, device=idx.device)[:, None]
    rev[dest[hit]] = rows.expand(m, k)[hit]
    return rev.view(n, k)


def gather_bwd_plain(feats: torch.Tensor, rb: torch.Tensor,
                     weights: torch.Tensor, g: torch.Tensor, flip: bool,
                     need_dfeats: bool = True) -> Grads:
    """Plain version of the kernel: the gather formula over rulebook rb
    (N, K) into g (M, Cout), offsets flipped for a subm rulebook."""
    n, cin = feats.shape
    k = rb.shape[1]
    cout = weights.shape[2]
    g0 = torch.cat([g.float(), g.new_zeros(1, cout, dtype=torch.float32)])
    gat = g0[rb.long()].reshape(n, k * cout)               # (N, K*Cout)
    w = weights.flip(0) if flip else weights
    dfeats = None
    if need_dfeats:
        w_bwd = w.transpose(1, 2).reshape(k * cout, cin)
        dfeats = gat @ w_bwd.float()
    dw = (feats.float().t() @ gat).reshape(cin, k, cout).transpose(0, 1)
    dw = dw.flip(0) if flip else dw
    return dfeats, dw.contiguous()


def scatter_bwd_plain(feats: torch.Tensor, idx: torch.Tensor,
                      weights: torch.Tensor, g: torch.Tensor,
                      need_dfeats: bool = True) -> Grads:
    """Plain version for any rulebook (M, K): the forward's autodiff, a
    re-gather for dW and a scatter-add for dfeats."""
    n, cin = feats.shape
    m, k = idx.shape
    cout = weights.shape[2]
    flat = idx.reshape(-1).long()
    table = torch.cat([feats.float(), feats.new_zeros(1, cin,
                                                      dtype=torch.float32)])
    gathered = table[flat].reshape(m, k * cin)
    dw = (gathered.t() @ g.float()).reshape(k, cin, cout)
    dfeats = None
    if need_dfeats:
        contrib = g.float() @ weights.reshape(k * cin, cout).t().float()
        dfeats = torch.zeros(n + 1, cin, dtype=torch.float32,
                             device=feats.device)
        dfeats.index_add_(0, flat, contrib.reshape(m * k, cin))
        dfeats = dfeats[:n]
    return dfeats, dw


def _check(name, feats, rb, weights, g):
    dev = feats.device
    for what, t in (("feats", feats), ("rulebook", rb), ("W", weights),
                    ("g", g)):
        if t.device != dev:
            raise ValueError(f"{name}: {what} is not on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    for what, t in (("feats", feats), ("W", weights), ("g", g)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: the kernel takes float32 {what}")
    if rb.dtype != torch.int32:
        raise ValueError(f"{name}: the rulebook must be int32")
    n, cin = feats.shape
    k = rb.shape[1]
    if rb.shape[0] != n or weights.shape[:2] != (k, cin) or \
            g.shape[1] != weights.shape[2]:
        raise ValueError(f"{name}: shapes feats {tuple(feats.shape)}, "
                         f"rulebook {tuple(rb.shape)}, W "
                         f"{tuple(weights.shape)}, g {tuple(g.shape)}")
    if max(n, g.shape[0]) >= 2 ** 31:
        raise ValueError(f"{name}: row counts must fit int32")
    if not 1 <= k <= 32:
        raise ValueError(f"{name}: the kernel takes 1 to 32 offsets, got "
                         f"K = {k}")


def _kernel_bwd(feats: torch.Tensor, rb: torch.Tensor,
                weights: torch.Tensor, g: torch.Tensor, flip: bool,
                need_dfeats: bool, name: str) -> Grads:
    """Launch the dfeats gather (if asked) and the two dW passes."""
    _check(name, feats, rb, weights, g)
    n, cin = feats.shape
    k = rb.shape[1]
    mg, cout = g.shape
    dev = feats.device
    lib = cuda_build.load_library("gather_conv_bwd", _SIGNATURES)
    chunks = (n + DW_CHUNK - 1) // DW_CHUNK
    part = torch.empty(max(chunks, 1) * k * cin * cout, dtype=torch.float32,
                       device=dev)
    dw = torch.empty(k, cin, cout, dtype=torch.float32, device=dev)
    dfeats = None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if need_dfeats:
            w = weights.flip(0) if flip else weights
            wt = w.transpose(1, 2).contiguous()             # (K, Cout, Cin)
            dfeats = torch.empty(n, cin, dtype=torch.float32, device=dev)
            rc = lib.conv_bwd_dfeats_f32(g.data_ptr(), rb.data_ptr(),
                                         wt.data_ptr(), dfeats.data_ptr(),
                                         mg, n, k, cout, cin, stream)
            cuda_build.check(lib, rc, f"{name} dfeats")
        rc = lib.conv_bwd_dw_f32(feats.data_ptr(), rb.data_ptr(),
                                 g.data_ptr(), part.data_ptr(),
                                 dw.data_ptr(), n, mg, k, cin, cout,
                                 DW_CHUNK, int(flip), stream)
    cuda_build.check(lib, rc, f"{name} dW")
    return dfeats, dw


def _on_card(name: str, feats: torch.Tensor) -> bool:
    if feats.device.type == "cpu":
        return False
    if feats.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for {feats.device}")
    return True


def subm_conv_bwd(feats: torch.Tensor, idx: torch.Tensor,
                  weights: torch.Tensor, g: torch.Tensor,
                  need_dfeats: bool = True) -> Grads:
    """K3: backward of a subm conv (idx (N, K) symmetric, M == N).
    Returns (dfeats (N, Cin) or None, dW (K, Cin, Cout))."""
    if not _on_card("subm_conv_bwd", feats):
        return gather_bwd_plain(feats, idx, weights, g, True, need_dfeats)
    global subm_launches
    out = _kernel_bwd(feats, idx, weights, g, True, need_dfeats,
                      "subm_conv_bwd")
    subm_launches += 1
    return out


def strided_conv_bwd(feats: torch.Tensor, idx: torch.Tensor,
                     weights: torch.Tensor, g: torch.Tensor,
                     need_dfeats: bool = True) -> Grads:
    """K4: backward of a strided or conv_out conv, idx (M, K) over N input
    rows, through its reverse rulebook.
    Returns (dfeats (N, Cin) or None, dW (K, Cin, Cout))."""
    if not _on_card("strided_conv_bwd", feats):
        return scatter_bwd_plain(feats, idx, weights, g, need_dfeats)
    global strided_launches
    rev = reverse_rulebook(idx, feats.shape[0])
    out = _kernel_bwd(feats, rev, weights, g, False, need_dfeats,
                      "strided_conv_bwd")
    strided_launches += 1
    return out
