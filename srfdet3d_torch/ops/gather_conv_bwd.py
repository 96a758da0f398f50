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
  (`strided_conv_bwd`, K4; replaces `gather_matmul_onehot_bwd`).  For
  dfeats the input rows are then grouped by their lowest hit offset (a
  stable order, `group_rows_plain`): an input row of a stride-2 conv hits only
  the offsets its coordinate parities allow, so a tile of grouped rows
  skips the offsets its class misses.  Both run on the card without a
  host sync (`strided_prep`).

Each wrapper runs its plain version for tensors on the CPU and the kernel,
or raises, for tensors on the card.  The plain versions are the JAX
package's CPU formulas: the symmetric gather (`ops/sparse_conv.py:753-765`)
and the autodiff gather + scatter-add (`:689-703`).

feats, W and g are float32, or all bfloat16 (the bf16 model).  In bfloat16
K4 runs its bf16 kernels (f32 accumulators and partials, each result
rounded to bfloat16 once); K3, as the TPU kernel's wrapper does
(`pallas_onehot_bwd.py:428`), upcasts feats, g and W to float32, runs the
float32 kernel and casts dfeats and dW back.  The plain versions sum in
float32 and round once, as the JAX package's `preferred_element_type=
float32` and `.astype` do.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import cuda_build
from .gather_conv import check_dtypes, pad_channels

# kernel launches since the last reset, one per backward (chip_smoke.py);
# a bf16 subm backward counts as K3's (the float32 kernel on upcasts)
subm_launches = 0
strided_launches = 0
strided_bf16_launches = 0

# rows of the input a dW block compacts and sums before its partial is
# written (the kernel takes at most 4096)
DW_CHUNK = 1024


def dw_chunk(bf16: bool, cin: int, cout: int, k: int) -> int:
    """Input rows a dW block compacts: DW_CHUNK, or twice it in the bf16
    pass at Cin x Cout >= 2048 and K >= 8, where halving its float32
    partials (chunks x K x Cin x Cout, written and summed again) saves more
    than the blocks it takes away (measured on the card at the flagship's
    down1 and down2, bench/probe_gather_gemm.py; at down0 and conv_out,
    K 3, the smaller chunk is faster)."""
    return 2 * DW_CHUNK if bf16 and cin * cout >= 2048 and k >= 8 \
        else DW_CHUNK

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    # g, rb, wt, dfeats, M, N, K, Cout, Cin, stream
    "conv_bwd_dfeats_f32": [_P, _P, _P, _P, _I, _LL, _I, _I, _I, _P],
    # g, rb, perm, wt, dfeats, M, N, K, Cout, Cin, stream
    "conv_bwd_dfeats_perm_f32": [_P, _P, _P, _P, _P, _I, _LL, _I, _I, _I,
                                 _P],
    # feats, rb, g, part, dW, N, M, K, Cin, Cout, chunk, flip, stream
    "conv_bwd_dw_f32": [_P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _I,
                        _P],
    # the bf16 entries: dfeats take W (K, Cin, Cout) as it is
    "conv_bwd_dfeats_bf16": [_P, _P, _P, _P, _I, _LL, _I, _I, _I, _P],
    "conv_bwd_dfeats_perm_bf16": [_P, _P, _P, _P, _P, _I, _LL, _I, _I, _I,
                                  _P],
    "conv_bwd_dw_bf16": [_P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _I,
                         _P],
    # idx, rev, M, N, K, stream
    "strided_reverse_i32": [_P, _P, _LL, _I, _I, _P],
    # rev, key, hist, perm, N, M, K, stream
    "strided_group_i32": [_P, _P, _P, _P, _LL, _I, _I, _P],
}
# input rows a grouping block orders (kGroupRows in the kernel)
GROUP_ROWS = 1024

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


def group_keys(rev: torch.Tensor, m: int) -> torch.Tensor:
    """(N,) int64: each row's lowest offset j with rev[r, j] < m, or K
    where the row hits none."""
    k = rev.shape[1]
    j = torch.arange(k, device=rev.device)
    return torch.where(rev < m, j, k).amin(1)


def group_rows_plain(rev: torch.Tensor, m: int) -> torch.Tensor:
    """(N,) int32 permutation: the rows of the reverse rulebook rev (N, K)
    in a stable order of their group_keys."""
    return torch.sort(group_keys(rev, m), stable=True).indices.int()


def strided_prep(idx: torch.Tensor, n: int, group: bool = True):
    """The strided backward's rulebooks: (rev (N, K) int32, perm (N,)
    int32 or None).  On the card two kernels (reverse rulebook, stable
    counting sort) with no host sync; on the CPU reverse_rulebook and
    group_rows_plain.  perm only where `group`."""
    m, k = idx.shape
    if not _on_card("strided_prep", idx):
        rev = reverse_rulebook(idx, n)
        return rev, group_rows_plain(rev, m) if group else None
    if idx.dtype != torch.int32 or not idx.is_contiguous():
        raise ValueError("strided_prep: idx must be contiguous int32")
    if max(m, n) >= 2 ** 31 or not 1 <= k <= 32:
        raise ValueError(f"strided_prep: rows must fit int32 and K be 1 to "
                         f"32, got idx {tuple(idx.shape)}, n {n}")
    dev = idx.device
    lib = cuda_build.load_library("gather_conv_bwd", _SIGNATURES)
    rev = torch.empty(n, k, dtype=torch.int32, device=dev)
    perm = None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.strided_reverse_i32(idx.data_ptr(), rev.data_ptr(), m, n, k,
                                     stream)
        cuda_build.check(lib, rc, "strided_prep reverse")
        if group:
            blocks = (n + GROUP_ROWS - 1) // GROUP_ROWS
            key = torch.empty(n, dtype=torch.uint8, device=dev)
            hist = torch.empty(max((k + 1) * blocks, 1), dtype=torch.int32,
                               device=dev)
            perm = torch.empty(n, dtype=torch.int32, device=dev)
            rc = lib.strided_group_i32(rev.data_ptr(), key.data_ptr(),
                                       hist.data_ptr(), perm.data_ptr(), n,
                                       m, k, stream)
            cuda_build.check(lib, rc, "strided_prep group")
    return rev, perm


def tile_offset_steps(rev: torch.Tensor, m: int,
                      perm: Optional[torch.Tensor], bm: int) -> int:
    """Offset steps the dfeats gather-GEMM issues over rev (N, K) in tiles
    of bm rows taken in the order perm (None: voxel order): per tile, the
    offsets that some row of it hits (the kernel skips the others).  At
    bm = 1 it counts the hits."""
    hit = rev < m
    if perm is not None:
        hit = hit[perm.long()]
    n, k = hit.shape
    hit = torch.cat([hit, hit.new_zeros((-n) % bm, k)]).view(-1, bm, k)
    return int(hit.any(1).sum())


def gather_bwd_plain(feats: torch.Tensor, rb: torch.Tensor,
                     weights: torch.Tensor, g: torch.Tensor, flip: bool,
                     need_dfeats: bool = True) -> Grads:
    """Plain version of the kernel: the gather formula over rulebook rb
    (N, K) into g (M, Cout), offsets flipped for a subm rulebook; float32
    sums, rounded once to feats' / W's dtype."""
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
    if dfeats is not None:
        dfeats = dfeats.to(feats.dtype)
    return dfeats, dw.contiguous().to(weights.dtype)


def grouped_bwd_plain(feats: torch.Tensor, rev: torch.Tensor,
                      perm: torch.Tensor, weights: torch.Tensor,
                      g: torch.Tensor) -> Grads:
    """Plain version of the strided kernel path: the gather formula over
    the rows of rev taken in the order perm, each dfeats row written back
    to its own row."""
    p = perm.long()
    dsorted, dw = gather_bwd_plain(feats[p], rev[p], weights, g, False)
    dfeats = torch.empty_like(dsorted)
    dfeats[p] = dsorted
    return dfeats, dw


def scatter_bwd_plain(feats: torch.Tensor, idx: torch.Tensor,
                      weights: torch.Tensor, g: torch.Tensor,
                      need_dfeats: bool = True) -> Grads:
    """Plain version for any rulebook (M, K): the forward's autodiff, a
    re-gather for dW and a scatter-add for dfeats, both in float32 (no
    bfloat16 atomics) and rounded once to feats' / W's dtype."""
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
        dfeats = dfeats[:n].to(feats.dtype)
    return dfeats, dw.to(weights.dtype)


def _check(name, feats, rb, weights, g):
    dev = feats.device
    for what, t in (("feats", feats), ("rulebook", rb), ("W", weights),
                    ("g", g)):
        if t.device != dev:
            raise ValueError(f"{name}: {what} is not on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    check_dtypes(name, feats, weights, g)
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
                need_dfeats: bool, name: str,
                perm: Optional[torch.Tensor] = None) -> Grads:
    """Launch the dfeats gather (if asked; its tile rows through perm
    where given) and the two dW passes, float32 or bfloat16.  The float32
    dfeats gather takes the (flipped) weights transposed, (K, Cout, Cin);
    the bf16 one reads them as they are, (K, Cin, Cout), and its Cin and
    Cout are padded with zeros to multiples of 8 where they are not (its
    16-byte row copies; no shipped config has such a width), the results
    cut back."""
    _check(name, feats, rb, weights, g)
    bf16 = feats.dtype == torch.bfloat16
    kind = "bf16" if bf16 else "f32"
    n, cin = feats.shape
    k = rb.shape[1]
    mg, cout = g.shape
    dev = feats.device
    lib = cuda_build.load_library("gather_conv_bwd", _SIGNATURES)
    fp, gp = (pad_channels(feats, 1), pad_channels(g, 1)) if bf16 \
        else (feats, g)
    cin_k, cout_k = fp.shape[1], gp.shape[1]
    chunk = dw_chunk(bf16, cin_k, cout_k, k)
    chunks = (n + chunk - 1) // chunk
    part = torch.empty(max(chunks, 1) * k * cin_k * cout_k,
                       dtype=torch.float32, device=dev)
    dw = torch.empty(k, cin_k, cout_k, dtype=feats.dtype, device=dev)
    dfeats = None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if need_dfeats:
            w = weights.flip(0) if flip else weights
            w = (pad_channels(pad_channels(w, 2), 1) if bf16    # (K, Cin, Cout)
                 else w.transpose(1, 2).contiguous())        # (K, Cout, Cin)
            dfeats = torch.empty(n, cin_k, dtype=feats.dtype, device=dev)
            if perm is None:
                rc = getattr(lib, f"conv_bwd_dfeats_{kind}")(
                    gp.data_ptr(), rb.data_ptr(), w.data_ptr(),
                    dfeats.data_ptr(), mg, n, k, cout_k, cin_k, stream)
            else:
                rc = getattr(lib, f"conv_bwd_dfeats_perm_{kind}")(
                    gp.data_ptr(), rb.data_ptr(), perm.data_ptr(),
                    w.data_ptr(), dfeats.data_ptr(), mg, n, k, cout_k,
                    cin_k, stream)
            cuda_build.check(lib, rc, f"{name} dfeats")
            if cin_k != cin:
                dfeats = dfeats[:, :cin].contiguous()
        rc = getattr(lib, f"conv_bwd_dw_{kind}")(
            fp.data_ptr(), rb.data_ptr(), gp.data_ptr(), part.data_ptr(),
            dw.data_ptr(), n, mg, k, cin_k, cout_k, chunk, int(flip),
            stream)
    cuda_build.check(lib, rc, f"{name} dW")
    if (cin_k, cout_k) != (cin, cout):
        dw = dw[:, :cin, :cout].contiguous()
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
    Returns (dfeats (N, Cin) or None, dW (K, Cin, Cout)).  bfloat16 inputs
    run the float32 kernel (or plain version) on their upcasts; the results
    come back rounded to bfloat16."""
    dtype = check_dtypes("subm_conv_bwd", feats, weights, g)
    if dtype != torch.float32:
        dfeats, dw = subm_conv_bwd(feats.float(), idx, weights.float(),
                                   g.float(), need_dfeats)
        return (None if dfeats is None else dfeats.to(dtype)), dw.to(dtype)
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
    rows, through its reverse rulebook (dfeats over the grouped rows).
    Returns (dfeats (N, Cin) or None, dW (K, Cin, Cout)), float32 or
    bfloat16 as the inputs."""
    check_dtypes("strided_conv_bwd", feats, weights, g)
    if not _on_card("strided_conv_bwd", feats):
        return scatter_bwd_plain(feats, idx, weights, g, need_dfeats)
    global strided_launches, strided_bf16_launches
    if idx.device != feats.device or g.shape[0] != idx.shape[0]:
        raise ValueError(f"strided_conv_bwd: idx {tuple(idx.shape)} on "
                         f"{idx.device}, g {tuple(g.shape)}")
    rev, perm = strided_prep(idx, feats.shape[0], need_dfeats)
    out = _kernel_bwd(feats, rev, weights, g, False, need_dfeats,
                      "strided_conv_bwd", perm)
    if feats.dtype == torch.float32:
        strided_launches += 1
    else:
        strided_bf16_launches += 1
    return out
