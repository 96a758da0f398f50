"""Sorted-key rulebook lookup: the rulebook_lookup kernel (K6) and its plain
version.

Replaces the JAX package's Pallas kernel
`ops/pallas_rulebook.py::rulebook_lookup` (kernel body `_kernel`).  Given
keys (N,) int64 ascending, the row of each key (N,) int32 and queries (M, K)
int64, the result (M, K) int32 holds, for each query, the row of the key
equal to it, or the miss row N when no key equals it or the query is
invalid (< 0 or >= sentinel).

The JAX kernel returns the key's position; here `rows` maps a position to
its row, so the key array may be a sorted view of rows kept in another
order (the table rulebooks' stage-0 voxels, which arrive plan-major).  With
rows = arange(N) the two agree.

The TPU kernel windows the sorted keys because Mosaic has no dynamic gather;
the CUDA kernel binary-searches the whole key array, so it needs no window
and no correction pass.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

# kernel launches since the last reset (chip_smoke.py reads it)
launches = 0

_P, _LL = ctypes.c_void_p, ctypes.c_longlong
# keys, rows, N, queries, M * K, sentinel, out, stream
_SIGNATURES = {"rulebook_lookup": [_P, _P, _LL, _P, _LL, _LL, _P, _P]}


def rulebook_lookup_plain(keys: torch.Tensor, rows: torch.Tensor,
                          queries: torch.Tensor, sentinel: int
                          ) -> torch.Tensor:
    """Plain PyTorch version: searchsorted, then an equality test and the
    row gather."""
    n = keys.numel()
    if n == 0:
        return torch.full(queries.shape, 0, dtype=torch.int32,
                          device=queries.device)
    q = queries.reshape(-1)
    pos = torch.searchsorted(keys, q).clamp_max(n - 1)
    found = (keys[pos] == q) & (q >= 0) & (q < sentinel)
    out = torch.where(found, rows[pos], n)
    return out.to(torch.int32).reshape(queries.shape)


def rulebook_lookup(keys: torch.Tensor, rows: torch.Tensor,
                    queries: torch.Tensor, sentinel: int) -> torch.Tensor:
    """The row of each query's key: the CUDA kernel for tensors on the card,
    the plain version for tensors on the CPU."""
    if keys.device.type == "cpu":
        return rulebook_lookup_plain(keys, rows, queries, sentinel)
    if keys.device.type != "cuda":
        raise RuntimeError(f"rulebook_lookup: no kernel for {keys.device}")
    global launches
    n = keys.numel()
    dev = keys.device
    if keys.dtype != torch.int64 or keys.dim() != 1:
        raise ValueError("rulebook_lookup: keys must be 1-D int64")
    if rows.dtype != torch.int32 or rows.shape != (n,):
        raise ValueError(f"rulebook_lookup: rows must be ({n},) int32")
    if queries.dtype != torch.int64 or queries.dim() != 2:
        raise ValueError("rulebook_lookup: queries must be (M, K) int64")
    if rows.device != dev or queries.device != dev:
        raise ValueError("rulebook_lookup: keys, rows and queries must share "
                         "a device")
    for name, t in (("keys", keys), ("rows", rows), ("queries", queries)):
        if not t.is_contiguous():
            raise ValueError(f"rulebook_lookup: {name} must be contiguous")
    if n >= 2 ** 31:
        raise ValueError("rulebook_lookup: the miss row N must fit int32")
    out = torch.empty(queries.shape, dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    lib = cuda_build.load_library("rulebook_lookup", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.rulebook_lookup(keys.data_ptr(), rows.data_ptr(), n,
                                 queries.data_ptr(), queries.numel(),
                                 int(sentinel), out.data_ptr(), stream)
    cuda_build.check(lib, rc, "rulebook_lookup")
    launches += 1
    return out
