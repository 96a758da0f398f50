"""Sorted-key rulebook lookup: the rulebook_lookup kernel (K6), the hash
table it probes, and its plain version.

Replaces the JAX package's Pallas kernel
`ops/pallas_rulebook.py::rulebook_lookup` (kernel body `_kernel`).  Given
keys (N,) int64 ascending, the row of each key (N,) int32 and queries (M, K)
int64, the result (M, K) int32 holds, for each query, the row of the first
key equal to it, or the miss row N when no key equals it or the query is
invalid (< 0 or >= sentinel).

The JAX kernel returns the key's position; here `rows` maps a position to
its row, so the key array may be a sorted view of rows kept in another
order (the table rulebooks' stage-0 voxels, which arrive plan-major).  With
rows = arange(N) the two agree.

On the card the lookup probes an open-addressing hash table of the keys
(`KeyHash`, built by `key_hash`), which a key table builds once and all its
lookups share; a lookup given none builds its own.  On the CPU the plain
version searches the sorted keys (searchsorted) and no table is built.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from . import cuda_build

# lookup-kernel launches and hash-table builds since the last reset
# (chip_smoke.py reads them)
launches = 0
builds = 0

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    # keys, rows, N, sentinel, table, log2 slots, stream
    "key_hash_build": [_P, _P, _LL, _LL, _P, _I, _P],
    # table, log2 slots, queries, M * K, sentinel, miss row, out, stream
    "rulebook_lookup": [_P, _I, _P, _LL, _LL, _I, _P, _P],
}
_lib = None


# a slot packs key << ROW_BITS | row into one int64 word
ROW_BITS = 24
KEY_LIMIT = 1 << (64 - ROW_BITS)


@dataclasses.dataclass
class KeyHash:
    """An open-addressing table of the first occurrence of each key in
    [0, sentinel): 2 ** log2_slots int64 words key << ROW_BITS | row, -1
    where empty, probed by buckets of 4 slots."""
    table: torch.Tensor
    log2_slots: int
    n_keys: int
    sentinel: int


def hash_slots_log2(n_keys: int) -> int:
    """log2 of the table's slots: 2 ** ceil(log2 2N), so the load factor
    is at most 0.5, and at least 8 slots (2 buckets)."""
    return max(3, (2 * n_keys - 1).bit_length())


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


def _kernels():
    global _lib
    if _lib is None:
        _lib = cuda_build.load_library("rulebook_lookup", _SIGNATURES)
    return _lib


def key_hash(keys: torch.Tensor, rows: torch.Tensor,
             sentinel: int) -> Optional[KeyHash]:
    """The hash table of sorted keys and their rows, built on the card for
    tensors there; None for tensors on the CPU, whose lookups search the
    sorted keys."""
    dev = keys.device
    if dev.type == "cpu":
        return None
    if dev.type != "cuda":
        raise RuntimeError(f"key_hash: no kernel for {dev}")
    global builds
    n = keys.numel()
    if keys.dtype != torch.int64 or keys.dim() != 1 or \
            not keys.is_contiguous():
        raise ValueError("key_hash: keys must be 1-D contiguous int64")
    if rows.dtype != torch.int32 or rows.shape != (n,) or \
            rows.device != dev or not rows.is_contiguous():
        raise ValueError(f"key_hash: rows must be ({n},) contiguous int32 "
                         f"on {dev}")
    if n >= 1 << ROW_BITS or not 0 <= sentinel < KEY_LIMIT - 1:
        raise ValueError(f"key_hash: a slot holds rows below 2^{ROW_BITS} "
                         f"and keys below 2^{64 - ROW_BITS} - 1")
    log2 = hash_slots_log2(n)
    table = torch.empty(1 << log2, dtype=torch.int64, device=dev)
    lib = _kernels()
    with torch.cuda.device(dev):
        rc = lib.key_hash_build(keys.data_ptr(), rows.data_ptr(), n,
                                int(sentinel), table.data_ptr(), log2,
                                torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(lib, rc, "key_hash")
    builds += 1
    return KeyHash(table, log2, n, int(sentinel))


def rulebook_lookup(keys: torch.Tensor, rows: torch.Tensor,
                    queries: torch.Tensor, sentinel: int,
                    hashed: Optional[KeyHash] = None) -> torch.Tensor:
    """The row of each query's key: the hash-table kernel for tensors on
    the card (probing `hashed`, the table of these keys, or one built
    here), the plain version for tensors on the CPU."""
    if keys.device.type == "cpu":
        return rulebook_lookup_plain(keys, rows, queries, sentinel)
    if keys.device.type != "cuda":
        raise RuntimeError(f"rulebook_lookup: no kernel for {keys.device}")
    global launches
    dev = keys.device
    n = keys.numel()
    if queries.dtype != torch.int64 or queries.dim() != 2 or \
            queries.device != dev or not queries.is_contiguous():
        raise ValueError(f"rulebook_lookup: queries must be (M, K) "
                         f"contiguous int64 on {dev}")
    if hashed is None:
        hashed = key_hash(keys, rows, sentinel)
    elif (hashed.n_keys != n or hashed.sentinel != int(sentinel) or
          hashed.table.device != dev or
          hashed.table.shape != (1 << hashed.log2_slots,)):
        raise ValueError("rulebook_lookup: the hash table is not these "
                         "keys'")
    out = torch.empty(queries.shape, dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    lib = _kernels()
    with torch.cuda.device(dev):
        rc = lib.rulebook_lookup(hashed.table.data_ptr(), hashed.log2_slots,
                                 queries.data_ptr(), queries.numel(),
                                 int(sentinel), n, out.data_ptr(),
                                 torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(lib, rc, "rulebook_lookup")
    launches += 1
    return out
