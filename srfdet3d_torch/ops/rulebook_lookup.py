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
version searches the sorted keys (searchsorted); the CPU's table is built
by the plain version of the build (`key_hash_plain`) and is only probed
by the tests.

The wrappers call the registered ops `srfdet::key_hash` (the table, its
size a static argument from the keys' count) and `srfdet::rulebook_lookup`
(keys, rows, queries, the table, the sentinel): their CPU implementations
are the plain versions, their CUDA ones the launches, and their fakes give
the output shapes to `torch.export`.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from . import cuda_build
from ..utils import profiling

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
# Fibonacci hashing's multiplier 0x9E3779B97F4A7C15, as a signed int64
_GOLDEN = 0x9E3779B97F4A7C15 - (1 << 64)


@dataclasses.dataclass
class KeyHash:
    """An open-addressing table of the first occurrence of each key in
    [0, sentinel): 2 ** log2_slots int64 words key << ROW_BITS | row, -1
    where empty, probed by buckets of 4 slots; built on every device."""
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


def _home(keys: torch.Tensor, log2_slots: int) -> torch.Tensor:
    """The first slot of each key's home bucket, as the kernels hash it:
    the top log2_slots - 2 bits of key * 0x9E3779B97F4A7C15 (mod 2^64),
    times 4 (buckets of 4 slots)."""
    bits = log2_slots - 2
    h = keys * _GOLDEN                      # wraps mod 2^64, as uint64 does
    return ((h >> (64 - bits)) & ((1 << bits) - 1)) << 2


def key_hash_plain(keys: torch.Tensor, rows: torch.Tensor, sentinel: int,
                   log2_slots: int) -> torch.Tensor:
    """Plain version of the table build: the first of each run of equal
    keys in [0, sentinel), as key << ROW_BITS | row, by linear probing from
    its home bucket's first slot; -1 where empty.  Keys probe in rounds,
    and where several reach one empty slot the earliest key takes it.  The
    card's atomic inserts may place keys in other slots of their probe
    runs; every probe finds the same row in either table."""
    slots = 1 << log2_slots
    table = torch.full((slots,), -1, dtype=torch.int64, device=keys.device)
    first = torch.ones_like(keys, dtype=torch.bool)
    first[1:] = keys[1:] != keys[:-1]
    sel = first & (keys >= 0) & (keys < sentinel)
    key = keys[sel]
    word = (key << ROW_BITS) | rows[sel].to(torch.int64)
    pos = _home(key, log2_slots)
    pending = torch.arange(key.numel(), device=keys.device)
    while pending.numel():
        at = pos[pending]
        empty = table[at] == -1
        claim = torch.full((slots,), key.numel(), dtype=torch.int64,
                           device=keys.device)
        claim.scatter_reduce_(0, at[empty], pending[empty], "amin")
        won = empty & (claim[at] == pending)
        table[at[won]] = word[pending[won]]
        pending = pending[~won]
        pos[pending] = (pos[pending] + 1) & (slots - 1)
    return table


def _kernels():
    global _lib
    if _lib is None:
        _lib = cuda_build.load_library("rulebook_lookup", _SIGNATURES)
    return _lib


def _check_hash_args(keys: torch.Tensor, rows: torch.Tensor,
                     sentinel: int) -> None:
    n = keys.numel()
    if keys.dtype != torch.int64 or keys.dim() != 1 or \
            not keys.is_contiguous():
        raise ValueError("key_hash: keys must be 1-D contiguous int64")
    if rows.dtype != torch.int32 or rows.shape != (n,) or \
            rows.device != keys.device or not rows.is_contiguous():
        raise ValueError(f"key_hash: rows must be ({n},) contiguous int32 "
                         f"on {keys.device}")
    if n >= 1 << ROW_BITS or not 0 <= sentinel < KEY_LIMIT - 1:
        raise ValueError(f"key_hash: a slot holds rows below 2^{ROW_BITS} "
                         f"and keys below 2^{64 - ROW_BITS} - 1")


def key_hash(keys: torch.Tensor, rows: torch.Tensor,
             sentinel: int) -> KeyHash:
    """The hash table of sorted keys and their rows: built on the card for
    tensors there, by the plain version for tensors on the CPU, through
    the op `srfdet::key_hash`.  Its size follows from the keys' count
    alone (`hash_slots_log2`), so a traced program has it static."""
    cuda_build.check_device("key_hash", keys.device)
    log2 = hash_slots_log2(keys.numel())
    table = key_hash_op(keys, rows, int(sentinel), log2)
    return KeyHash(table, log2, keys.numel(), int(sentinel))


@torch.library.custom_op("srfdet::key_hash", mutates_args=(),
                         device_types="cpu")
def key_hash_op(keys: torch.Tensor, rows: torch.Tensor, sentinel: int,
                log2_slots: int) -> torch.Tensor:
    """The op's CPU implementation: the plain version."""
    _check_hash_args(keys, rows, sentinel)
    return key_hash_plain(keys, rows, sentinel, log2_slots)


@key_hash_op.register_fake
def _key_hash_fake(keys, rows, sentinel, log2_slots):
    return keys.new_empty(1 << log2_slots)


@key_hash_op.register_kernel("cuda")
def _key_hash_cuda(keys: torch.Tensor, rows: torch.Tensor, sentinel: int,
                   log2_slots: int) -> torch.Tensor:
    """The op's CUDA implementation: the fill and insert kernels; counts
    the build (counter `rulebook_lookup.builds`, in eager and in an
    exported program alike)."""
    _check_hash_args(keys, rows, sentinel)
    dev = keys.device
    table = torch.empty(1 << log2_slots, dtype=torch.int64, device=dev)
    lib = _kernels()
    with torch.cuda.device(dev):
        rc = lib.key_hash_build(keys.data_ptr(), rows.data_ptr(),
                                keys.numel(), sentinel, table.data_ptr(),
                                log2_slots,
                                torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(lib, rc, "key_hash")
    profiling.count("rulebook_lookup.builds")
    return table


def rulebook_lookup(keys: torch.Tensor, rows: torch.Tensor,
                    queries: torch.Tensor, sentinel: int,
                    hashed: Optional[KeyHash] = None) -> torch.Tensor:
    """The row of each query's key: the hash-table kernel for tensors on
    the card (probing `hashed`, the table of these keys, or one built
    here), the plain version for tensors on the CPU, through the op
    `srfdet::rulebook_lookup`."""
    cuda_build.check_device("rulebook_lookup", keys.device)
    if hashed is None:
        hashed = key_hash(keys, rows, sentinel)
    elif (hashed.n_keys != keys.numel() or
          hashed.sentinel != int(sentinel) or
          hashed.table.device != keys.device or
          hashed.table.shape != (1 << hashed.log2_slots,)):
        raise ValueError("rulebook_lookup: the hash table is not these "
                         "keys'")
    return rulebook_lookup_op(keys, rows, queries, hashed.table,
                              int(sentinel))


@torch.library.custom_op("srfdet::rulebook_lookup", mutates_args=(),
                         device_types="cpu")
def rulebook_lookup_op(keys: torch.Tensor, rows: torch.Tensor,
                       queries: torch.Tensor, table: torch.Tensor,
                       sentinel: int) -> torch.Tensor:
    """The op's CPU implementation: the plain version, which searches the
    sorted keys (the table is the CUDA implementation's)."""
    return rulebook_lookup_plain(keys, rows, queries, sentinel)


@rulebook_lookup_op.register_fake
def _rulebook_lookup_fake(keys, rows, queries, table, sentinel):
    return queries.new_empty(queries.shape, dtype=torch.int32)


@rulebook_lookup_op.register_kernel("cuda")
def _rulebook_lookup_cuda(keys: torch.Tensor, rows: torch.Tensor,
                          queries: torch.Tensor, table: torch.Tensor,
                          sentinel: int) -> torch.Tensor:
    """The op's CUDA implementation: checks the arguments, launches the
    probe kernel on `table` and counts the launch (counter
    `rulebook_lookup.launches`)."""
    dev = keys.device
    slots = table.numel()
    if queries.dtype != torch.int64 or queries.dim() != 2 or \
            queries.device != dev or not queries.is_contiguous():
        raise ValueError(f"rulebook_lookup: queries must be (M, K) "
                         f"contiguous int64 on {dev}")
    if table.dtype != torch.int64 or table.device != dev or \
            table.dim() != 1 or slots < 8 or slots & (slots - 1):
        raise ValueError("rulebook_lookup: the hash table must be a 1-D "
                         "int64 power-of-two table on the keys' device")
    out = torch.empty(queries.shape, dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    lib = _kernels()
    with torch.cuda.device(dev):
        rc = lib.rulebook_lookup(table.data_ptr(), slots.bit_length() - 1,
                                 queries.data_ptr(), queries.numel(),
                                 sentinel, keys.numel(), out.data_ptr(),
                                 torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(lib, rc, "rulebook_lookup")
    profiling.count("rulebook_lookup.launches")
    return out
