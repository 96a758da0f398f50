"""PyTorch port vs JAX package: K6's hash-table route.  Every output is
integer and must match exactly (tolerance: none).

On the card the lookup kernel probes an open-addressing table of the
sorted keys (`ops/rulebook_lookup.py`, `csrc/rulebook_lookup.cu`):
2 ** ceil(log2 2N) slots of one word key << 24 | row, the first occurrence
of each key in [0, sentinel) inserted by linear probing from the first
slot of its home bucket of 4 (the top bits of key * 0x9E3779B97F4A7C15),
a probe reading a bucket a round until the equal key or an empty slot.
A numpy (uint64) model of that build and probe is held against the
plain version (`rulebook_lookup_plain`, searchsorted, which the wrapper
runs on the CPU) and the Pallas kernel in interpret mode, and the model's
probe of the table that the plain build (`key_hash_plain`, the CPU's
key_hash) makes is held against the plain version too: chains of keys
that share a home slot and wrap around the table's end, a table at its
load limit, permuted rows, invalid queries, and B = 2 key tables with each
sample's padding keys.  The model inserts in random orders too: the rows
found do not depend on the order, though the slots do."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srfdet3d_tpu.ops.pallas_rulebook import rulebook_lookup as j_lookup
from srfdet3d_torch.ops import rulebook_lookup as rl
from srfdet3d_torch.ops import sparse_conv as tsc

T = torch.from_numpy
_PHI = np.uint64(0x9E3779B97F4A7C15)


def _home(keys, log2):
    """First slot of each key's home bucket: the top log2 - 2 bits of
    key * 0x9E3779B97F4A7C15 (mod 2^64), times 4."""
    k = np.asarray(keys, np.int64).astype(np.uint64)
    return ((k * _PHI) >> np.uint64(64 - (log2 - 2))) << np.uint64(2)


def _build(keys, rows, sentinel, order=None):
    """The table the build kernel makes, inserting in `order` (default
    index order): (slot words, log2 slots)."""
    n = len(keys)
    log2 = rl.hash_slots_log2(n)
    size = 1 << log2
    table = np.full(size, -1, np.int64)
    home = _home(keys, log2)
    for i in (range(n) if order is None else order):
        k = int(keys[i])
        if not 0 <= k < sentinel or (i > 0 and keys[i - 1] == k):
            continue
        h = int(home[i])
        while table[h] != -1 and table[h] >> rl.ROW_BITS != k:
            h = (h + 1) & (size - 1)
        if table[h] == -1:
            table[h] = k << rl.ROW_BITS | int(rows[i])
    return table, log2


def _probe(built, queries, sentinel, n):
    """The lookup kernel, a bucket of 4 slots a round: (rows (M, K)
    int32, most slots any query passed)."""
    table, log2 = built
    size = len(table)
    flat = np.asarray(queries, np.int64).reshape(-1)
    home = _home(np.clip(flat, 0, None), log2)
    out = np.full(flat.shape, n, np.int64)
    longest = 0
    for t, q in enumerate(flat):
        if not 0 <= q < sentinel:
            continue
        h, steps, done = int(home[t]), 0, False
        while not done:
            for word in table[h:h + 4]:
                steps += 1
                if word == -1:
                    done = True
                elif word >> rl.ROW_BITS == q:
                    out[t] = word & ((1 << rl.ROW_BITS) - 1)
                    done = True
                if done:
                    break
            h = (h + 4) & (size - 1)
        longest = max(longest, steps)
    return out.reshape(np.shape(queries)).astype(np.int32), longest


def _check(keys, rows, queries, sentinel, seed=0):
    """Model == plain version, in index order and two random insertion
    orders; returns (result, table, longest probe)."""
    n = len(keys)
    ref = rl.rulebook_lookup_plain(T(keys), T(rows), T(queries), sentinel)
    table = _build(keys, rows, sentinel)
    got, longest = _probe(table, queries, sentinel, n)
    np.testing.assert_array_equal(got, ref.numpy())
    rng = np.random.default_rng(seed)
    for _ in range(2):
        shuffled = _build(keys, rows, sentinel, rng.permutation(n))
        np.testing.assert_array_equal(
            _probe(shuffled, queries, sentinel, n)[0], ref.numpy())
    # the wrapper takes the plain version on the CPU
    np.testing.assert_array_equal(
        rl.rulebook_lookup(T(keys), T(rows), T(queries), sentinel).numpy(),
        ref.numpy())
    # the table the plain build makes on the CPU (key_hash's CPU route)
    # answers every probe as the plain version does
    plain = rl.key_hash(T(keys), T(rows), sentinel)
    np.testing.assert_array_equal(
        _probe((plain.table.numpy(), plain.log2_slots), queries, sentinel,
               n)[0], ref.numpy())
    return ref.numpy(), table, longest


def _pallas_check(keys, rows, queries, sentinel, ref, take=384):
    """JAX's kernel in interpret mode on `take` queries spread over the
    flat ones (as one (128, 3) tile: one compile a test), its positions
    mapped through `rows`, equal to `ref` there."""
    flat = np.asarray(queries).reshape(-1)
    idx = np.linspace(0, flat.size - 1, min(take, flat.size)).astype(int)
    q = np.full(take, -1, np.int64)
    q[:len(idx)] = flat[idx]
    pos = np.asarray(j_lookup(jnp.asarray(keys.astype(np.int32)),
                              jnp.asarray(q.astype(np.int32).reshape(-1, 3)),
                              sentinel, tm=128, interpret=True))
    pos = pos.reshape(-1)[:len(idx)]
    n = len(keys)
    got = np.where(pos < n, rows[np.minimum(pos, n - 1)], n)
    np.testing.assert_array_equal(got, ref.reshape(-1)[idx])


def test_colliding_chains_wrap_around_the_end():
    """Keys whose home is the table's last bucket: one probe chain of ~40
    slots that wraps to the table's start; absent keys of the same home
    probe it to its end."""
    n, cells = 64, 200_000
    log2 = rl.hash_slots_log2(n)
    size = 1 << log2
    cand = np.arange(cells, dtype=np.int64)
    tail = cand[_home(cand, log2) == size - 4]
    rng = np.random.default_rng(0)
    pick = rng.choice(tail, 2 * 40, replace=False)
    keys = np.sort(pick[:40])
    absent = pick[40:]
    rest = np.setdiff1d(rng.choice(cells, 40, replace=False), keys)
    keys = np.sort(np.concatenate([keys, rest[:n - 40]]))
    rows = np.arange(n, dtype=np.int32)
    queries = np.concatenate([keys, absent, rng.integers(0, cells, 64)])
    queries = rng.permutation(queries).reshape(-1, 8)
    ref, (table, _), longest = _check(keys, rows, queries, cells)
    assert longest >= 40
    homes = _home(table[table >= 0] >> rl.ROW_BITS, log2)
    assert (np.flatnonzero(table >= 0) < homes.astype(np.int64)).any(), \
        "no chain wrapped around the table's end"
    _pallas_check(keys, rows, queries, cells, ref)


def test_table_at_its_load_limit():
    """N a power of two: 2N slots, load factor exactly 0.5."""
    rng = np.random.default_rng(1)
    n, cells = 1024, 50_000
    assert 1 << rl.hash_slots_log2(n) == 2 * n
    assert 1 << rl.hash_slots_log2(n + 1) == 4 * n
    keys = np.sort(rng.choice(cells, n, replace=False)).astype(np.int64)
    rows = np.arange(n, dtype=np.int32)
    queries = rng.integers(0, cells, (256, 27))
    hits = rng.random(queries.shape) < 0.5
    queries[hits] = keys[rng.integers(0, n, hits.sum())]
    ref, (table, _), _ = _check(keys, rows, queries, cells)
    assert (table >= 0).sum() == n
    assert (ref < n).sum() >= hits.sum()
    _pallas_check(keys, rows, queries, cells, ref)


def test_permuted_rows_and_invalid_queries():
    """Plan-major rows (a permutation), and queries < 0 or >= sentinel."""
    rng = np.random.default_rng(2)
    n, cells = 700, 10_000
    keys = np.sort(rng.choice(cells, n, replace=False)).astype(np.int64)
    rows = rng.permutation(n).astype(np.int32)
    queries = rng.integers(0, cells, (300, 27))
    hits = rng.random(queries.shape) < 0.5
    queries[hits] = keys[rng.integers(0, n, hits.sum())]
    bad = rng.random(queries.shape)
    queries[bad < 0.05] = -1 - rng.integers(0, 5, (bad < 0.05).sum())
    queries[bad > 0.95] = cells + rng.integers(0, 5, (bad > 0.95).sum())
    ref, _, _ = _check(keys, rows, queries, cells)
    assert (ref[(queries < 0) | (queries >= cells)] == n).all()
    _pallas_check(keys, rows, queries, cells, ref)


def test_two_sample_key_table_with_padding_keys():
    """A B = 2 key table of plan-major voxels (make_key_table): each
    sample's masked rows share its padding key b * shift + cells, which is
    inserted once, with the row of its first occurrence, as the plain
    version finds it; the encoder's own queries never equal it."""
    rng = np.random.default_rng(3)
    b, v, shape = 2, 300, (8, 16, 16)
    d, h, w = shape
    cells = d * h * w
    coords = np.zeros((b, v, 3), np.int64)
    mask = np.zeros((b, v), bool)
    for s in range(b):
        c = rng.choice(cells, 200 - 20 * s, replace=False)
        z, yx = c // (h * w), c % (h * w)
        o = np.argsort(yx * d + z)                   # plan-major
        coords[s, :len(o)] = np.stack([z[o], yx[o] // w, yx[o] % w], -1)
        mask[s, :len(o)] = True
    table = tsc.make_key_table(T(coords), T(mask), shape)
    hashed = table.hashed              # on the CPU, the plain build's
    assert hashed.log2_slots == rl.hash_slots_log2(b * v)
    keys, rows = table.keys.numpy(), table.rows.numpy()
    pads = np.arange(b) * (cells + 1) + cells
    assert all((keys == p).sum() > 1 for p in pads)
    sub = tsc.subm_gather_indices_batched(T(coords), T(mask), shape,
                                          key_table=table)
    d3 = np.stack(np.meshgrid(*[np.arange(3)] * 3, indexing="ij"),
                  -1).reshape(-1, 3) - 1
    nc = coords[:, :, None, :] + d3
    inr = ((nc >= 0) & (nc < np.array(shape))).all(-1) & mask[..., None]
    q = np.where(inr, (nc[..., 0] * h + nc[..., 1]) * w + nc[..., 2], cells)
    gq = np.where(q < cells, q + np.arange(b)[:, None, None] * (cells + 1),
                  table.sentinel).reshape(-1, 27)
    queries = np.concatenate([gq, np.tile(pads, (1, 27 // b + 1))[:, :27]])
    ref, _, _ = _check(keys, rows, queries, table.sentinel)
    np.testing.assert_array_equal(
        _probe((hashed.table.numpy(), hashed.log2_slots), queries,
               table.sentinel, len(keys))[0], ref)
    np.testing.assert_array_equal(ref[:-1].reshape(sub.shape), sub.numpy())
    first = [rows[np.flatnonzero(keys == p)[0]] for p in pads]
    assert list(ref[-1, :b]) == first
    _pallas_check(keys, rows, gq, table.sentinel, ref[:-1])


def test_wrappers_take_no_other_device():
    keys = torch.arange(8, device="meta")
    rows = torch.arange(8, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        rl.key_hash(keys, rows, 8)
    with pytest.raises(RuntimeError, match="no kernel"):
        rl.rulebook_lookup(keys, rows, keys.reshape(2, 4), 8)
