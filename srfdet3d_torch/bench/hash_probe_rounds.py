"""Probe rounds of K6's hash table at srfdet_voxel_kitti_L's stage 0, on the
CPU (numpy only; ~5 min).

    python3 -m srfdet3d_torch.bench.hash_probe_rounds

A lookup warp waits for its longest probe, and each probe round is a
dependent load, so the rounds a warp takes bound the lookup kernel.  The
keys are 65,536 random distinct cells of the 41 x 1600 x 1408 grid (the
uniform synthetic scene fills the stage-0 capacity with nearly isolated
voxels); the queries are each voxel's 27 neighbours in plan-major voxel
order, as the table encoder's stage-0 subm rulebook asks them.  The table
has 2^17 slots (load 0.5), homes from the top bits of
key * 0x9E3779B97F4A7C15, linear probing from the first slot of the home
bucket.  For buckets of 1, 2 and 4 slots read a round it prints the mean
rounds a query takes and the mean over warps (32 consecutive queries) of
the longest.
"""

from __future__ import annotations

import numpy as np

PHI = np.uint64(0x9E3779B97F4A7C15)
SHAPE = (41, 1600, 1408)
N_KEYS = 65_536
LOG2_SLOTS = 17


def homes(keys: np.ndarray, bucket: int) -> np.ndarray:
    """First slot of each key's home bucket."""
    log2_buckets = LOG2_SLOTS - bucket.bit_length() + 1
    h = (keys.astype(np.uint64) * PHI) >> np.uint64(64 - log2_buckets)
    return h.astype(np.int64) * bucket


def build(keys: np.ndarray, bucket: int) -> np.ndarray:
    size = 1 << LOG2_SLOTS
    table = np.full(size, -1, np.int64)
    for k, h in zip(keys, homes(keys, bucket)):
        while table[h] != -1:
            h = (h + 1) & (size - 1)
        table[h] = k
    return table


def rounds(table: np.ndarray, queries: np.ndarray, bucket: int):
    """Rounds (a bucket read each) until the equal key or an empty slot."""
    size = len(table)
    valid = queries >= 0
    h = homes(np.clip(queries, 0, None), bucket)
    n = np.zeros(queries.size, np.int64)
    active = valid.copy()
    while active.any():
        idx = np.flatnonzero(active)
        n[idx] += 1
        slots = table[(h[idx, None] + np.arange(bucket)) & (size - 1)]
        stop = ((slots == queries[idx, None]) | (slots == -1)).any(1)
        active[idx[stop]] = False
        h[idx] = (h[idx] + bucket) & (size - 1)
    warps = n[:n.size // 32 * 32].reshape(-1, 32).max(1)
    return float(n[valid].mean()), float(warps.mean())


def main() -> None:
    rng = np.random.default_rng(0)
    d, h, w = SHAPE
    keys = np.sort(rng.choice(d * h * w, N_KEYS, replace=False))
    z, rem = keys // (h * w), keys % (h * w)
    y, x = rem // w, rem % w
    off = np.stack(np.meshgrid(*[np.arange(-1, 2)] * 3, indexing="ij"),
                   -1).reshape(-1, 3)
    order = np.argsort(y * w + x, kind="stable")
    nz = z[order, None] + off[:, 0]
    ny = y[order, None] + off[:, 1]
    nx = x[order, None] + off[:, 2]
    ok = (nz >= 0) & (nz < d) & (ny >= 0) & (ny < h) & (nx >= 0) & (nx < w)
    queries = np.where(ok, (nz * h + ny) * w + nx, -1).reshape(-1)
    for bucket in (1, 2, 4):
        mean, warp = rounds(build(keys, bucket), queries, bucket)
        print(f"bucket {bucket}: mean rounds {mean:.2f}, "
              f"a warp's longest {warp:.2f}")


if __name__ == "__main__":
    main()
