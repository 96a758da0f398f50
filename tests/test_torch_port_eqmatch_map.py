"""PyTorch port vs JAX package: K2's plan-map route.  Every output is
integer and must match exactly (tolerance: none).

The eq-match kernel builds a dense plan map (cell -> global column slot)
and answers the 3 dz taps of each (voxel, plan column) from one column
word.  Its plain version (`ops/eqmatch.py`: `plan_map_plain`,
`column_query_plain`, which the wrapper runs on the CPU) and a numpy
emulation of the CUDA kernels' threads (the map's fill and scatter through
the ColumnSet's sample strides, 9 threads a voxel, the block's staged rows
written as 16-byte words and a tail) are held against JAX's `plan_table`,
`subm_rulebook_bitmap`, the strided rulebook of
`strided_downsample_bitmap`, and the Pallas eq-match kernel in interpret
mode, at B = 2: a capacity overflow, cells at the grid's edges, a column
with all 41 z bits set and a stride-2 query."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srfdet3d_tpu.ops import bitmap_rulebook as jbr
from srfdet3d_torch.ops import bitmap_rulebook as tbr
from srfdet3d_torch.ops import eqmatch as teq

B = 2
T = torch.from_numpy
_U64 = (1 << 64) - 1

_j_build = jax.jit(jbr.build_columns, static_argnums=2)
_j_plan = jax.jit(jbr.plan_table)
_j_subm = jax.jit(jbr.subm_rulebook_bitmap)
_j_down = jax.jit(partial(jbr.strided_downsample_bitmap, eqmatch=False,
                          return_yx=True), static_argnums=(1, 2))


def _scene(seed, v, shape, density, edges=False, full_column=False):
    """B samples of plan-major sorted voxels, invalid rows at each
    sample's tail; `edges` adds voxels on every face of the grid,
    `full_column` one column with every z of the grid set."""
    rng = np.random.default_rng(seed)
    d, h, w = shape
    coords = np.zeros((B, v, 3), np.int32)
    mask = np.zeros((B, v), bool)
    for s in range(B):
        forced = []
        if edges:
            for z, y, x in ((0, 0, 0), (d - 1, h - 1, w - 1),
                            (0, h - 1, 0), (d - 1, 0, w - 1)):
                forced.append((z * h + y) * w + x)
            for _ in range(6):
                z, y, x = (rng.integers(d), rng.integers(h), rng.integers(w))
                forced += [(z * h + 0) * w + x, (z * h + h - 1) * w + x,
                           (z * h + y) * w + 0, (z * h + y) * w + w - 1,
                           (0 * h + y) * w + x, ((d - 1) * h + y) * w + x]
        if full_column:
            y, x = h // 2 + s, w // 3
            forced += [(z * h + y) * w + x for z in range(d)]
        forced = np.unique(np.array(forced, np.int64))
        n = int(v * density) - 3 * s
        rest = np.setdiff1d(rng.choice(d * h * w, size=2 * n, replace=False),
                            forced)[:max(0, n - len(forced))]
        cells = np.concatenate([forced, rest])
        z, yx = cells // (h * w), cells % (h * w)
        o = np.argsort(yx * d + z)
        coords[s, :len(o)] = np.stack([z[o], yx[o] // w, yx[o] % w], -1)
        mask[s, :len(o)] = True
    return coords, mask


def _cols(coords, mask, shape):
    jcols = _j_build(jnp.asarray(coords), jnp.asarray(mask), shape)
    tcols = tbr.build_columns(T(coords).long(), T(mask), shape)
    return jcols, tcols


def _eq(t, j):
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j))


def _storage(t, shape, inner, name):
    """The flat elements a kernel reads of a column array, through the
    sample stride the wrapper passes it."""
    stride = teq._sample_stride(t, shape, inner, name)
    n = (shape[0] - 1) * stride + shape[1] * inner
    return torch.as_strided(t, (n,), (1,), t.storage_offset()).numpy(), stride


def _emulate(cs, coords, valid, scale=1, offset=(1, 1, 1), voxels=32):
    """The CUDA kernels' arithmetic, thread by thread: the plan map's fill
    and scatter, then query blocks of `voxels` voxels x 9 threads staging
    27-entry rows, written as 4-int words and a scalar tail into an output
    with guard entries past its end.  Returns (rulebook, map)."""
    b, p = cs.cmask.shape
    _, h, w = cs.shape
    cc, s_cc = _storage(cs.ccoords, (b, p, 2), 2, "ccoords")
    cm, s_cm = _storage(cs.cmask, (b, p), 1, "cmask")
    bits, s_bits = _storage(cs.bits, (b, p), 1, "bits")
    start, s_st = _storage(cs.cstart, (b, p), 1, "cstart")
    pmap = np.full(b * h * w, b * p, np.int64)
    for t in range(b * p):
        sb, sp = divmod(t, p)
        if cm[sb * s_cm + sp]:
            y, x = cc[sb * s_cc + 2 * sp], cc[sb * s_cc + 2 * sp + 1]
            if 0 <= y < h and 0 <= x < w:
                pmap[(sb * h + y) * w + x] = t
    q_per = coords.shape[1]
    zyx = coords.reshape(-1, 3).numpy()
    ok = valid.reshape(-1).numpy()
    n_q, miss = b * q_per, b * cs.row_cap
    out = np.full(n_q * 27 + 8, -7, np.int64)
    for q0 in range(0, n_q, voxels):
        stage = np.full(voxels * 27, -9, np.int64)
        for t in range(voxels * 9):
            vl, c = divmod(t, 9)
            q = q0 + vl
            if q >= n_q:
                continue
            res = [miss] * 3
            if ok[q]:
                qb = q // q_per
                zb = int(zyx[q, 0]) * scale - offset[0]
                y = int(zyx[q, 1]) * scale - offset[1] + c // 3
                x = int(zyx[q, 2]) * scale - offset[2] + c % 3
                if 0 <= y < h and 0 <= x < w:
                    # the map of sample qb holds only its own slots
                    sp = int(pmap[(qb * h + y) * w + x]) - qb * p
                    if 0 <= sp < p:
                        word = int(bits[qb * s_bits + sp]) & _U64
                        first = int(start[qb * s_st + sp])
                        for dz in range(3):
                            z = zb + dz
                            if 0 <= z < 64 and (word >> z) & 1:
                                row = first + bin(word & ((1 << z) - 1)
                                                  ).count("1")
                                if 0 <= row - qb * cs.row_cap < cs.row_cap:
                                    res[dz] = row
            for dz in range(3):
                stage[vl * 27 + dz * 9 + c] = res[dz]
        n_int = min(voxels, n_q - q0) * 27
        for i in range(n_int // 4):
            out[q0 * 27 + 4 * i:q0 * 27 + 4 * i + 4] = stage[4 * i:4 * i + 4]
        for i in range(n_int // 4 * 4, n_int):
            out[q0 * 27 + i] = stage[i]
    assert (out[n_q * 27:] == -7).all(), "a block wrote past the output"
    return out[:n_q * 27].reshape(b, q_per, 27), pmap


SCENES = {
    "random": dict(v=300, shape=(12, 20, 28), density=0.5),
    "edges": dict(v=320, shape=(10, 16, 24), density=0.4, edges=True),
    "full_column": dict(v=360, shape=(41, 12, 12), density=0.3,
                        full_column=True),
}


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_plan_map_matches_jax_plan_table(scene):
    kw = dict(SCENES[scene])
    v, shape = kw.pop("v"), kw.pop("shape")
    coords, mask = _scene(3, v, shape, **kw)
    (jcs, _, _), (tcs, _, _) = _cols(coords, mask, shape)
    _, h, w = shape
    ref = np.asarray(_j_plan(jcs))[:B * h * w]   # the last entry is scratch
    got = teq.plan_map_plain(tcs)
    assert got.dtype == torch.int32 and got.shape == (B * h * w,)
    _eq(got, ref)
    _eq(_emulate(tcs, T(coords).long(), T(mask))[1], ref)
    assert (ref < B * tcs.cmask.shape[1]).sum() == int(tcs.cmask.sum())


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_map_query_matches_jax_subm(scene):
    kw = dict(SCENES[scene])
    v, shape = kw.pop("v"), kw.pop("shape")
    coords, mask = _scene(4, v, shape, **kw)
    (jcs, jvcol, jvz), (tcs, _, _) = _cols(coords, mask, shape)
    ref = _j_subm(jcs, jvcol, jvz, jnp.asarray(mask))
    tc, tm = T(coords).long(), T(mask)
    got = tbr.subm_rulebook_eqmatch(tcs, tc, tm)   # the wrapper, on the CPU
    assert got.dtype == torch.int32
    _eq(got, ref)
    _eq(_emulate(tcs, tc, tm)[0], ref)
    if scene == "full_column":
        assert (tcs.bits == (1 << 41) - 1).sum() == B


def test_map_query_capacity_overflow():
    """A stage-1 column set whose sites overflow its capacity: a neighbour
    whose row lies past the capacity misses."""
    shape, pad, cap = (8, 16, 16), (1, 1, 1), 96
    coords, mask = _scene(5, 400, shape, 0.9)
    (jcs, _, _), (tcs, _, _) = _cols(coords, mask, shape)
    jcs_o, jvcol, jvz, jvm, _, _ = _j_down(jcs, pad, cap)
    tcs_o, _, tvz, tvm, _, tvyx = tbr.strided_downsample_bitmap(tcs, pad,
                                                                 cap)
    assert bool(tvm.all())
    sites = teq.popcount64(tcs_o.bits).sum(1)
    assert bool((sites > cap).all()), "every sample must overflow"
    ref = _j_subm(jcs_o, jvcol, jvz, jvm)
    tc = torch.cat([tvz[..., None], tvyx], -1)
    _eq(teq.eqmatch_rulebook(tcs_o, tc, tvm), ref)
    _eq(_emulate(tcs_o, tc, tvm)[0], ref)
    # rows past the capacity were found in the words and dropped
    uncapped = tbr.ColumnSet(tcs_o.ccoords, tcs_o.cmask, tcs_o.cstart,
                             tcs_o.bits, tcs_o.shape, row_cap=10 ** 6)
    wide = teq.column_query_plain(uncapped, teq.plan_map_plain(uncapped),
                                  tc, tvm)
    assert bool(((wide != B * 10 ** 6) &
                 (torch.tensor(np.asarray(ref)) == B * cap)).any())


@pytest.mark.parametrize("pad", [(1, 1, 1), (0, 1, 1)])
def test_strided_query_matches_jax(pad):
    """The query at scale 2, offset pad is the stride-2 rulebook."""
    shape, cap = (12, 20, 28), 256
    coords, mask = _scene(6, 400, shape, 0.6, edges=True)
    (jcs, _, _), (tcs, _, _) = _cols(coords, mask, shape)
    ref = _j_down(jcs, pad, cap)[4]
    _, _, tvz, tvm, _, tvyx = tbr.strided_downsample_bitmap(tcs, pad, cap)
    tc = torch.cat([tvz[..., None], tvyx], -1)
    _eq(teq.eqmatch_rulebook(tcs, tc, tvm, scale=2, offset=pad), ref)
    _eq(_emulate(tcs, tc, tvm, scale=2, offset=pad)[0], ref)


def test_map_query_matches_pallas_eqmatch_interpret():
    shape = (12, 24, 24)
    coords, mask = _scene(7, 512, shape, 0.5, edges=True)
    (jcs, jvcol, jvz), (tcs, _, _) = _cols(coords, mask, shape)
    ref = jbr.subm_rulebook_eqmatch(jcs, jnp.asarray(coords), jvcol, jvz,
                                    jnp.asarray(mask), wc=256, tm=128,
                                    interpret=True)
    _eq(teq.eqmatch_rulebook(tcs, T(coords).long(), T(mask)), ref)


def test_wrappers_take_no_other_device():
    """Off the CPU and the card a wrapper has no kernel and raises."""
    coords, mask = _scene(8, 64, (6, 8, 8), 0.5)
    _, (tcs, _, _) = _cols(coords, mask, (6, 8, 8))
    meta = tbr.ColumnSet(*(t.to("meta") for t in (
        tcs.ccoords, tcs.cmask, tcs.cstart, tcs.bits)), tcs.shape,
        tcs.row_cap)
    with pytest.raises(RuntimeError, match="no kernel"):
        teq.plan_map(meta)
    with pytest.raises(RuntimeError, match="no kernel"):
        teq.eqmatch_rulebook(meta, T(coords).long().to("meta"),
                             T(mask).to("meta"))
