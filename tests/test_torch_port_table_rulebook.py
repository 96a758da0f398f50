"""PyTorch port vs JAX package: the table rulebook backend and K6's plain
version.  Every output is integer and must match exactly: lookups, output
sites, masks and rulebooks.

K6's plain version is held against the Pallas kernel
(`ops/pallas_rulebook.py::rulebook_lookup`) in interpret mode on sorted keys
with rows = arange, and against a numpy oracle with permuted rows.  The
rulebooks run on plan-major stage-0 voxels, the order the voxelizer emits
and the detector hands the encoder; there the JAX package's searchsorted
lookups miss (its keys are z-major), so the reference is its default dense
cell-table route, which does not depend on row order, and a numpy oracle
pins the same answer.  The backward kernels take table rulebooks as they
are: a table subm rulebook is its own reverse with the offsets flipped, and
encoder grads on the table backend match `jax.grad` within rtol 1e-4."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srfdet3d_tpu.models.sparse_encoder import SparseEncoder as JEncoder
from srfdet3d_tpu.models.sparse_encoder import _TableRulebooks
from srfdet3d_tpu.ops import sparse_conv as jsc
from srfdet3d_tpu.ops.pallas_rulebook import rulebook_lookup as j_lookup
from srfdet3d_torch.configs import tiny_kitti_test_config, tiny_test_config
from srfdet3d_torch.models.sparse_encoder import (SparseEncoder,
                                                  TableRulebooks)
from srfdet3d_torch.ops import gather_conv_bwd as gcb
from srfdet3d_torch.ops import sparse_conv as tsc
from srfdet3d_torch.ops.rulebook_lookup import (rulebook_lookup,
                                                rulebook_lookup_plain)
from srfdet3d_torch.utils.jax_params import jax_state_dict

B = 2
T = torch.from_numpy


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _scene(rng, b, v, shape, density=0.5):
    """Plan-major sorted voxels, invalid rows at each sample's tail."""
    d, h, w = shape
    n = int(v * density)
    coords = np.zeros((b, v, 3), np.int32)
    mask = np.zeros((b, v), bool)
    for s in range(b):
        cells = rng.choice(d * h * w, size=n - 3 * s, replace=False)
        z, yx = cells % d, cells // d
        y, x = yx // w, yx % w
        o = np.argsort((y * w + x) * d + z)
        coords[s, :len(o)] = np.stack([z[o], y[o], x[o]], -1)
        mask[s, :len(o)] = True
    return coords, mask


def _lookup_oracle(keys, rows, queries, sentinel):
    where = {int(k): int(r) for k, r in zip(keys, rows) if k < sentinel}
    n = len(keys)
    return np.vectorize(lambda q: where.get(int(q), n) if 0 <= q < sentinel
                        else n)(queries).astype(np.int32)


@pytest.mark.parametrize("k", [3, 9])
def test_lookup_plain_matches_pallas_interpret(k):
    rng = np.random.default_rng(k)
    cells, n_valid, n = 60_000, 1500, 1600
    keys = np.full(n, cells, np.int64)
    keys[:n_valid] = np.sort(rng.choice(cells, n_valid, replace=False))
    m = 256
    base = keys[np.sort(rng.integers(0, n_valid, m))]
    queries = base[:, None] + rng.integers(-30, 30, (1, k))   # many misses
    hits = rng.random((m, k)) < 0.4
    queries[hits] = keys[np.clip(np.arange(m)[:, None] * n_valid // m +
                                 np.arange(k) - k // 2, 0,
                                 n_valid - 1)][hits]          # near hits
    far = rng.random((m, k)) < 0.05                           # far off
    queries[far] = rng.integers(0, cells, far.sum())
    queries[rng.random((m, k)) < 0.1] = cells + 7             # invalid
    queries[rng.random((m, k)) < 0.02] = -3                   # invalid
    ref = np.asarray(j_lookup(jnp.asarray(keys.astype(np.int32)),
                              jnp.asarray(queries.astype(np.int32)), cells,
                              tm=128, interpret=True))
    got = rulebook_lookup_plain(T(keys), torch.arange(n, dtype=torch.int32),
                                T(queries), cells)
    assert got.dtype == torch.int32
    _eq(got, ref)
    assert (ref < n).sum() > m * k // 10
    # the wrapper takes the plain version on the CPU
    _eq(rulebook_lookup(T(keys), torch.arange(n, dtype=torch.int32),
                        T(queries), cells), ref)


def test_lookup_plain_permuted_rows():
    rng = np.random.default_rng(5)
    cells, n = 10_000, 700
    keys = np.sort(rng.choice(cells, n, replace=False)).astype(np.int64)
    keys[-40:] = cells                                       # masked rows
    rows = rng.permutation(n).astype(np.int32)
    queries = rng.integers(-2, cells + 3, (300, 27))
    hits = rng.random((300, 27)) < 0.5
    queries[hits] = keys[rng.integers(0, n - 40, hits.sum())]
    got = rulebook_lookup_plain(T(keys), T(rows), T(queries), cells)
    _eq(got, _lookup_oracle(keys, rows, queries, cells))
    assert (got < n).sum() >= hits.sum()


_j_sites = jax.jit(
    lambda c, m, shape, k, s, p, cap: jax.vmap(
        lambda c1, m1: jsc.generate_output_sites(
            jsc.SparseTensor(jnp.zeros((c1.shape[0], 1)), c1, m1, shape),
            k, s, p, cap))(c, m),
    static_argnums=(2, 3, 4, 5, 6))


@pytest.mark.parametrize("shape,kernel,stride,pad,cap,density", [
    ((12, 20, 28), (3, 3, 3), (2, 2, 2), (1, 1, 1), 300, 0.5),
    ((12, 20, 28), (3, 3, 3), (2, 2, 2), (0, 1, 1), 300, 0.5),
    ((6, 16, 16), (3, 3, 3), (2, 2, 2), (1, 1, 1), 64, 0.9),   # overflow
    ((5, 16, 16), (3, 1, 1), (2, 1, 1), (0, 0, 0), 500, 0.7),
])
def test_generate_output_sites_matches_jax(shape, kernel, stride, pad, cap,
                                           density):
    rng = np.random.default_rng(cap)
    coords, mask = _scene(rng, B, 400, shape, density)
    jc, jm = _j_sites(jnp.asarray(coords), jnp.asarray(mask), shape, kernel,
                      stride, pad, cap)
    tc, tm = tsc.generate_output_sites(T(coords).long(), T(mask), shape,
                                       kernel, stride, pad, cap)
    _eq(tm, jm)
    _eq(tc, jc)
    if cap == 64:
        assert tm.all(), "the overflow case must fill every site slot"


def _subm_oracle(coords, mask):
    """Numpy submanifold rulebook: global rows of each voxel's 27
    neighbours, z-major offsets, B * V the miss row."""
    b, v, _ = coords.shape
    where = {(s,) + tuple(coords[s, i]): s * v + i
             for s in range(b) for i in range(v) if mask[s, i]}
    offs = [(dz, dy, dx) for dz in (-1, 0, 1) for dy in (-1, 0, 1)
            for dx in (-1, 0, 1)]
    out = np.full((b, v, 27), b * v, np.int32)
    for s in range(b):
        for i in range(v):
            if mask[s, i]:
                z, y, x = coords[s, i]
                for j, (dz, dy, dx) in enumerate(offs):
                    out[s, i, j] = where.get((s, z + dz, y + dy, x + dx),
                                             b * v)
    return out


@partial(jax.jit, static_argnums=(2, 3, 4, 5, 6))
def _jax_rulebooks(coords, mask, shape, kernel, stride, pad, cap):
    table = jsc.make_key_table(coords, mask, shape)
    subm = jsc.subm_gather_indices_batched(coords, mask, shape, 3,
                                           key_table=table)
    oc, om = _j_sites(coords, mask, shape, kernel, stride, pad, cap)
    strided = jsc.strided_gather_indices_batched(
        coords, mask, shape, oc, om, kernel, stride, pad, key_table=table)
    return subm, strided


@pytest.mark.parametrize("shape,kernel,stride,pad,cap", [
    ((9, 16, 20), (3, 3, 3), (2, 2, 2), (1, 1, 1), 200),
    ((9, 16, 20), (3, 3, 3), (2, 2, 2), (0, 1, 1), 200),
    ((5, 16, 20), (3, 1, 1), (2, 1, 1), (0, 0, 0), 300),
])
def test_rulebooks_match_jax_on_plan_major_input(shape, kernel, stride, pad,
                                                 cap):
    rng = np.random.default_rng(11)
    coords, mask = _scene(rng, B, 300, shape, 0.6)
    jsubm, jstrided = _jax_rulebooks(jnp.asarray(coords), jnp.asarray(mask),
                                     shape, kernel, stride, pad, cap)
    tcoords, tmask = T(coords).long(), T(mask)
    table = tsc.make_key_table(tcoords, tmask, shape)
    tsubm = tsc.subm_gather_indices_batched(tcoords, tmask, shape, 3,
                                            key_table=table)
    oc, om = tsc.generate_output_sites(tcoords, tmask, shape, kernel, stride,
                                       pad, cap)
    tstrided = tsc.strided_gather_indices_batched(
        tcoords, tmask, shape, oc, om, kernel, stride, pad, key_table=table)
    _eq(tsubm, jsubm)
    _eq(tstrided, jstrided)
    _eq(tsubm, _subm_oracle(coords, mask))
    assert (tsubm.numpy() < B * 300).sum() > 2 * mask.sum()
    assert (tstrided.numpy() < B * 300).sum() >= mask.sum()
    # without a shared table, the functions build their own
    _eq(tsc.subm_gather_indices_batched(tcoords, tmask, shape), jsubm)


def test_reference_searchsorted_lookup_needs_key_order(monkeypatch):
    """The JAX package's searchsorted lookups (LOOKUP_METHOD 'sort', and
    'pallas' through K6's positions) read the key array as sorted; the
    voxelizer's plan-major stage-0 rows are not in z-major key order, so
    there they report false misses.  On z-major-sorted rows 'sort' agrees
    with the port; on plan-major rows only the dense table does, and the
    port gives the dense table's answer (the numpy oracle's)."""
    rng = np.random.default_rng(12)
    shape = (8, 16, 16)
    coords, mask = _scene(rng, 1, 400, shape, 0.75)
    order = np.argsort(np.where(mask[0], (coords[0, :, 0] * 16 +
                                          coords[0, :, 1]) * 16 +
                                coords[0, :, 2], 1 << 20), kind="stable")
    zmajor = coords[:, order]

    def jax_subm(c):
        return np.asarray(jsc.subm_gather_indices_batched(
            jnp.asarray(c), jnp.asarray(mask), shape))
    port = tsc.subm_gather_indices_batched(T(coords).long(), T(mask), shape)
    oracle = _subm_oracle(coords, mask)
    _eq(port, oracle)
    _eq(port, jax_subm(coords))                     # dense: any row order
    monkeypatch.setattr(jsc, "LOOKUP_METHOD", "sort")
    np.testing.assert_array_equal(jax_subm(zmajor), _subm_oracle(zmajor,
                                                                 mask))
    sort_hits = int((jax_subm(coords) < 400).sum())
    assert sort_hits < (oracle < 400).sum() // 2


_WALK = ((1, 300), (1, 150), ((0, 1, 1), 100))


@partial(jax.jit, static_argnums=2)
def _jax_walk(coords, mask, shape, feats):
    rb = _TableRulebooks(coords, mask, shape)
    out = [rb.subm()]
    for pad, cap in _WALK:
        out += [rb.downsample(pad, cap), rb.mask, rb.coords, rb.subm()]
    out += [rb.convout(90), rb.mask, rb.coords, rb.dense(feats)]
    return out


def test_table_walk_matches_jax():
    """The whole _TableRulebooks walk of a conv_module encoder: every
    rulebook, site list and mask, and the dense scatter."""
    rng = np.random.default_rng(3)
    shape = (41, 24, 24)
    coords, mask = _scene(rng, B, 500, shape, 0.6)
    feats = rng.normal(size=(B, 90, 4)).astype(np.float32)
    ref = _jax_walk(jnp.asarray(coords), jnp.asarray(mask), shape,
                    jnp.asarray(feats))
    trb = TableRulebooks(T(coords).long(), T(mask), shape)
    got = [trb.subm()]
    for pad, cap in _WALK:
        got += [trb.downsample(pad, cap), trb.mask, trb.coords, trb.subm()]
    got += [trb.convout(90), trb.mask, trb.coords, trb.dense(T(feats))]
    assert trb.shape == (2, 3, 3)
    assert len(got) == len(ref)
    for t, j in zip(got, ref):
        _eq(t, j)


def test_table_subm_rulebook_is_its_own_reverse():
    """K3's symmetric backward rests on idx[m, j] = r <=> idx[r, 26-j] = m:
    true of the table backend's subm rulebooks, on plan-major stage-0
    voxels and on key-sorted later stages."""
    rng = np.random.default_rng(4)
    shape = (9, 16, 16)
    coords, mask = _scene(rng, B, 400, shape, 0.7)
    rb = TableRulebooks(T(coords).long(), T(mask), shape)
    for stage in range(2):
        flat = rb.subm().reshape(-1, 27)
        n = flat.shape[0]
        assert int((flat < n).sum()) > 2 * int(rb.mask.sum())
        _eq(gcb.reverse_rulebook(flat, n), flat.flip(1).numpy())
        if stage == 0:
            rb.downsample(1, 300)


@pytest.mark.parametrize("cfg", [tiny_kitti_test_config(), tiny_test_config()],
                         ids=["conv_module", "basicblock"])
def test_table_encoder_grads_match_jax(cfg):
    """Encoder grads (every kernel, BN scale and bias) and the train-mode
    output on the table backend against jax.grad; the backward is K3 for
    the subm convs and K4 for the strided ones (their plain versions
    here)."""
    m = cfg.middle
    shape = cfg.voxelization.sparse_shape
    rng = np.random.default_rng(8)
    v = 400
    coords, mask = _scene(rng, B, v, shape, 0.7)
    feats = rng.normal(size=(B, v, m.in_channels)).astype(np.float32)
    caps = (300, 150, 80, 80)
    enc = JEncoder(in_channels=m.in_channels, sparse_shape=shape,
                   base_channels=m.base_channels,
                   output_channels=m.output_channels,
                   encoder_channels=m.encoder_channels,
                   encoder_paddings=m.encoder_paddings,
                   block_type=m.block_type, capacities=caps,
                   rulebook="table", presorted=True)
    args = (jnp.asarray(feats), jnp.asarray(coords), jnp.asarray(mask))
    variables = jax.jit(partial(enc.init, train=False))(
        jax.random.PRNGKey(0), *args)
    out_shape = jax.eval_shape(partial(enc.apply, train=False), variables,
                               *args).shape
    g = rng.normal(size=out_shape).astype(np.float32)

    def loss(params):
        out, _ = enc.apply({"params": params,
                            "batch_stats": variables["batch_stats"]}, *args,
                           train=True, mutable=["batch_stats"])
        return jnp.sum(out * g), out
    (_, ref_out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])

    port = SparseEncoder(m.in_channels, shape, m.base_channels,
                         m.output_channels, m.encoder_channels,
                         m.encoder_paddings, caps, block_type=m.block_type,
                         rulebook="table")
    assert not port.use_bitmap
    wrap = {k: {"pts_middle_encoder": v} for k, v in
            jax.tree_util.tree_map(np.asarray, variables).items()}
    state = jax_state_dict(wrap, 1, 0)
    pre = "pts_middle_encoder."
    port.load_state_dict({k[len(pre):]: T(np.array(a))
                          for k, a in state.items()}, strict=True)
    port.train()
    out = port(T(feats), T(coords).long(), T(mask))
    (out * T(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               rtol=1e-4, atol=1e-4)
    ref = jax_state_dict({"params": {"pts_middle_encoder": jax.tree_util
                                     .tree_map(np.asarray, grads)}}, 1, 0)
    params = dict(port.named_parameters())
    assert len(ref) == len(params)
    for key, want in ref.items():
        got = params[key[len(pre):]].grad.numpy()
        scale = np.abs(want).max()
        assert scale > 0, key
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=key)
