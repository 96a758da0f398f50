"""PyTorch port vs JAX package: the strided sparse-conv backward (K4)
through its row grouping.

Real tiny rulebooks, batch 2: the `tiny_test_config` scene voxelized by the
port, its first strided downsample (3x3x3, stride 2) and conv_out (3x1x1
along z, stride 2).  The kernel path orders the input rows stably by their
lowest hit offset (`group_rows_plain`, the plain version of the card's
counting sort) and runs the dfeats gather-GEMM over the rows in that
order, writing each row back to its own place.  Held here: the order is a
stable permutation; each group's rows hit only the offsets of their
coordinate-parity class, so a tile of grouped rows issues fewer offset
steps; dfeats and dW through the grouping equal `scatter_bwd_plain` and
`jax.vjp` of the JAX package's `gathered_conv_apply_batched` within rtol
1e-5 plus an atol of 1e-5 * sqrt(terms summed): K * Cout for dfeats, the N
input rows for dW (float32 sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srfdet3d_tpu.ops.sparse_conv import \
    gathered_conv_apply_batched as j_apply
from srfdet3d_torch.configs import tiny_test_config
from srfdet3d_torch.models.sparse_encoder import BitmapRulebooks
from srfdet3d_torch.ops import gather_conv_bwd as gcb
from srfdet3d_torch.ops.voxelize import voxelize_points_batched

B = 2


@pytest.fixture(scope="module")
def strided():
    """{name: (input rows N, rulebook (B, M, K))} of the tiny scene's first
    downsample and conv_out."""
    cfg = tiny_test_config()
    spec, m = cfg.voxelization, cfg.middle
    rng = np.random.default_rng(11)
    p = cfg.points_cap
    pts = np.zeros((B, p, 5), np.float32)
    pts[:, :1500, :2] = rng.uniform(-9, 9, (B, 1500, 2))
    pts[:, :1500, 2] = rng.uniform(-4, 2, (B, 1500))
    mask = np.zeros((B, p), bool)
    mask[:, :1500] = True
    vox = voxelize_points_batched(torch.from_numpy(pts),
                                  torch.from_numpy(mask), spec)
    rb = BitmapRulebooks(vox.voxel_coords, vox.voxel_mask,
                         spec.sparse_shape)
    rb.subm()
    down = rb.downsample(m.encoder_paddings[0][-1], m.capacities[0])
    n_down = B * spec.max_voxels
    # walk to the last level (a downsample leaves each level but the
    # last), then conv_out over its rows
    last = len(m.encoder_channels) - 1
    for i in range(1, last):
        rb.subm()
        rb.downsample(m.encoder_paddings[i][-1], m.capacities[i])
    out = rb.convout(m.capacities[-1])
    return {"down0": (n_down, down),
            "conv_out": (B * m.capacities[last - 1], out)}


def _class(j: int, k: int):
    """The coordinate-parity class of offset j: per strided axis, is the
    offset the kernel's middle one (an odd input parity) or not."""
    if k == 27:
        return (j // 9 == 1, (j // 3) % 3 == 1, j % 3 == 1)
    assert k == 3
    return (j == 1,)


@pytest.mark.parametrize("name", ["down0", "conv_out"])
def test_group_rows_is_a_stable_permutation(strided, name):
    n, idx = strided[name]
    flat = idx.reshape(-1, idx.shape[-1])
    m, k = flat.shape
    rev, perm = gcb.strided_prep(flat, n)
    assert torch.equal(rev, gcb.reverse_rulebook(flat, n))
    p = perm.long().numpy()
    np.testing.assert_array_equal(np.sort(p), np.arange(n))
    keys = gcb.group_keys(rev, m).numpy()
    kp = keys[p]
    assert (np.diff(kp) >= 0).all()
    same = kp[1:] == kp[:-1]
    assert (np.diff(p)[same] > 0).all()
    # the key is the lowest hit offset, K for a row that hits none
    hits = rev.numpy() < m
    for r in range(0, n, 97):
        want = np.flatnonzero(hits[r])[0] if hits[r].any() else k
        assert keys[r] == want
    assert gcb.strided_prep(flat, n, group=False)[1] is None


@pytest.mark.parametrize("name", ["down0", "conv_out"])
def test_groups_hit_only_their_class_offsets(strided, name):
    n, idx = strided[name]
    flat = idx.reshape(-1, idx.shape[-1])
    m, k = flat.shape
    rev, perm = gcb.strided_prep(flat, n)
    hits = rev.numpy() < m
    keys = gcb.group_keys(rev, m).numpy()
    live = np.flatnonzero(keys < k)
    assert len(live) > n // 20
    classes = set()
    for r in live:
        cls = _class(int(keys[r]), k)
        classes.add(cls)
        for j in np.flatnonzero(hits[r]):
            assert _class(int(j), k) == cls
    assert len(classes) == (8 if k == 27 else 2)
    # so tiles of grouped rows issue fewer offset steps than tiles in
    # voxel order, and never fewer than the hits need
    for bm in (64, 128):
        ident = gcb.tile_offset_steps(rev, m, None, bm)
        grouped = gcb.tile_offset_steps(rev, m, perm, bm)
        least = gcb.tile_offset_steps(rev, m, perm, 1) / bm
        assert least <= grouped < ident


def _jax_vjp(feats, idx, w, g):
    _, vjp = jax.vjp(lambda f, kk: j_apply(f, jnp.asarray(idx), kk,
                                           subm=False),
                     jnp.asarray(feats), jnp.asarray(w))
    dfe, dw = vjp(jnp.asarray(g))
    return np.asarray(dfe), np.asarray(dw)


@pytest.mark.parametrize("name,cin,cout", [("down0", 8, 16),
                                           ("down0", 16, 32),
                                           ("conv_out", 16, 16)])
def test_grouped_bwd_matches_scatter_and_jax(strided, name, cin, cout):
    n, idx = strided[name]
    v = n // B
    k = idx.shape[-1]
    rng = np.random.default_rng(cin + cout)
    feats = rng.normal(size=(B, v, cin)).astype(np.float32)
    w = (rng.normal(size=(k, cin, cout)) / np.sqrt(k * cin)).astype(
        np.float32)
    g = rng.normal(size=(B, idx.shape[1], cout)).astype(np.float32)
    ref_dfe, ref_dw = _jax_vjp(feats, idx.numpy(), w, g)
    tol_f = dict(rtol=1e-5, atol=1e-5 * np.sqrt(k * cout))
    tol_w = dict(rtol=1e-5, atol=1e-5 * np.sqrt(n))
    f2 = torch.from_numpy(feats).reshape(-1, cin)
    g2 = torch.from_numpy(g).reshape(-1, cout)
    w_t = torch.from_numpy(w)
    flat = idx.reshape(-1, k)
    rev, perm = gcb.strided_prep(flat, n)
    dfe, dw = gcb.grouped_bwd_plain(f2, rev, perm, w_t, g2)
    sfe, sdw = gcb.scatter_bwd_plain(f2, flat, w_t, g2)
    np.testing.assert_allclose(dfe.numpy(), sfe.numpy(), **tol_f)
    np.testing.assert_allclose(dw.numpy(), sdw.numpy(), **tol_w)
    np.testing.assert_allclose(dfe.numpy(), ref_dfe.reshape(-1, cin), **tol_f)
    np.testing.assert_allclose(dw.numpy(), ref_dw, **tol_w)
