"""PyTorch port vs JAX package: the RoIAlign capacity rules of the patch
and xpatch options, on the BEV path and on the camera-summed image path,
and the voxelizer's per-voxel point counts.

multilevel_roi_align and pooled_img_roi with `patch` (the P x P fit test)
and `xpatch` (x alone) at fallbacks -1 (every misfit exact), 0 (every
misfit zero) and k (the first k misfits of each image row exact, in RoI
order; after the image cap's compaction where there is one): values
within 1e-5 of JAX's (its window gathers evaluate the same bilinear
samples as matmuls), the zeroed rows exactly zero on both sides, fallback
-1 equal to the pairs route.  Voxelizer num_points, coords and slots
exactly equal to JAX's with with_counts=True, zeros without."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srfdet3d_tpu.models import head as jhead
from srfdet3d_tpu.ops import roi_align as jroi
from srfdet3d_tpu.ops import voxelize as jvox
from srfdet3d_torch.config import VoxelizationSpec
from srfdet3d_torch.models import head as thead
from srfdet3d_torch.ops.roi_align import multilevel_roi_align, patch_fits
from srfdet3d_torch.ops.voxelize import voxelize_points_batched
from test_torch_port_lc_head import IMG_STRIDES, N_CAM, _img_levels, _rois
from test_torch_port_voxelize import _PC, _points

T = torch.from_numpy
BEV_SHAPES = ((24, 20), (12, 10), (6, 5))
BEV_STRIDES = (8, 16, 32)
ROUTES = [("patch", 4, -1), ("patch", 4, 0), ("patch", 4, 3),
          ("xpatch", 4, -1), ("xpatch", 4, 0), ("xpatch", 4, 2)]


def _bev_case(seed, b=2, r=40):
    """BEV levels and RoIs of every aspect: long in x, long in y, large
    (the top level), partly off the map."""
    rng = np.random.default_rng(seed)
    feats = [rng.normal(0, 1, (b, h, w, 8)).astype(np.float32)
             for h, w in BEV_SHAPES]
    ctr = rng.uniform((-20, -20), (180, 210), (b, r, 2))
    size = rng.uniform(4, 60, (b, r, 2)) * rng.choice(
        [1.0, 4.0], (b, r, 2), p=[0.7, 0.3])
    rois = np.concatenate([ctr - size / 2, ctr + size / 2], -1)
    return feats, rois.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_mla(route, size, fallback):
    kw = {route: size, f"{route}_fallback": fallback} if route else {}
    return jax.jit(jax.vmap(lambda f, r: jroi.multilevel_roi_align(
        list(f), r, BEV_STRIDES, **kw)))


def _zero_rows(x):
    return np.all(x.reshape(x.shape[0], x.shape[1], -1) == 0, -1)


@pytest.mark.parametrize("route,size,fallback", ROUTES)
def test_bev_roi_align_rules_match_jax(route, size, fallback):
    feats, rois = _bev_case(0)
    want = np.asarray(_jax_mla(route, size, fallback)(feats, rois))
    got = multilevel_roi_align([T(f) for f in feats], T(rois), BEV_STRIDES,
                               **{route: size, f"{route}_fallback": fallback}
                               ).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    zero = _zero_rows(want)
    np.testing.assert_array_equal(_zero_rows(got), zero)
    fits = patch_fits(BEV_SHAPES, T(rois.reshape(-1, 4)), BEV_STRIDES, size,
                      x_only=route == "xpatch").numpy().reshape(2, -1)
    # the misfits past the first `fallback` of each sample pool to zeros,
    # the rest to the pairs route's values (zero where every sample falls
    # off the map)
    order = np.cumsum(~fits, 1)
    dropped = ~fits & (order > (fits.shape[1] if fallback < 0 else
                                fallback))
    assert (~fits).sum(1).min() > max(fallback, 0)
    pairs = multilevel_roi_align([T(f) for f in feats], T(rois),
                                 BEV_STRIDES).numpy()
    np.testing.assert_array_equal(zero, dropped | _zero_rows(pairs))
    np.testing.assert_array_equal(got[~dropped], pairs[~dropped])


def test_xpatch_tests_x_alone():
    """A RoI long in y alone fits xpatch and misfits patch."""
    feats, rois = _bev_case(1)
    flat = T(rois.reshape(-1, 4))
    full = patch_fits(BEV_SHAPES, flat, BEV_STRIDES, 4).numpy()
    xonly = patch_fits(BEV_SHAPES, flat, BEV_STRIDES, 4, x_only=True).numpy()
    assert (full <= xonly).all() and (xonly & ~full).any()


@functools.lru_cache(maxsize=None)
def _jax_pooled(cap, route, size, fallback):
    kw = {route: size, f"{route}_fallback": fallback}
    return jax.jit(lambda f, r: jhead.pooled_img_roi(
        f, r, IMG_STRIDES, 7, cap=cap, **kw))


@pytest.mark.parametrize("cap", [0, 12])
@pytest.mark.parametrize("route,size,fallback", ROUTES)
def test_pooled_img_roi_rules_match_jax(cap, route, size, fallback):
    """2 samples x 2 cameras x 48 projected proposals; the capacity rule
    counts per (sample, camera) row, after the cap's compaction."""
    h, w, n = 64, 128, 48
    boxes, l2i = _rois(2, n, h, w, seed=2)
    rois = np.array(jhead.img_rois_from_boxes(jnp.asarray(boxes),
                                              jnp.asarray(l2i)), np.float32)
    feats = _img_levels(np.random.default_rng(3), 2, h, w, 8)
    want = np.asarray(_jax_pooled(cap, route, size, fallback)(
        [jnp.asarray(f) for f in feats], jnp.asarray(rois)))
    flat = [T(f.reshape((2 * N_CAM,) + f.shape[2:])) for f in feats]
    got = thead.pooled_img_roi(
        flat, T(rois), IMG_STRIDES, 7, cap=cap,
        **{route: size, f"{route}_fallback": fallback}).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(_zero_rows(got), _zero_rows(want))
    pairs = thead.pooled_img_roi(flat, T(rois), IMG_STRIDES, 7,
                                 cap=cap).numpy()
    if fallback < 0:
        np.testing.assert_array_equal(got, pairs)
    else:
        # some (camera, proposal) pairs were dropped
        assert not np.allclose(got, pairs, atol=1e-3)


@pytest.mark.parametrize("cap_pts", [4, -1])
def test_voxelizer_counts_match_jax(cap_pts):
    """num_points exactly JAX's (the points each voxel keeps under the
    per-voxel cap, or all of them), over a voxel capacity overflow."""
    rng = np.random.default_rng(8)
    pts, mask = _points(rng, 3, 512, 400)
    kw = dict(voxel_size=(1.0, 1.0, 0.5), point_cloud_range=_PC,
              max_num_points=cap_pts, max_voxels=96)
    jv = jvox.voxelize_points_batched(jnp.asarray(pts), jnp.asarray(mask),
                                      jvox.VoxelizationSpec(**kw),
                                      with_counts=True)
    tspec = VoxelizationSpec(**kw)
    tv = voxelize_points_batched(T(pts), T(mask), tspec)
    np.testing.assert_array_equal(tv.num_points.numpy(),
                                  np.asarray(jv.num_points))
    np.testing.assert_array_equal(tv.point_voxel_idx.numpy(),
                                  np.asarray(jv.point_voxel_idx))
    np.testing.assert_array_equal(tv.voxel_mask.numpy(),
                                  np.asarray(jv.voxel_mask))
    counts = tv.num_points.numpy()
    assert counts.max() == (cap_pts if cap_pts > 0 else counts.max()) > 1
    np.testing.assert_array_equal(counts > 0, tv.voxel_mask.numpy())
    off = voxelize_points_batched(T(pts), T(mask), tspec, with_counts=False)
    assert not off.num_points.any()
    np.testing.assert_array_equal(off.point_voxel_idx.numpy(),
                                  tv.point_voxel_idx.numpy())
