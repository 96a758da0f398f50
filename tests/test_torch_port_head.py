"""PyTorch port vs JAX package: box geometry, rotated IoU and NMS, the
multi-level RoIAlign (pairs, patch, and the patch fallback's capacity
rule), the FPN's nearest upsampling and box decoding.

NMS keep sets, labels and valid flags are integers and must match exactly;
geometry and pooled features within 1e-5 (float32 op order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srfdet3d_tpu.geometry import boxes as jboxes
from srfdet3d_tpu.geometry import iou as jiou
from srfdet3d_tpu.models import head as jhead
from srfdet3d_tpu.models.fpn import _upsample_nearest
from srfdet3d_tpu.ops.roi_align import multilevel_roi_align as jroi
from srfdet3d_torch.geometry import boxes as tboxes
from srfdet3d_torch.geometry import iou as tiou
from srfdet3d_torch.models import head as thead
from srfdet3d_torch.models.fpn import upsample_nearest
from srfdet3d_torch.ops.roi_align import multilevel_roi_align, patch_fits

T = torch.from_numpy


def _close(t, j, tol=1e-5):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=tol, atol=tol)


def _bev_boxes(rng, n, spread=6.0):
    return np.concatenate([
        rng.uniform(-spread, spread, (n, 2)), rng.uniform(0.5, 4.0, (n, 2)),
        rng.uniform(-np.pi, np.pi, (n, 1))], -1).astype(np.float32)


def test_box_codecs_match_jax():
    rng = np.random.default_rng(0)
    code = np.concatenate([rng.normal(size=(64, 3)) * 5,
                           rng.normal(size=(64, 3)) * 0.5,
                           rng.normal(size=(64, 4))], -1).astype(np.float32)
    _close(tboxes.denormalize_bbox(T(code)),
           jboxes.denormalize_bbox(jnp.asarray(code)))
    for bottom in (True, False):
        _close(tboxes.boxes3d_to_corners3d(T(code[:, :8]), bottom, True),
               jboxes.boxes3d_to_corners3d(jnp.asarray(code[:, :8]), bottom,
                                           True), 1e-4)
    pc, vs = (-10.0, -10.0, -5.0, 10.0, 10.0, 3.0), (0.25, 0.25, 0.2)
    _close(thead.lidar_rois_from_boxes(T(code), pc, vs),
           jhead.lidar_rois_from_boxes(jnp.asarray(code), pc, vs), 1e-4)


def test_rotated_iou_matches_jax():
    rng = np.random.default_rng(1)
    a, b = _bev_boxes(rng, 48, 3.0), _bev_boxes(rng, 40, 3.0)
    ref = np.asarray(jiou.rotated_iou_bev(jnp.asarray(a), jnp.asarray(b)))
    assert (ref > 0.05).sum() > 50
    _close(tiou.rotated_iou_bev(T(a), T(b)), ref)


@pytest.mark.parametrize("thr", [0.1, 0.4])
def test_nms_keep_sets_match_jax(thr):
    rng = np.random.default_rng(2)
    n, c = 96, 3
    bev = _bev_boxes(rng, n, 4.0)
    scores = rng.uniform(0, 1, (c, n)).astype(np.float32)
    valid = scores > 0.2
    bev_c = np.broadcast_to(bev, (c, n, 5)).copy()
    ref = np.asarray(jiou.rotated_nms_bev(jnp.asarray(bev_c),
                                          jnp.asarray(scores), thr,
                                          jnp.asarray(valid)))
    got = tiou.rotated_nms_bev(T(bev_c), T(scores), thr, T(valid)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert 0 < ref.sum() < valid.sum(), "NMS must suppress some boxes"
    assert tiou.last_nms_sweeps >= 2


@pytest.mark.parametrize("use_nms", [True, False])
def test_decode_boxes_matches_jax(use_nms):
    rng = np.random.default_rng(3)
    b, n, c = 2, 64, 3
    logits = rng.normal(0, 1.5, (b, n, c)).astype(np.float32)
    boxes = np.concatenate([rng.uniform(-8, 8, (b, n, 2)),
                            rng.uniform(-1, 1, (b, n, 1)),
                            rng.normal(0.5, 0.3, (b, n, 3)),
                            rng.normal(size=(b, n, 4))], -1).astype(np.float32)
    kw = dict(use_nms=use_nms, nms_thr=0.2, score_thr=0.3, max_per_img=40,
              post_center_range=(-7.0, -7.0, -10.0, 7.0, 7.0, 10.0))
    ref = jhead.decode_boxes(jnp.asarray(logits), jnp.asarray(boxes), **kw)
    got = thead.decode_boxes(T(logits), T(boxes), **kw)
    for k in ("labels", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    _close(got["scores"], ref["scores"])
    _close(got["boxes"], ref["boxes"], 1e-4)
    assert 0 < got["valid"].sum() < got["valid"].numel()


def _pyramid(rng, b, c, sizes):
    return [rng.normal(size=(b, h, w, c)).astype(np.float32)
            for h, w in sizes]


@pytest.mark.parametrize("patch,fallback", [(0, -1), (8, -1), (8, 2),
                                            (4, 3)])
def test_roi_align_matches_jax(patch, fallback):
    rng = np.random.default_rng(4)
    b, r, c = 2, 30, 6
    sizes, strides = [(20, 24), (10, 12), (5, 6), (3, 3)], (8, 16, 32, 64)
    feats = _pyramid(rng, b, c, sizes)
    lo = rng.uniform(-20, 170, (b, r, 2))
    ext = np.exp(rng.uniform(0, 5.5, (b, r, 2)))       # 1 to 245 cells
    rois = np.concatenate([lo, lo + ext], -1).astype(np.float32)
    ref = np.stack([np.asarray(jroi(
        [jnp.asarray(f[i]) for f in feats], jnp.asarray(rois[i]), strides,
        patch=patch, patch_fallback=fallback)) for i in range(b)])
    got = multilevel_roi_align([T(f) for f in feats], T(rois), strides,
                               patch=patch, patch_fallback=fallback)
    _close(got, ref)
    if patch:
        mis = (~patch_fits(sizes, T(rois.reshape(-1, 4)), strides, patch)
               ).reshape(b, r).sum(1)
        if fallback >= 0:
            # the capacity rule is exercised: misfits past the slots pool 0
            assert (mis > fallback).all()
            assert (np.abs(ref).reshape(b, r, -1).max(-1) == 0).sum() >= \
                int((mis - fallback).sum())


@pytest.mark.parametrize("hw,out", [((5, 7), (10, 14)), ((3, 3), (12, 12)),
                                    ((23, 23), (46, 46))])
def test_nearest_upsample_matches_jax(hw, out):
    """The FPN's top-down path upsamples by integer factors only; there
    F.interpolate 'nearest' equals jax.image.resize 'nearest'."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2,) + hw + (3,)).astype(np.float32)
    ref = np.asarray(_upsample_nearest(jnp.asarray(x), out))
    got = upsample_nearest(T(x).permute(0, 3, 1, 2), out).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), ref)
