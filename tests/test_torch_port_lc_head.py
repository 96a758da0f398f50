"""The port's fusion path of the SRFDet head against the JAX package's, on
the CPU: image RoIs from projected boxes (boxes behind a camera included),
the visible-pair counts and the pair compaction, the camera-summed image
RoIAlign at every cap regime, the image DPG's nearest resize, and whole
fusion head forwards.

Integers (counts, compacted pairs) match exactly; float outputs within the
tolerance each test states."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from srfdet3d_tpu.models import head as jhead
from srfdet3d_torch.models import head as thead
from srfdet3d_torch.utils.jax_params import jax_state_dict
from torch_port_common import lidar2img_rig, random_variables

T = torch.from_numpy
PC_RANGE = (-4.8, -4.8, -5.0, 4.8, 4.8, 3.0)
VOXEL_SIZE = (0.075, 0.075, 0.2)
STRIDES = (8, 16, 32, 64)
IMG_STRIDES = (4, 8, 16, 32)
N_CAM = 2


def _boxes(rng, b, n):
    """(b, n, 10) boxes with absolute centers over x in [-4.5, 4.5]: some
    lie behind one of the cameras, some straddle its plane."""
    ctr = rng.uniform((-4.5, -2.0, -1.0), (4.5, 2.0, 1.0), (b, n, 3))
    yaw = rng.uniform(-np.pi, np.pi, (b, n, 1))
    return np.concatenate([
        ctr, np.log(rng.uniform(0.5, 2.5, (b, n, 3))), np.sin(yaw),
        np.cos(yaw), rng.normal(0, 1, (b, n, 2))], -1).astype(np.float32)


def _rois(b, n, h, w, seed):
    rng = np.random.default_rng(seed)
    boxes = _boxes(rng, b, n)
    l2i = np.broadcast_to(lidar2img_rig(N_CAM, h, w),
                          (b, N_CAM, 4, 4)).copy()
    return boxes, l2i


def _np(x):
    """A writable float32 copy of a JAX array."""
    return np.array(x, np.float32)


def test_img_rois_from_boxes_behind_the_camera():
    """Projected RoIs within 1e-4 relative: x / z divides by depths near
    zero for boxes that straddle a camera's plane, which multiplies the
    last-bit difference of the 4-term projection sums by |x| / |z|.  The
    boxes behind a camera project through the 1e-5 depth clamp to RoIs of
    about 1e6 px or more on both sides, finite."""
    boxes, l2i = _rois(2, 64, 64, 128, seed=0)
    want = np.asarray(jhead.img_rois_from_boxes(jnp.asarray(boxes),
                                                jnp.asarray(l2i)))
    got = thead.img_rois_from_boxes(T(boxes), T(l2i)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    assert np.isfinite(got).all()
    huge = (got[..., 0] < -1e6) & (got[..., 2] > 1e6)
    assert huge.any() and not huge.all()


@pytest.mark.parametrize("hw", [(64, 128), (32, 96), (928, 1600)])
def test_visible_pair_counts_exact(hw):
    """Counts per (sample, camera), exact, on three image sizes; the
    visible mask itself too."""
    boxes, l2i = _rois(2, 128, *hw, seed=1)
    rois = _np(jhead.img_rois_from_boxes(jnp.asarray(boxes),
                                         jnp.asarray(l2i)))
    want = np.asarray(jhead.visible_pair_counts(jnp.asarray(rois), hw,
                                                IMG_STRIDES))
    got = thead.visible_pair_counts(T(rois), hw, IMG_STRIDES).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        thead.visible_mask(T(rois), hw, IMG_STRIDES).numpy(),
        np.asarray(jhead._visible_mask(jnp.asarray(rois), hw, IMG_STRIDES)))
    assert 0 < want.min() and want.max() < 128


def _img_levels(rng, b, h, w, c):
    return [rng.normal(0, 1, (b, N_CAM, h // s, w // s, c)
                       ).astype(np.float32) for s in IMG_STRIDES]


@pytest.mark.parametrize("cap", [0, 96, 12])
def test_pooled_img_roi_matches_jax(cap):
    """Camera-summed image RoIAlign on 2 samples x 2 cameras x 48
    proposals: every pair (cap 0), a cap that every camera's visible
    pairs fit (96), and a cap below the visible counts (12), where the
    pairs past it are dropped.  The compacted pairs (each slot's
    proposal) equal the first `cap` visible ones of each camera in
    proposal order, exactly; the pooled features within 1e-5."""
    h, w, n = 64, 128, 48
    boxes, l2i = _rois(2, n, h, w, seed=2)
    rois = _np(jhead.img_rois_from_boxes(jnp.asarray(boxes),
                                         jnp.asarray(l2i)))
    feats = _img_levels(np.random.default_rng(3), 2, h, w, 8)
    want = np.asarray(jhead.pooled_img_roi(
        [jnp.asarray(f) for f in feats], jnp.asarray(rois), IMG_STRIDES, 7,
        cap=cap))
    flat = [T(f.reshape((2 * N_CAM,) + f.shape[2:])) for f in feats]
    got = thead.pooled_img_roi(flat, T(rois), IMG_STRIDES, 7, cap=cap)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    counts = np.asarray(jhead.visible_pair_counts(jnp.asarray(rois), (h, w),
                                                  IMG_STRIDES))
    if not cap:
        return
    vis = np.asarray(jhead._visible_mask(jnp.asarray(rois), (h, w),
                                         IMG_STRIDES)).reshape(-1, n)
    _, src = thead.compact_pairs(T(rois), (h, w), IMG_STRIDES, cap)
    for row, v in enumerate(vis):
        kept = np.flatnonzero(v)[:cap]
        np.testing.assert_array_equal(
            src[row].numpy(), np.pad(kept, (0, cap - len(kept)),
                                     constant_values=n))
    every = np.asarray(jhead.pooled_img_roi(
        [jnp.asarray(f) for f in feats], jnp.asarray(rois), IMG_STRIDES, 7))
    if cap >= counts.max():
        # the compaction is exact while every camera's pairs fit
        np.testing.assert_allclose(want, every, rtol=1e-5, atol=1e-5)
    else:
        assert not np.allclose(want, every, atol=1e-3)


@pytest.mark.parametrize("out", [30, 15])
def test_dpg_nearest_resize_matches_jax(out):
    """The image DPG's resize for every input size 1-79 to 30 and to 15:
    equal to the JAX package's float64 floor(i * in / out) index.
    F.interpolate's own 'nearest' is another function: at 70 -> 30 it
    picks other rows."""
    rng = np.random.default_rng(4)
    for n in range(1, 80):
        x = rng.normal(0, 1, (1, n, n + 1, 2)).astype(np.float32)
        want = np.asarray(jhead._torch_nearest_resize(jnp.asarray(x),
                                                      (out, out)))
        got = thead.torch_nearest_resize(T(x).permute(0, 3, 1, 2),
                                         (out, out))
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    if out == 30:
        x = torch.arange(70.0).reshape(1, 1, 70, 1)
        assert not torch.equal(
            F.interpolate(x, size=(30, 1), mode="nearest"),
            thead.torch_nearest_resize(x, (30, 1)))


def _fusion_heads(is_kitti, cap, bs, lvl_hw, img_hw, seed):
    """The JAX fusion SRFDetHead and the port's on the same seeded
    weights, and their outputs on the same seeded inputs (LiDAR 32
    channels, images 24 channels reduced to 32 by img_conv)."""
    ch, ch_img, n_p, n_heads = 32, 24, 8, 2
    rng = np.random.default_rng(seed)
    pts = [rng.normal(0, 0.5, (bs, s, s, ch)).astype(np.float32)
           for s in (16, 8, 4, 2)]
    imgs = [rng.normal(0, 0.5, (bs, N_CAM, h, w, ch_img)).astype(np.float32)
            for h, w in lvl_hw]
    l2i = np.broadcast_to(lidar2img_rig(N_CAM, *img_hw),
                          (bs, N_CAM, 4, 4)).copy()
    common = dict(num_proposals=n_p, num_heads=n_heads, num_dpg_exp=2,
                  pc_range=PC_RANGE, voxel_size=VOXEL_SIZE,
                  dim_feedforward=64, num_attn_heads=4, dynamic_dim=8,
                  lidar_strides=STRIDES, img_strides=IMG_STRIDES,
                  img_roi_cap=cap, dropout=0.0)
    jmod = jhead.SRFDetHead(num_classes=3, feat_channels_lidar=ch,
                            feat_channels_img=ch_img, hidden_dim=ch,
                            use_img=True, is_kitti=is_kitti, **common)
    jin = ([jnp.asarray(f) for f in pts], [jnp.asarray(f) for f in imgs],
           jnp.asarray(l2i))
    shapes = jax.eval_shape(lambda r, *a: jmod.init(r, *a),
                            jax.random.PRNGKey(0), *jin)
    variables = random_variables(shapes, seed + 1)
    want = jax.device_get(jax.jit(jmod.apply)(variables, *jin))
    port = thead.SRFDetHead(3, ch, 4, 4, img_channels=ch_img,
                            hidden_dim=ch, img_levels=4,
                            img_dpg_hw=(30, 15) if is_kitti else (30, 30),
                            **common)
    wrapped = {c: {"bbox_head": t} for c, t in variables.items()}
    port.load_state_dict({k[len("bbox_head."):]: T(np.array(v)) for k, v in
                          jax_state_dict(wrapped, n_heads, 2).items()})
    port.eval()
    with torch.no_grad():
        got = port([T(f).permute(0, 3, 1, 2) for f in pts], None,
                   [T(f.reshape((-1,) + f.shape[2:])).permute(0, 3, 1, 2)
                    for f in imgs], T(l2i))
    return want, got


@pytest.mark.parametrize("is_kitti,cap", [(False, 0), (False, 3),
                                          (True, 0)])
def test_fusion_head_forward_matches_jax(is_kitti, cap):
    """One fusion SRFDetHead forward, 2 samples, 2 iterations: image
    levels 560 x 24 down to 70 x 3, so the DPG resizes 70 -> 30 rows
    (where F.interpolate would pick other rows) and 3 -> 30 or 3 -> 15
    columns (KITTI's (30, 15)); every pair pooled (cap 0) and 3 slots a
    camera, fewer than the visible pairs.  The first iteration's logits
    and boxes within 1e-4, the second's within 1e-3: its RoIs come from
    the first's boxes through projections near the cameras' planes, and
    the JAX head itself moves its second-iteration boxes by up to 1.2e-4
    when its LiDAR inputs change by one float32 ulp (seeds 5 and 6 at
    this geometry, measured on the CPU)."""
    lvl_hw = [(560, 24), (280, 12), (140, 6), (70, 3)]
    (wl, wb), (gl, gb) = _fusion_heads(is_kitti, cap, 2, lvl_hw,
                                       (2240, 96), seed=5)
    assert gl.shape == (2, 2, 8, 3) and gb.shape == (2, 2, 8, 10)
    for it, tol in ((0, 1e-4), (1, 1e-3)):
        np.testing.assert_allclose(gl[it].numpy(), wl[it], rtol=tol,
                                   atol=tol)
        np.testing.assert_allclose(gb[it].numpy(), wb[it], rtol=tol,
                                   atol=tol)
