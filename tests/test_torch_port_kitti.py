"""PyTorch port vs JAX package: the KITTI voxel family's modules.

Inputs are made with numpy from a seed and fed to both; weights reach the
port through the JAX weight bridge.  Integers (voxel coords, slots, masks)
match exactly; segment_max exactly (a max takes no rounding); DynamicVFE
within rtol 1e-5 (float32 op order of the Linear layers and BN); the FPN
within 1e-4 and the sparse encoders within 1e-4 (float32 convs summed in
another order), as the flagship's encoder test holds them."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srfdet3d_tpu import configs as jconfigs
from srfdet3d_tpu.models.detector import _flatten_voxelization as jflatten
from srfdet3d_tpu.models.fpn import FPN as JFPN
from srfdet3d_tpu.models.sparse_encoder import SparseEncoder as JEncoder
from srfdet3d_tpu.models.vfe import DynamicVFE as JDynamicVFE
from srfdet3d_tpu.ops import scatter as jscatter
from srfdet3d_tpu.ops import voxelize as jvox
from srfdet3d_torch import configs as tconfigs
from srfdet3d_torch.models.detector import _flatten_voxelization
from srfdet3d_torch.models.fpn import FPN
from srfdet3d_torch.models.sparse_encoder import SparseEncoder
from srfdet3d_torch.models.vfe import DynamicVFE
from srfdet3d_torch.ops.scatter import segment_max
from srfdet3d_torch.ops.voxelize import voxelize_points_batched
from srfdet3d_torch.utils.jax_params import jax_state_dict

B = 2
T = torch.from_numpy


def _kitti_points(cfg, rng, n_real):
    """(B, P, 4) points in (and a little outside) the tiny KITTI range,
    clustered so that voxels hold several points."""
    p = cfg.points_cap
    pts = np.zeros((B, p, 4), np.float32)
    lo, hi = np.array(cfg.pc_range[:3]), np.array(cfg.pc_range[3:])
    centers = rng.uniform(lo, hi, (B, n_real // 8, 3))
    jitter = rng.normal(0, 0.1, (B, n_real // 8, 8, 3))
    pts[:, :n_real, :3] = (centers[:, :, None] + jitter).reshape(B, -1, 3)
    pts[:, :n_real, 3] = rng.uniform(0, 1, (B, n_real))
    pts[:, n_real // 2:n_real // 2 + 24] = pts[:, :1]     # a crowded voxel
    mask = np.zeros((B, p), bool)
    mask[:, :n_real] = True
    return pts, mask


def _random_tree(shapes, rng):
    def leaf(path, s):
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape)
        if name in ("mean", "bias"):
            return rng.normal(0, 0.1, s.shape)
        if name == "scale":
            return rng.uniform(0.8, 1.2, s.shape)
        return rng.normal(0, 1 / np.sqrt(np.prod(s.shape[:-1])), s.shape)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(leaf(p, s), np.float32), shapes)


def _load(module, variables, prefix):
    """Load a JAX subtree into one port module through the weight bridge."""
    state = jax_state_dict({k: {prefix: v} for k, v in variables.items()},
                           1, 0)
    module.load_state_dict({k[len(prefix) + 1:]: T(np.array(a))
                            for k, a in state.items()}, strict=True)


def test_segment_max_matches_jax():
    rng = np.random.default_rng(0)
    n, c, segs = 500, 6, 64
    data = rng.normal(-3, 1, (n, c)).astype(np.float32)   # mostly negative
    ids = rng.integers(0, segs // 2, n) * 2                # odd ids empty
    ids[:20] = segs                                        # dropped
    ids[20:25] = segs + 5                                  # dropped
    ref = np.asarray(jscatter.segment_max(jnp.asarray(data),
                                          jnp.asarray(ids), segs))
    got = segment_max(T(data), T(ids), segs).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got[1::2] == 0).all() and (got[::2] < 0).any()


def test_dynamic_voxelization_matches_jax():
    """max_points_per_voxel = -1: no per-voxel cap, every in-range point
    keeps its voxel."""
    cfg = tconfigs.tiny_kitti_test_config()
    spec = cfg.voxelization
    assert spec.max_num_points == -1
    rng = np.random.default_rng(1)
    pts, mask = _kitti_points(cfg, rng, 1600)
    jv = jvox.voxelize_points_batched(
        jnp.asarray(pts), jnp.asarray(mask),
        jconfigs.tiny_kitti_test_config().voxelization, with_counts=False)
    tv = voxelize_points_batched(T(pts), T(mask), spec)
    vm = np.asarray(jv.voxel_mask)
    np.testing.assert_array_equal(tv.voxel_mask.numpy(), vm)
    np.testing.assert_array_equal(tv.voxel_coords.numpy()[vm],
                                  np.asarray(jv.voxel_coords)[vm])
    np.testing.assert_array_equal(tv.point_voxel_idx.numpy(),
                                  np.asarray(jv.point_voxel_idx))
    np.testing.assert_array_equal(tv.point_mask.numpy(),
                                  np.asarray(jv.point_mask))
    # every point in range is kept, and some voxel holds more than 10
    counts = np.bincount(tv.point_voxel_idx.numpy()[0], minlength=spec.
                         max_voxels + 1)[:-1]
    assert counts.max() > 10
    assert tv.point_mask.sum() > 0.9 * mask.sum()


@pytest.mark.parametrize("centroid", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_dynamic_vfe_matches_jax(centroid, train):
    cfg = tconfigs.tiny_kitti_test_config()
    jspec = jconfigs.tiny_kitti_test_config().voxelization
    spec = cfg.voxelization
    v_cap = spec.max_voxels
    rng = np.random.default_rng(2)
    pts, mask = _kitti_points(cfg, rng, 1600)
    p = pts.shape[1]
    jflat = jflatten(jvox.voxelize_points_batched(
        jnp.asarray(pts), jnp.asarray(mask), jspec, with_counts=False), v_cap)
    jpts = jnp.asarray(pts.reshape(B * p, 4))
    feat_ch = (8, 16)
    jvfe = JDynamicVFE(in_channels=4, feat_channels=feat_ch,
                       with_centroid_aware=centroid, spec=jspec)
    shapes = jax.eval_shape(
        lambda r: jvfe.init(r, jpts, jflat, B * v_cap, train=False),
        jax.random.PRNGKey(0))
    variables = _random_tree(shapes, rng)
    if train:
        ref, upd = jvfe.apply(variables, jpts, jflat, B * v_cap, train=True,
                              mutable=["batch_stats"])
    else:
        ref = jvfe.apply(variables, jpts, jflat, B * v_cap, train=False)

    vfe = DynamicVFE(spec, 4, feat_ch, with_centroid_aware=centroid)
    _load(vfe, variables, "pts_voxel_encoder")
    vfe.train(train)
    tflat = _flatten_voxelization(
        voxelize_points_batched(T(pts), T(mask), spec), v_cap)
    got = vfe(T(pts.reshape(B * p, 4)), tflat, B * v_cap)
    assert got.shape == ref.shape == (B * v_cap, 16)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    assert np.abs(np.asarray(ref)).max() > 0.1
    if train:
        new = jax_state_dict({"batch_stats": {"pts_voxel_encoder":
                                              upd["batch_stats"]}}, 1, 0)
        buffers = dict(vfe.named_buffers())
        assert len(new) == len(buffers) == 4 * (len(feat_ch) +
                                                2 * centroid) // 2
        for key, want in new.items():
            np.testing.assert_allclose(
                buffers[key[len("pts_voxel_encoder."):]].numpy(),
                np.asarray(want), rtol=1e-5, atol=1e-6)


def test_fpn_max_pool_extras_match_jax():
    rng = np.random.default_rng(3)
    ins = [rng.normal(size=(B, 10, 10, 16)).astype(np.float32),
           rng.normal(size=(B, 5, 5, 32)).astype(np.float32)]
    jfpn = JFPN(out_channels=8, num_outs=4, use_norm=True, use_act=True,
                extra_convs=False)
    jins = [jnp.asarray(x) for x in ins]
    shapes = jax.eval_shape(partial(jfpn.init, train=False),
                            jax.random.PRNGKey(0), jins)
    variables = _random_tree(shapes, rng)
    ref = jfpn.apply(variables, jins, train=False)
    fpn = FPN((16, 32), 8, 4, extra_convs=False)
    assert len(fpn.extra) == 0
    _load(fpn, variables, "pts_neck")
    fpn.eval()
    with torch.no_grad():
        got = fpn([T(x).permute(0, 3, 1, 2) for x in ins])
    assert [tuple(g.shape[2:]) for g in got] == [(10, 10), (5, 5), (3, 3),
                                                 (2, 2)]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(r), rtol=1e-4, atol=1e-4)


def _encoder_case(name):
    return {"conv_module": (jconfigs.tiny_kitti_test_config(),
                            tconfigs.tiny_kitti_test_config()),
            "basicblock": (jconfigs.tiny_test_config(),
                           tconfigs.tiny_test_config())}[name]


@pytest.mark.parametrize("rulebook", ["bitmap", "table"])
@pytest.mark.parametrize("layout", ["conv_module", "basicblock"])
def test_sparse_encoder_matches_jax(layout, rulebook):
    """Each layout on each backend against JAX's same backend, on the
    voxelizer's plan-major output; eval mode."""
    jcfg, tcfg = _encoder_case(layout)
    spec = tcfg.voxelization
    m = tcfg.middle
    rng = np.random.default_rng(4)
    pts, mask = _kitti_points(tconfigs.tiny_kitti_test_config(), rng, 1200)
    pts = np.concatenate([pts, np.zeros_like(pts[..., :1])], -1)[
        ..., :tcfg.points_dim]
    vox = voxelize_points_batched(T(pts), T(mask), spec)
    vm = vox.voxel_mask.numpy()
    coords = vox.voxel_coords.numpy()
    feats = rng.normal(size=(B, spec.max_voxels, m.in_channels)
                       ).astype(np.float32)
    enc = JEncoder(in_channels=m.in_channels, sparse_shape=spec.sparse_shape,
                   base_channels=m.base_channels,
                   output_channels=m.output_channels,
                   encoder_channels=m.encoder_channels,
                   encoder_paddings=m.encoder_paddings,
                   block_type=m.block_type, capacities=m.capacities,
                   rulebook=rulebook, presorted=True)
    args = (jnp.asarray(feats), jnp.asarray(coords.astype(np.int32)),
            jnp.asarray(vm))
    shapes = jax.eval_shape(partial(enc.init, train=False),
                            jax.random.PRNGKey(0), *args)
    variables = _random_tree(shapes, rng)
    ref = np.asarray(jax.jit(partial(enc.apply, train=False))(variables,
                                                              *args))
    port = SparseEncoder(m.in_channels, spec.sparse_shape, m.base_channels,
                         m.output_channels, m.encoder_channels,
                         m.encoder_paddings, m.capacities,
                         block_type=m.block_type, rulebook=rulebook)
    assert port.use_bitmap == (rulebook == "bitmap")
    _load(port, variables, "pts_middle_encoder")
    port.eval()
    with torch.no_grad():
        got = port(T(feats), vox.voxel_coords, vox.voxel_mask).numpy()
    assert got.shape == ref.shape == (B, 10, 10, 2 * m.output_channels)
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
