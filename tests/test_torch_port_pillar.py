"""PyTorch port vs JAX package: the pillar family (PillarFeatureNet, the
pillar scatter, `tiny_pillar_test_config` end to end, the weight bridge on
the pillar trees, one tiny pillar train step).

Inputs are seeded numpy arrays fed to both packages; weights are seeded
numpy trees (shapes from `jax.eval_shape`) that reach the port only through
`load_jax_params`.  Tolerances: PillarFeatureNet's pooled features and BN
statistics within atol 1e-5 (rtol 1e-5); the scatter exact; predict and
train step as stated in tests/torch_port_common.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_common as common
from srfdet3d_tpu import configs as jconfigs
from srfdet3d_tpu.models.detector import _flatten_voxelization as jflatten
from srfdet3d_tpu.models.middle import pillar_scatter as j_scatter
from srfdet3d_tpu.models.middle import \
    pillar_scatter_batched as j_scatter_batched
from srfdet3d_tpu.models.vfe import PillarFeatureNet as JPFN
from srfdet3d_tpu.ops.voxelize import voxelize_points_batched as jvoxelize
from srfdet3d_torch import configs as tconfigs
from srfdet3d_torch.models.detector import SRFDet, bev_geometry
from srfdet3d_torch.models.middle import (PointPillarsScatter,
                                          pillar_scatter,
                                          pillar_scatter_batched)
from srfdet3d_torch.models.vfe import PillarFeatureNet
from srfdet3d_torch.ops.voxelize import VoxelizedPoints
from srfdet3d_torch.utils.jax_params import jax_state_dict

T = torch.from_numpy
B = 2


def _pfn_inputs():
    """tiny_pillar's voxelization of seeded points, flat over the batch,
    as numpy arrays (the JAX voxelizer's, so both sides see one)."""
    jcfg = jconfigs.tiny_pillar_test_config()
    pts, mask = common.uniform_points(jcfg, B, 3)
    spec = jcfg.voxelization
    vox = jflatten(jvoxelize(jnp.asarray(pts), jnp.asarray(mask), spec),
                   spec.max_voxels)
    vox = jax.tree_util.tree_map(np.array, vox)     # writable copies
    return jcfg, pts.reshape(-1, pts.shape[-1]), vox


@pytest.mark.parametrize("train", [False, True])
def test_pillar_feature_net_matches_jax(train):
    """Two PFN layers (the first half wide, with the pillar max gathered
    back), in eval mode (running statistics) and train mode (BN over the
    valid points only, and its running-statistics update)."""
    jcfg, pts, vox = _pfn_inputs()
    spec = jcfg.voxelization
    v_cap = B * spec.max_voxels
    feat = (16, 32)
    jmod = JPFN(in_channels=5, feat_channels=feat, spec=spec)
    shapes = jax.eval_shape(
        lambda r: jmod.init(r, jnp.asarray(pts), vox, v_cap),
        jax.random.PRNGKey(0))
    variables = common.random_variables(shapes, 5)
    if train:
        ref, upd = jmod.apply(variables, jnp.asarray(pts), vox, v_cap,
                              train=True, mutable=["batch_stats"])
        stats = upd["batch_stats"]
    else:
        ref = jmod.apply(variables, jnp.asarray(pts), vox, v_cap)
        stats = variables["batch_stats"]
    state = jax_state_dict({k: {"pts_voxel_encoder": v}
                            for k, v in variables.items()}, 1, 1)
    port = PillarFeatureNet(tconfigs.tiny_pillar_test_config().voxelization,
                            5, feat)
    port.load_state_dict({k.split(".", 1)[1]: T(v.copy())
                          for k, v in state.items()})
    port.train(train)
    tvox = VoxelizedPoints(point_voxel_idx=T(vox.point_voxel_idx).long(),
                           point_mask=T(vox.point_mask),
                           voxel_coords=T(vox.voxel_coords).long(),
                           voxel_mask=T(vox.voxel_mask))
    with torch.no_grad():
        got = port(T(pts), tvox, v_cap)
    assert got.shape == (v_cap, feat[-1])
    assert int(vox.point_mask.sum()) < pts.shape[0]   # some points dropped
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    assert float(np.abs(np.asarray(ref)).max()) > 0.1
    after = jax_state_dict({"batch_stats": {"pts_voxel_encoder": stats}},
                           1, 1)
    for key, val in after.items():
        np.testing.assert_allclose(
            port.state_dict()[key.split(".", 1)[1]].numpy(), val,
            rtol=1e-5, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("seed", [0, 1])
def test_pillar_scatter_matches_jax(seed):
    """Exact, batched and per sample: valid slots on distinct cells of a
    (ny, nx) = (6, 9) canvas (not square, so a transposed order shows),
    invalid slots carrying coords that collide with valid ones."""
    rng = np.random.default_rng(seed)
    ny, nx, v, c = 6, 9, 20, 3
    feats = rng.normal(size=(B, v, c)).astype(np.float32)
    coords = np.zeros((B, v, 3), np.int32)
    mask = np.zeros((B, v), bool)
    for b in range(B):
        cells = rng.choice(ny * nx, v, replace=False)
        coords[b, :, 1], coords[b, :, 2] = cells // nx, cells % nx
        mask[b] = rng.random(v) < 0.7
        coords[b, ~mask[b], 1:] = coords[b, np.argmax(mask[b]), 1:]
    ref = np.asarray(j_scatter_batched(jnp.asarray(feats),
                                       jnp.asarray(coords),
                                       jnp.asarray(mask), (ny, nx)))
    args = (T(feats), T(coords).long(), T(mask))
    got = pillar_scatter_batched(*args, (ny, nx))
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        PointPillarsScatter((ny, nx))(*args).numpy(), ref)
    for b in range(B):
        one = np.asarray(j_scatter(jnp.asarray(feats[b]),
                                   jnp.asarray(coords[b]),
                                   jnp.asarray(mask[b]), (ny, nx)))
        np.testing.assert_array_equal(
            pillar_scatter(*(a[b] for a in args), (ny, nx)).numpy(), one)
    assert int((ref != 0).any(-1).sum()) == int(mask.sum())


def test_tiny_pillar_predict_matches_jax():
    """PillarFeatureNet -> scatter -> stride-2 SECOND -> max-pool FPN
    extras -> head at strides (2, 4, 8, 16), roi_patch 0: the whole
    predict, as tests/torch_port_common.check_predict holds it."""
    tcfg = tconfigs.tiny_pillar_test_config()
    out = common.check_predict(jconfigs.tiny_pillar_test_config(), tcfg)
    assert out["boxes"].shape[-1] == 9
    port = SRFDet(tcfg, device="cpu")
    assert not hasattr(port, "pts_middle_encoder")
    _, sizes = bev_geometry(tcfg)
    assert sizes == [(40, 40), (20, 20), (10, 10), (5, 5)]


@pytest.mark.parametrize("name", ["tiny_pillar", "srfdet_pillar_nusc_L"])
def test_weight_bridge_pillar(name):
    """The pillar trees (PFNLayer_0, no pts_middle_encoder, no FPN extra
    convs), shapes from jax.eval_shape; srfdet_pillar_nusc_L counts
    20,677,524 parameters on both sides."""
    jcfg, tcfg = jconfigs.get_config(name), tconfigs.get_config(name)
    shapes = common.model_shapes(jcfg)
    assert "pts_middle_encoder" not in shapes["params"]
    assert set(shapes["params"]["pts_voxel_encoder"]) == {"PFNLayer_0"}
    port = common.check_bridge(
        tcfg, shapes,
        20_677_524 if name == "srfdet_pillar_nusc_L" else None)
    assert not any(k.startswith("pts_neck.extra")
                   for k in port.state_dict())


def test_tiny_pillar_train_step_matches_jax():
    """One whole train step of `tiny_pillar_test_config(points_cap=256,
    voxels_cap=256, gt_cap=4)` (code size 10, roi_patch 0, so K5's plain
    version takes every RoI), batch seed 5, weight seed 8: losses, every
    grad, the AdamW update and the BN statistics against JAX (tolerances
    in tests/torch_port_common.check_train_step).  Grads of a float32 step
    jump where an activation sits on a ReLU's kink; at these seeds the
    worst leaf measured 3.7e-5 of its largest grad, where seeds (4, 3)
    and (4, 12) put the grad norm 2.5e-4 off."""
    over = dict(points_cap=256, voxels_cap=256, gt_cap=4)
    jcfg = jconfigs.tiny_pillar_test_config(**over)
    tcfg = tconfigs.tiny_pillar_test_config(**over)
    batch, variables, out = common.jax_train_step(jcfg, B, 5, 8)
    assert batch["gt_boxes"].shape[-1] == 9
    worst = common.check_train_step(tcfg, batch, variables, out)
    assert worst < 2e-4
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
