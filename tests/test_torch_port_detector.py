"""PyTorch port vs JAX package, the predict slice end to end, and the JAX
weight bridge.

`tiny_test_config` with the flagship's patch RoIAlign scaled down
(roi_patch=8, roi_patch_fallback=2) runs JAX `SRFDet.predict` and the port's
on the same points and the same random weights, which reach the port only
through `load_jax_params`.  Both take their plain paths on the CPU.  Forward
logits and boxes agree within 1e-4, decoded scores within 1e-5 and boxes
within 1e-4 (float32 op order); labels and valid flags exactly.  A second
weight set makes every first-iteration RoI a misfit, so more RoIs misfit
than there are fallback slots."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srfdet3d_tpu import configs as jconfigs
from srfdet3d_tpu.models.detector import SRFDet as JSRFDet
from srfdet3d_torch import configs as tconfigs
from srfdet3d_torch.models.detector import SRFDet
from srfdet3d_torch.models.head import denormalize_centers, lidar_rois_from_boxes
from srfdet3d_torch.ops.roi_align import patch_fits
from srfdet3d_torch.utils.jax_params import jax_state_dict, load_jax_params

B = 2


def _patched(cfg):
    return cfg.replace(head=dataclasses.replace(
        cfg.head, roi_patch=8, roi_patch_fallback=2))


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    p = cfg.points_cap
    n = p // 2
    pts = np.zeros((B, p, cfg.points_dim), np.float32)
    pts[:, :n, :2] = rng.uniform(-9, 9, (B, n, 2))
    pts[:, :n, 2] = rng.uniform(-3, 1, (B, n))
    pts[:, :n, 3:] = rng.uniform(0, 1, (B, n, cfg.points_dim - 3))
    mask = np.zeros((B, p), bool)
    mask[:, :n] = True
    return pts, mask


def _shapes(model, pts, mask):
    batch = {"points": jnp.asarray(pts), "points_mask": jnp.asarray(mask)}
    return jax.eval_shape(lambda r, b: model.init(r, b, train=False),
                          jax.random.PRNGKey(0), batch)


def _random_variables(shapes, seed):
    """Seeded numpy weights for every leaf of a JAX variable tree."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        keys = [k.key for k in path]
        name = keys[-1]
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape)
        if name in ("mean", "bias"):
            return rng.normal(0, 0.1, s.shape)
        if name == "scale":
            return rng.uniform(0.8, 1.2, s.shape)
        if name.startswith("init_proposal"):
            return rng.normal(0, 1, s.shape)
        lead = 1 if "head_series" in keys else 0
        fan_in = np.prod(s.shape[lead:-1])
        return rng.normal(0, 1 / np.sqrt(fan_in), s.shape)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(leaf(p, s), np.float32), shapes)


def _elongated_proposals(variables, cfg):
    """Every proposal 40 m x 1 m at the scene center: its RoI spans 20
    level-0 cells in x, so it misfits an 8-cell patch."""
    v = jax.tree_util.tree_map(np.array, variables)
    boxes = v["params"]["bbox_head"]["init_proposal_boxes"]
    boxes[:] = 0.0
    boxes[:, 3:6] = np.log([40.0, 1.0, 1.5])
    boxes[:, 7] = 1.0                                   # yaw 0: sin 0, cos 1
    return v, boxes[:cfg.head.num_proposals]


@pytest.fixture(scope="module")
def tiny_case():
    jcfg = _patched(jconfigs.tiny_test_config())
    pts, mask = _batch(jcfg, 0)
    model = JSRFDet(jcfg)
    shapes = _shapes(model, pts, mask)

    @jax.jit
    def run(v, b):
        logits, boxes = model.apply(v, b, train=False)
        return logits, boxes, model.apply(v, b, method=JSRFDet.predict)

    batch = {"points": jnp.asarray(pts), "points_mask": jnp.asarray(mask)}
    return jcfg, shapes, pts, mask, lambda v: run(v, batch)


@pytest.mark.parametrize("weights", ["random", "all_misfit"])
def test_tiny_predict_matches_jax(tiny_case, weights):
    jcfg, shapes, pts, mask, run = tiny_case
    tcfg = _patched(tconfigs.tiny_test_config())
    variables = _random_variables(shapes, 11)
    if weights == "all_misfit":
        variables, boxes0 = _elongated_proposals(variables, tcfg)
        b0 = torch.from_numpy(boxes0.copy())
        b0 = torch.cat([torch.sigmoid(b0[:, :3]), b0[:, 3:]], -1)
        rois = lidar_rois_from_boxes(denormalize_centers(b0, tcfg.pc_range),
                                     tcfg.pc_range, tcfg.voxel_size)
        fits = patch_fits([(10, 10), (5, 5), (3, 3), (2, 2)], rois,
                          tcfg.head.lidar_strides, 8)
        assert (~fits).sum() > tcfg.head.roi_patch_fallback
    j_logits, j_boxes, j_out = jax.device_get(run(variables))

    port = SRFDet(tcfg, device="cpu")
    load_jax_params(port, variables)
    batch = {"points": torch.from_numpy(pts), "points_mask":
             torch.from_numpy(mask)}
    with torch.no_grad():
        t_logits, t_boxes = port(batch)
    t_out = port.predict(batch)
    np.testing.assert_allclose(t_logits.numpy(), j_logits, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(t_boxes.numpy(), j_boxes, rtol=1e-4,
                               atol=1e-4)
    for k in ("labels", "valid"):
        np.testing.assert_array_equal(t_out[k].numpy(), np.asarray(j_out[k]))
    np.testing.assert_allclose(t_out["scores"].numpy(), j_out["scores"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t_out["boxes"].numpy(), j_out["boxes"],
                               rtol=1e-4, atol=1e-4)
    assert t_out["valid"].sum() > 0


def _check_bridge(jcfg, tcfg, shapes):
    variables = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes)
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    hc = tcfg.head
    state = jax_state_dict(variables, hc.num_heads, hc.num_cls_convs)
    stacked = len(jax.tree_util.tree_leaves(
        variables["params"]["bbox_head"]["head_series"]))
    # every JAX leaf is consumed once; stacked head leaves split num_heads
    assert len(state) == n_leaves + stacked * (hc.num_heads - 1)
    port = SRFDet(tcfg, device="cpu")
    load_jax_params(port, variables)         # raises on unset port tensors
    for p in port.parameters():
        assert float(p.detach().abs().max()) == 0.0
    with pytest.raises(KeyError):
        broken = jax.tree_util.tree_map(lambda a: a, variables)
        broken["params"]["bbox_head"]["stray"] = np.zeros(3, np.float32)
        load_jax_params(port, broken)


def test_weight_bridge_tiny(tiny_case):
    jcfg, shapes, _, _, _ = tiny_case
    _check_bridge(jcfg, _patched(tconfigs.tiny_test_config()), shapes)


def test_weight_bridge_flagship():
    """The flagship tree's shapes come from jax.eval_shape, not an init."""
    jcfg = jconfigs.srfdet_voxel_nusc_L()
    p = jcfg.points_cap
    batch = {"points": jax.ShapeDtypeStruct((1, p, 5), jnp.float32),
             "points_mask": jax.ShapeDtypeStruct((1, p), jnp.bool_)}
    shapes = jax.eval_shape(
        lambda r, b: JSRFDet(jcfg).init(r, b, train=False),
        jax.random.PRNGKey(0), batch)
    _check_bridge(jcfg, tconfigs.srfdet_voxel_nusc_L(), shapes)
