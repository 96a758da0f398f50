"""PyTorch port vs JAX package: the KITTI family's detector end to end, the
table rulebook backend inside the detector, and the weight bridge on the
KITTI tree.

`tiny_kitti_test_config` (dynamic VFE, conv_module encoder, max-pool FPN
extras, code-8 head) runs on its shipped bitmap backend and with
`middle.rulebook="table"`, and `tiny_test_config` with
`middle.rulebook="table"`; each against JAX's same config on the same
points and the same random weights, which reach the port only through
`load_jax_params`.  Both take their plain paths on the CPU.  Forward logits
and boxes agree within 1e-4, decoded scores within 1e-5 and boxes within
1e-4 (float32 op order); labels and valid flags exactly."""

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
from srfdet3d_torch.utils.jax_params import jax_state_dict, load_jax_params

B = 2


def _table(cfg):
    return cfg.replace(middle=dataclasses.replace(cfg.middle,
                                                  rulebook="table"))


CASES = {
    "kitti_bitmap": (jconfigs.tiny_kitti_test_config,
                     tconfigs.tiny_kitti_test_config),
    "kitti_table": (lambda: _table(jconfigs.tiny_kitti_test_config()),
                    lambda: _table(tconfigs.tiny_kitti_test_config())),
    "tiny_table": (lambda: _table(jconfigs.tiny_test_config()),
                   lambda: _table(tconfigs.tiny_test_config())),
}


def _batch(cfg, seed):
    """Half of points_cap real points, uniform in the range."""
    rng = np.random.default_rng(seed)
    p = cfg.points_cap
    n = p // 2
    pts = np.zeros((B, p, cfg.points_dim), np.float32)
    lo, hi = np.array(cfg.pc_range[:3]), np.array(cfg.pc_range[3:])
    pts[:, :n, :3] = rng.uniform(lo, hi, (B, n, 3))
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


@pytest.mark.parametrize("case", list(CASES))
def test_tiny_predict_matches_jax(case):
    jcfg, tcfg = CASES[case][0](), CASES[case][1]()
    pts, mask = _batch(tcfg, 0)
    model = JSRFDet(jcfg)
    variables = _random_variables(_shapes(model, pts, mask), 12)
    # zero class biases: scores spread over (0, 1), so decoding has work
    head = variables["params"]["bbox_head"]["head_series"]["single_head"]
    head["class_logits"]["bias"][:] = 0.0

    @jax.jit
    def run(v, b):
        logits, boxes = model.apply(v, b, train=False)
        return logits, boxes, model.apply(v, b, method=JSRFDet.predict)

    jbatch = {"points": jnp.asarray(pts), "points_mask": jnp.asarray(mask)}
    j_logits, j_boxes, j_out = jax.device_get(run(variables, jbatch))

    port = SRFDet(tcfg, device="cpu")
    assert port.pts_middle_encoder.use_bitmap == case.endswith("bitmap")
    load_jax_params(port, variables)
    batch = {"points": torch.from_numpy(pts),
             "points_mask": torch.from_numpy(mask)}
    with torch.no_grad():
        t_logits, t_boxes = port(batch)
    t_out = port.predict(batch)
    code = tcfg.head.code_size
    assert t_boxes.shape == (2, B, tcfg.head.num_proposals, code)
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
    assert t_out["boxes"].shape[-1] == (7 if code == 8 else 9)


def _check_bridge(tcfg, shapes):
    variables = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes)
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    hc = tcfg.head
    state = jax_state_dict(variables, hc.num_heads, hc.num_cls_convs)
    stacked = len(jax.tree_util.tree_leaves(
        variables["params"]["bbox_head"]["head_series"]))
    assert len(state) == n_leaves + stacked * (hc.num_heads - 1)
    assert not any(k.startswith("pts_neck.extra") for k in state)
    assert any(k.startswith("pts_voxel_encoder.layers.0") for k in state)
    port = SRFDet(tcfg, device="cpu")
    load_jax_params(port, variables)         # raises on unset port tensors
    for p in port.parameters():
        assert float(p.detach().abs().max()) == 0.0
    broken = jax.tree_util.tree_map(lambda a: a, variables)
    broken["params"]["pts_voxel_encoder"]["Dense_7"] = {
        "kernel": np.zeros((3, 4), np.float32)}
    with pytest.raises(KeyError):
        load_jax_params(port, broken)
    short = jax.tree_util.tree_map(lambda a: a, variables)
    del short["batch_stats"]["pts_voxel_encoder"]
    with pytest.raises(KeyError):
        load_jax_params(port, short)


@pytest.mark.parametrize("centroid", [False, True])
def test_weight_bridge_tiny_kitti(centroid):
    vfe = dataclasses.replace(jconfigs.tiny_kitti_test_config().vfe,
                              with_centroid_aware=centroid)
    jcfg = jconfigs.tiny_kitti_test_config(vfe=vfe)
    tcfg = tconfigs.tiny_kitti_test_config(vfe=dataclasses.replace(
        tconfigs.tiny_kitti_test_config().vfe, with_centroid_aware=centroid))
    pts, mask = _batch(tcfg, 1)
    _check_bridge(tcfg, _shapes(JSRFDet(jcfg), pts, mask))


@pytest.mark.parametrize("name", sorted(tconfigs.CONFIGS))
def test_configs_match_jax(name):
    """Every config of the port's CONFIGS (all 11 shipped configs, the six
    LC ones among them, and the three tiny ones) equals the JAX package's
    config of that name field for field; the class tuples equal JAX's;
    the port builds every shipped config."""
    assert (dataclasses.asdict(tconfigs.get_config(name)) ==
            dataclasses.asdict(jconfigs.get_config(name))), name
    for classes in ("NUS_CLASSES", "KITTI_CLASSES", "WAYMO_CLASSES"):
        assert getattr(tconfigs, classes) == getattr(jconfigs, classes)
    assert set(tconfigs.CONFIGS) == set(jconfigs.CONFIGS)
    with pytest.raises(KeyError, match="no config"):
        tconfigs.get_config("srfdet_voxel_nusc_X")


def test_weight_bridge_kitti_full_width():
    """srfdet_voxel_kitti_L's tree, shapes from jax.eval_shape."""
    jcfg = jconfigs.srfdet_voxel_kitti_L()
    tcfg = tconfigs.srfdet_voxel_kitti_L()
    p = jcfg.points_cap
    batch = {"points": jax.ShapeDtypeStruct((1, p, 4), jnp.float32),
             "points_mask": jax.ShapeDtypeStruct((1, p), jnp.bool_)}
    shapes = jax.eval_shape(
        lambda r, b: JSRFDet(jcfg).init(r, b, train=False),
        jax.random.PRNGKey(0), batch)
    _check_bridge(tcfg, shapes)
