"""PyTorch port vs JAX package: the two dynamic-voxel configs.

- The weight bridge at full width for `srfdet_dvoxel_nusc_L` (91,201,397
  parameters) and `srfdet_dvoxel_waymo_L` (23,111,892), shapes from
  `jax.eval_shape`.
- A tiny predict at each dvoxel config's options on `tiny_test_config`:
  DynamicVFE (5, 5) without the centroid MLP; for nuScenes a wider neck
  and head (64 channels, the tiny's 32 scaled as 128 -> 256) and 6
  iterations; for Waymo code size 8 with its 3 classes.

The predict tolerances are stated in tests/torch_port_common.py; the
code-size-8 train path is in tests/test_torch_port_code8.py.
"""

import dataclasses

import pytest

import torch_port_common as common
from srfdet3d_tpu import configs as jconfigs
from srfdet3d_torch import configs as tconfigs


@pytest.mark.parametrize("name,n_params", [
    ("srfdet_dvoxel_nusc_L", 91_201_397),
    ("srfdet_dvoxel_waymo_L", 23_111_892)])
def test_weight_bridge_dvoxel_full_width(name, n_params):
    """DynamicVFE (5, 5) without the centroid MLP (DynamicVFELayer_{0,1}
    only), the basicblock encoder, the conv FPN extras, the head's
    6 (nuScenes) or 5 (Waymo, code 8, 3 classes) iterations."""
    jcfg, tcfg = jconfigs.get_config(name), tconfigs.get_config(name)
    shapes = common.model_shapes(jcfg)
    assert set(shapes["params"]["pts_voxel_encoder"]) == {
        "DynamicVFELayer_0", "DynamicVFELayer_1"}
    port = common.check_bridge(tcfg, shapes, n_params)
    hc = tcfg.head
    assert len(port.bbox_head.heads) == hc.num_heads
    assert port.bbox_head.heads[0].bboxes_delta.out_features == hc.code_size
    assert port.pts_middle_encoder.use_bitmap


def _dvoxel_options(cfg, kind):
    """A tiny config (either package's) with a dvoxel config's options."""
    vfe = dataclasses.replace(cfg.vfe, kind="dynamic", in_channels=5,
                              feat_channels=(5, 5), with_centroid_aware=False)
    cfg = cfg.replace(max_points_per_voxel=-1, vfe=vfe,
                      middle=dataclasses.replace(cfg.middle, in_channels=5))
    if kind == "nusc":
        return cfg.replace(neck_out_channels=64, head=dataclasses.replace(
            cfg.head, feat_channels_lidar=64, num_heads=6,
            dim_feedforward=128, dynamic_dim=16))
    return cfg.replace(
        class_names=jconfigs.WAYMO_CLASSES,
        head=dataclasses.replace(cfg.head, num_classes=3, code_size=8),
        loss=dataclasses.replace(cfg.loss, code_weights=(1.0,) * 8,
                                 num_classes=3))


@pytest.mark.parametrize("kind", ["nusc", "waymo"])
def test_tiny_dvoxel_predict_matches_jax(kind):
    jcfg = _dvoxel_options(jconfigs.tiny_test_config(), kind)
    tcfg = _dvoxel_options(tconfigs.tiny_test_config(), kind)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    out = common.check_predict(jcfg, tcfg)
    assert out["boxes"].shape[-1] == (7 if kind == "waymo" else 9)
