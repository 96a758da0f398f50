"""The weight bridge at the full width of the six LiDAR-camera (LC)
configs: the JAX package's variable shapes (jax.eval_shape on a batch with
the config's cameras and image size, no init) through load_jax_params,
every leaf consumed once and every port tensor set, with the parameter
counts of both packages equal to the JAX package's; and on the same trees
the freeze rules of each config's fine-tune, the port's freeze_mask
against JAX's leaf for leaf."""

import functools

import jax
import pytest
import torch

from srfdet3d_tpu import configs as jconfigs
from srfdet3d_tpu.models.detector import SRFDet as JSRFDet
from srfdet3d_torch import configs as tconfigs
from srfdet3d_torch.models.detector import SRFDet
from torch_port_common import check_bridge, check_freeze_mask, lc_input_shapes

# parameters of each LC model (jax.eval_shape of the JAX package)
LC_PARAMS = {
    "srfdet_voxel_nusc_LC": 103_725_056,
    "srfdet_voxel_r50_LC": 58_037_248,
    "srfdet_pillar_r50_LC": 55_638_128,
    "srfdet_pillar_v299_LC": 101_325_936,
    "srfdet_voxel_kitti_LC": 154_575_067,
    "srfdet_dvoxel_waymo_LC": 75_428_206,
}


# the image backbone's modules with a frozen leaf in each LC fine-tune:
# the VoVNet-99 configs the stem and stages 2-3 (frozen_stages 2: one
# block, then three), the ResNet ones the root and layer 1 (frozen_stages
# 1); Waymo LC's ResNet-101 also a BN in every block (norm_frozen)
_VOV = {"stem1", "stem2", "stem3", "stage2_block0", "stage3_block0",
        "stage3_block1", "stage3_block2"}
_R50 = {"Conv_0", "BatchNorm_0", "layer1_0", "layer1_1", "layer1_2"}
_R101 = _R50 | {f"layer{s + 1}_{i}" for s, n in enumerate((3, 4, 23, 3))
                for i in range(n)}
LC_FROZEN_BACKBONE = {
    "srfdet_voxel_nusc_LC": _VOV, "srfdet_voxel_r50_LC": _R50,
    "srfdet_pillar_r50_LC": _R50, "srfdet_pillar_v299_LC": _VOV,
    "srfdet_voxel_kitti_LC": _VOV, "srfdet_dvoxel_waymo_LC": _R101,
}


@functools.lru_cache(maxsize=None)
def _shapes(name):
    jcfg = jconfigs.get_config(name)
    return jax.eval_shape(
        lambda r, b: JSRFDet(jcfg).init(r, b, train=False),
        jax.random.PRNGKey(0), lc_input_shapes(jcfg, 1))


@pytest.mark.parametrize("name", sorted(LC_PARAMS))
def test_weight_bridge_lc_full_width(name):
    """A stray leaf and a missing one in img_backbone raise."""
    check_bridge(tconfigs.get_config(name), _shapes(name), LC_PARAMS[name],
                 branch="img_backbone")


@pytest.mark.parametrize("name", sorted(LC_PARAMS))
def test_freeze_mask_lc_full_width(name):
    """Each LC config's freeze rules (freeze_lidar, frozen_stages,
    norm_frozen): the port's freeze_mask on a model built on the meta
    device (no weights) equals JAX freeze_mask on the eval_shape tree,
    leaf for leaf through jax_param_names; the LiDAR branch frozen, the
    image neck and the head trained."""
    jcfg = jconfigs.get_config(name)
    with torch.device("meta"):
        port = SRFDet(tconfigs.get_config(name), device="meta")
    frozen = check_freeze_mask(jcfg, port, _shapes(name))
    tops = {k[0] for k in frozen}
    assert "pts_backbone" in tops and "pts_neck" in tops
    assert not tops & {"img_neck", "bbox_head"}
    backbone = {k[1] for k in frozen if k[0] == "img_backbone"}
    assert backbone == LC_FROZEN_BACKBONE[name]
