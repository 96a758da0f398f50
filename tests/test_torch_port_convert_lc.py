"""The port's reference-checkpoint converter against the JAX route on the
three VoVNet-99 LiDAR-camera configs at full width (the nuScenes, KITTI and
pillar V299 fine-tunes), in both spconv layouts, with the head's image
extras and fused projections (test_torch_port_convert.py holds the checks
and the LiDAR-only configs, test_torch_port_convert_resnet.py the ResNet
LC configs)."""

import pytest
import torch

from srfdet3d_torch import configs as tconfigs
from srfdet3d_torch.utils.torch_convert import convert_reference_state_dict
from test_torch_port_convert import check_against_jax, shared_state

LC_CONFIGS = ("srfdet_voxel_nusc_LC", "srfdet_pillar_v299_LC",
              "srfdet_voxel_kitti_LC")


@pytest.mark.parametrize("name,layout", [(n, lay) for n in LC_CONFIGS
                                         for lay in ("KIO", "OKI")])
def test_lc_configs_match_jax_route(name, layout):
    got = check_against_jax(name, layout)
    assert any(k.startswith("img_backbone.") for k in got)
    if "dvoxel_waymo" in name:
        assert any(k.endswith(".dcn2.kernel") for k in got)
        assert "img_neck.fpn.0.bn.running_var" in got
    if layout == "OKI" and tconfigs.get_config(name).middle.kind == "sparse":
        kio, _ = convert_reference_state_dict(shared_state(name),
                                              tconfigs.get_config(name))
        for key, t in kio.items():
            assert torch.equal(t, got[key]), key
