"""The port's reference-checkpoint converter against the JAX route on the
three ResNet LiDAR-camera configs at full width, in both spconv layouts:
ResNet-50 with a plain image FPN (the voxel and pillar R50 fine-tunes) and
ResNet-101 with DCNv2 and a BN image neck (Waymo LC), with the head's image
extras and fused projections (test_torch_port_convert.py holds the checks,
test_torch_port_convert_lc.py the VoVNet LC configs)."""

import pytest
import torch

from srfdet3d_torch import configs as tconfigs
from srfdet3d_torch.utils.torch_convert import convert_reference_state_dict
from test_torch_port_convert import check_against_jax, shared_state

LC_CONFIGS = ("srfdet_voxel_r50_LC", "srfdet_pillar_r50_LC",
              "srfdet_dvoxel_waymo_LC")


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
