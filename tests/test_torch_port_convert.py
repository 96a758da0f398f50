"""The port's reference-checkpoint converter
(`srfdet3d_torch.utils.torch_convert`) against the JAX route: the JAX
package's convert_reference_state_dict followed by the weight bridge's map
onto the port's names (`jax_state_dict`), tensor for tensor and bit for
bit, on seeded reference state dicts at full width (the generators of
test_torch_convert_full.py, through torch_port_common.reference_state).
This file: the five LiDAR-only configs in both spconv layouts, a LiDAR-only
checkpoint into an LC config (the staged fine-tune), unused and missing
keys, the centroid MLP, the head without its DPG (its conversion, a
round trip through the reference names, the weight bridge with the
deformable BEV encoder's leaves); test_torch_port_convert_lc.py and
test_torch_port_convert_resnet.py: the six LC configs."""

import dataclasses


import numpy as np
import pytest
import torch

from srfdet3d_tpu import configs as jconfigs
from srfdet3d_tpu.config import VFEConfig as JVFEConfig
from srfdet3d_tpu.utils import torch_convert as jconvert
from srfdet3d_torch import configs as tconfigs
from srfdet3d_torch.config import VFEConfig
from srfdet3d_torch.utils import torch_convert
from srfdet3d_torch.utils.torch_convert import convert_reference_state_dict
from srfdet3d_torch.models.detector import SRFDet
from torch_port_common import (check_bridge, jax_route_state,
                               meta_state_shapes, model_shapes,
                               reference_state, spconv_to_oki)

LIDAR_CONFIGS = ("srfdet_voxel_nusc_L", "srfdet_voxel_kitti_L",
                 "srfdet_dvoxel_waymo_L", "srfdet_dvoxel_nusc_L",
                 "srfdet_pillar_nusc_L")
_STATE = {}


def shared_state(name):
    """One seeded reference state dict a config, shared by its cases (the
    last config's only: the LC ones hold ~100 M floats)."""
    if name not in _STATE:
        _STATE.clear()
        _STATE[name] = reference_state(tconfigs.get_config(name), seed=0)
    return _STATE[name]


def check_against_jax(name, layout):
    """The port's conversion equals the JAX route's tensor for tensor (the
    same key set, float32, max abs diff 0.0), its key set and shapes equal
    the port model's parameters and BN statistics, and only the BN step
    counters and the head's code_weights go unused.  Returns the port's
    state dict."""
    state = shared_state(name)
    if layout == "OKI":
        state = spconv_to_oki(state)
    tcfg = tconfigs.get_config(name)
    got, unused = convert_reference_state_dict(state, tcfg,
                                               spconv_layout=layout)
    want = jax_route_state(state, jconfigs.get_config(name), layout)
    assert sorted(got) == sorted(want)
    for key, ref in want.items():
        assert got[key].dtype == torch.float32, key
        np.testing.assert_array_equal(got[key].numpy(), ref, err_msg=key)
    shapes = meta_state_shapes(tcfg)
    assert sorted(got) == sorted(shapes)
    for key, t in got.items():
        assert tuple(t.shape) == shapes[key], key
    assert all(k.endswith("num_batches_tracked") or
               k == "bbox_head.code_weights" for k in unused), unused[:4]
    return got


@pytest.mark.parametrize("name,layout", [(n, lay) for n in LIDAR_CONFIGS
                                         for lay in ("KIO", "OKI")])
def test_lidar_configs_match_jax_route(name, layout):
    got = check_against_jax(name, layout)
    if layout == "OKI":         # the same weights, from the other layout
        kio, _ = convert_reference_state_dict(shared_state(name),
                                              tconfigs.get_config(name))
        for key, t in kio.items():
            assert torch.equal(t, got[key]), key


def test_lidar_checkpoint_into_lc_config():
    """The staged fine-tune: srfdet_voxel_nusc_L's checkpoint into
    srfdet_voxel_nusc_LC converts its LiDAR tensors (equal to the JAX
    route's, and to the L conversion) and sets nothing of the image branch:
    the port tensors left unset are the image backbone, the image neck and
    the head's image extras and fused projections."""
    state = shared_state("srfdet_voxel_nusc_L")
    lc = tconfigs.get_config("srfdet_voxel_nusc_LC")
    got, _ = convert_reference_state_dict(state, lc)
    want = jax_route_state(state, jconfigs.get_config("srfdet_voxel_nusc_LC"))
    assert sorted(got) == sorted(want)
    for key, ref in want.items():
        np.testing.assert_array_equal(got[key].numpy(), ref, err_msg=key)
    lidar, _ = convert_reference_state_dict(
        state, tconfigs.get_config("srfdet_voxel_nusc_L"))
    assert sorted(lidar) == sorted(got)
    shapes = meta_state_shapes(lc)
    assert set(got) < set(shapes)
    image = ("img_backbone.", "img_neck.", "bbox_head.dpg_dw_img.",
             "bbox_head.dpg_fc1_img.", "bbox_head.dpg_fc2_img.",
             "bbox_head.img_conv.")
    for key in set(shapes) - set(got):
        assert key.startswith(image) or ".output_fused_proj." in key, key
    assert any(".output_fused_proj." in k for k in set(shapes) - set(got))


def test_unused_and_missing_keys():
    """A key that maps to nothing is returned unused and makes no tensor;
    a module present in the checkpoint with a tensor missing raises; a
    checkpoint without a module gives no tensor of it."""
    name = "srfdet_voxel_nusc_L"
    cfg = tconfigs.get_config(name)
    state = dict(shared_state(name))
    state["bbox_head.future_branch.weight"] = np.ones(3, np.float32)
    state["img_backbone.conv1.weight"] = np.ones((4, 3, 7, 7), np.float32)
    got, unused = convert_reference_state_dict(state, cfg)
    assert "bbox_head.future_branch.weight" in unused
    assert "img_backbone.conv1.weight" in unused       # a LiDAR-only config
    assert not any(k.startswith("img_") for k in got)
    del state["pts_neck.fpn_convs.1.bn.running_var"]
    with pytest.raises(KeyError, match="pts_neck.fpn_convs.1.bn"):
        convert_reference_state_dict(state, cfg)
    neckless = {k: v for k, v in state.items()
                if not k.startswith("pts_neck.")}
    got, _ = convert_reference_state_dict(neckless, cfg)
    assert got and not any(k.startswith("pts_neck.") for k in got)
    with pytest.raises(ValueError):
        convert_reference_state_dict(neckless, cfg, spconv_layout="KOI")


def test_centroid_mlp_and_encoder_depth():
    """The DynamicVFE's centroid MLP (no shipped config turns it on) on a
    tiny KITTI config, against the JAX route; the BEV depth of every
    sparse config equals the JAX converter's."""
    tcfg = tconfigs.tiny_kitti_test_config(
        vfe=VFEConfig(kind="dynamic", in_channels=4, feat_channels=(4,),
                      with_centroid_aware=True))
    jcfg = jconfigs.tiny_kitti_test_config(
        vfe=JVFEConfig(kind="dynamic", in_channels=4, feat_channels=(4,),
                       with_centroid_aware=True))
    state = reference_state(tcfg, seed=3)
    got, _ = convert_reference_state_dict(state, tcfg)
    want = jax_route_state(state, jcfg)
    assert sorted(got) == sorted(want) == sorted(meta_state_shapes(tcfg))
    assert "pts_voxel_encoder.centroid_fc2.weight" in got
    for key, ref in want.items():
        np.testing.assert_array_equal(got[key].numpy(), ref, err_msg=key)
    for name in LIDAR_CONFIGS + ("tiny", "tiny_kitti"):
        tcfg = tconfigs.get_config(name)
        if tcfg.middle.kind != "sparse":
            continue
        assert torch_convert._encoder_out_depth(tcfg) == \
            jconvert._encoder_out_depth(jconfigs.get_config(name)), name


def test_spconv_and_dcn_layouts():
    """spconv KIO and OKI land each offset's (in, out) block at its z-major
    index; the DCNv2 weight goes tap-major, (kh*kw*Cin, Cout)."""
    rng = np.random.default_rng(0)
    kio = rng.normal(size=(3, 3, 3, 2, 4)).astype(np.float32)
    a = torch_convert.spconv_w(kio, "KIO")
    b = torch_convert.spconv_w(np.transpose(kio, (4, 0, 1, 2, 3)), "OKI")
    np.testing.assert_array_equal(a, b)
    for dz, dy, dx in ((0, 0, 0), (1, 2, 0), (2, 2, 2)):
        np.testing.assert_array_equal(a[dz * 9 + dy * 3 + dx],
                                      kio[dz, dy, dx])
    with pytest.raises(ValueError):
        torch_convert.spconv_w(kio[0], "KIO")
    w = rng.normal(size=(5, 2, 3, 3)).astype(np.float32)
    d = torch_convert.dcn_w(w)
    assert d.shape == (18, 5)
    np.testing.assert_array_equal(d[(1 * 3 + 2) * 2 + 1], w[:, 1, 1, 2])
    np.testing.assert_array_equal(d, jconvert.dcn_w(w))


def _head_opts(cfg, **opts):
    return cfg.replace(head=dataclasses.replace(cfg.head, **opts))


def test_head_without_dpg_converts_and_round_trips():
    """with_dpg=False: a reference checkpoint with num_proposals proposal
    embeddings and no DPG converts as the JAX route converts it, to the
    port model's tensors exactly; and a tiny seeded port model through the
    reference's names (chip_smoke.reference_checkpoint) and back comes out
    bit for bit, only the BN step counters unused."""
    import chip_smoke
    name = "srfdet_voxel_nusc_L"
    tcfg = _head_opts(tconfigs.get_config(name), with_dpg=False)
    jcfg = _head_opts(jconfigs.get_config(name), with_dpg=False)
    n_p = tcfg.head.num_proposals
    state = {k: (v[:n_p] if ".init_proposal_" in k else v)
             for k, v in shared_state(name).items()
             if not k.startswith("bbox_head.dpg_")}
    got, unused = convert_reference_state_dict(state, tcfg)
    want = jax_route_state(state, jcfg)
    assert sorted(got) == sorted(want) == sorted(meta_state_shapes(tcfg))
    for key, ref in want.items():
        np.testing.assert_array_equal(got[key].numpy(), ref, err_msg=key)
    assert got["bbox_head.init_proposal_boxes"].shape[0] == n_p

    tiny = _head_opts(tconfigs.tiny_test_config(), with_dpg=False)
    model = SRFDet(tiny, device="cpu", seed=4)
    back, unused = convert_reference_state_dict(
        chip_smoke.reference_checkpoint(model), tiny)
    state = {k: v for k, v in model.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    assert sorted(back) == sorted(state)
    for key, t in state.items():
        assert torch.equal(back[key], t), key
    assert all(k.endswith("num_batches_tracked") for k in unused)


@pytest.mark.parametrize("opts", [dict(with_dpg=False),
                                  dict(with_dpg=False,
                                       with_lidar_encoder=True)],
                         ids=["no_dpg", "encoder_no_dpg"])
def test_bridge_takes_the_option_trees(opts):
    """The JAX trees of the head options through load_jax_params: every
    leaf consumed once, every port tensor set (the encoder's level
    embeddings, positional MLPs with their BatchNorms, attention and FFN
    layers), the parameter counts equal; a stray and a missing leaf raise
    (under bbox_head where it has BN statistics: the encoder's, the
    DPG's)."""
    enc = opts.get("with_lidar_encoder", False)
    port = check_bridge(_head_opts(tconfigs.tiny_test_config(), **opts),
                        model_shapes(_head_opts(jconfigs.tiny_test_config(),
                                                **opts)),
                        branch="bbox_head" if enc or opts.get(
                            "with_dpg", True) else "pts_backbone")
    head = port.bbox_head
    assert (head.lidar_encoder is not None) == enc
    assert hasattr(head, "dpg_fc1") == opts.get("with_dpg", True)
