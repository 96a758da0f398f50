"""Tiny LiDAR-camera (LC) predicts, JAX package against the port, on the
CPU: the fusion head with VoVNet-19-slim on two cameras, the wiring where
the image neck's width equals hidden_dim (no img_conv) with a BN + ReLU
neck and a caffe-style ResNet-50 with DCNv2 in stages 3-4 (seeded non-zero
offset convs), and KITTI's one camera with the (30, 15) image DPG.  Same
points, images, camera matrices and seeded weights on both sides, through
check_predict (forward logits and boxes within 1e-4, NMS keep sets and
labels exactly)."""

import dataclasses

import numpy as np
import pytest
import torch

from srfdet3d_tpu import config as jconfig
from srfdet3d_tpu import configs as jconfigs
from srfdet3d_torch import config as tconfig
from srfdet3d_torch import configs as tconfigs
from srfdet3d_torch.models.detector import SRFDet
from torch_port_common import check_predict, lidar2img_rig

IMG_H, IMG_W = 64, 128


def _camera_inputs(n_cam, batch_size=2, seed=7):
    rng = np.random.default_rng(seed)
    images = rng.normal(0, 1, (batch_size, n_cam, IMG_H, IMG_W, 3))
    l2i = np.broadcast_to(lidar2img_rig(n_cam, IMG_H, IMG_W),
                          (batch_size, n_cam, 4, 4))
    return {"images": images.astype(np.float32),
            "lidar2img": np.ascontiguousarray(l2i)}


def _lc(config, configs, base, img, **head):
    """One package's config `base` with the image branch `img` (an
    ImgBranchConfig's fields) and the head fields `head`."""
    cfg = getattr(configs, base)()
    return cfg.replace(
        use_img=True,
        img=config.ImgBranchConfig(img_shape=(IMG_H, IMG_W), **img),
        head=dataclasses.replace(cfg.head, **head))


JAX, PORT = (jconfig, jconfigs), (tconfig, tconfigs)

CASES = {
    # VoVNet-19-slim, 2 cameras, a 64-channel plain neck reduced to the
    # head's 32 by img_conv; every camera-proposal pair pooled
    "vovnet_2cam": ("tiny_test_config",
                    dict(backbone="vovnet-19-slim", num_cams=2,
                         neck_out_channels=64),
                    dict(feat_channels_img=64)),
    # the image neck's width equals hidden_dim (no img_conv), BN + ReLU
    # neck, caffe ResNet-50 with DCNv2 in stages 3-4; 8 RoI slots a camera
    "r50_caffe_dcn_bn_neck": ("tiny_test_config",
                              dict(backbone="resnet-50", num_cams=2,
                                   neck_out_channels=32, neck_norm=True,
                                   resnet_style="caffe",
                                   stage_with_dcn=(False, False, True,
                                                   True)),
                              dict(feat_channels_img=32, img_roi_cap=8)),
    # KITTI: one camera, the image DPG resized to (30, 15)
    "kitti_1cam": ("tiny_kitti_test_config",
                   dict(backbone="vovnet-19-slim", num_cams=1,
                        neck_out_channels=64),
                   dict(feat_channels_img=64)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tiny_lc_predict_matches_jax(case):
    base, img, head = CASES[case]
    jcfg = _lc(*JAX, base, img, **head)
    tcfg = _lc(*PORT, base, img, **head)
    offsets = []

    def dcn_offsets(variables):
        # the seeded offset convs are non-zero: the DCN taps move
        blocks = variables["params"]["img_backbone"].values()
        offsets.extend(
            float(np.abs(v["dcn2"]["conv_offset"]["kernel"]).max())
            for v in blocks if "dcn2" in v)

    out = check_predict(jcfg, tcfg, extra=_camera_inputs(img["num_cams"]),
                        variables_hook=dcn_offsets)
    assert out["valid"].sum() > 0
    # ResNet-50: 6 blocks in stage 3, 3 in stage 4
    assert len(offsets) == (9 if tcfg.img.stage_with_dcn[2] else 0)
    assert all(o > 0 for o in offsets)
    port = SRFDet(tcfg, device="cpu")
    assert (port.bbox_head.img_conv is None) == (
        tcfg.head.feat_channels_img == tcfg.head.hidden_dim)


def test_lc_train_mode_runs():
    """An LC model trains: GridMask on (drawn from the step's generator),
    the LiDAR branch and the image backbone's stem and first stages
    frozen as configured; one train step gives finite losses and a finite
    grad norm, and only trainable parameters move."""
    import chip_smoke
    from srfdet3d_torch.configs import tiny_lc_test_config
    from srfdet3d_torch.train.trainer import make_optimizer, train_step
    cfg = tiny_lc_test_config("vovnet")
    assert cfg.img.use_grid_mask and cfg.optim.freeze_lidar
    port = SRFDet(cfg, device="cpu", seed=0)
    opt = make_optimizer(port, cfg, 100)
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    metrics = train_step(port, opt, chip_smoke.train_batch(cfg, 2, seed=0),
                         torch.Generator().manual_seed(0))
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert float(metrics["loss"]) > 0
    trainable = {id(p) for p in opt.params}
    moved = {n for n, p in port.named_parameters()
             if not torch.equal(p.detach(), before[n])}
    assert moved and all(id(dict(port.named_parameters())[n]) in trainable
                         for n in moved)
    assert "img_backbone.stem1.conv.weight" not in moved
    assert "img_neck.lateral.0.conv.weight" in moved


def test_lc_predict_without_images_matches_jax():
    """An LC model given a batch with no images runs its LiDAR branch
    alone on both sides (the image weights loaded but unused):
    check_predict's tolerances."""
    base, img, head = CASES["vovnet_2cam"]
    check_predict(_lc(*JAX, base, img, **head), _lc(*PORT, base, img, **head),
                  init_extra=_camera_inputs(img["num_cams"]))


@pytest.mark.parametrize("patch", ["img_roi_patch", "img_roi_xpatch"])
def test_lc_image_roi_patch_refused(patch):
    """The image RoIAlign's patch routes were refused until they were
    ported: now the model builds with each, every head iteration carries
    its capacity rule, a predict with fallback -1 equals the pairs route's
    bit for bit and one with fallback 0 differs (test_torch_port_options_
    roi.py holds the rules against JAX).  The image branch in bfloat16,
    refused on this config until it was ported, now builds with the rule
    and predicts (`test_torch_port_bf16*.py` hold it against JAX)."""
    base, img, head = CASES["vovnet_2cam"]
    inputs = {k: torch.from_numpy(v) for k, v in _camera_inputs(2).items()}
    pts, mask = np.zeros((2, 2048, 5), np.float32), np.zeros((2, 2048), bool)
    rng = np.random.default_rng(0)
    pts[:, :1024, :3] = rng.uniform(-9, 9, (2, 1024, 3)) * (1, 1, 0.3)
    mask[:, :1024] = True
    batch = {"points": torch.from_numpy(pts),
             "points_mask": torch.from_numpy(mask), **inputs}
    key = patch.split("_")[-1]
    outs = {}
    for fallback in (None, -1, 0):
        rules = {} if fallback is None else {
            patch: 2, f"{patch}_fallback": fallback}
        model = SRFDet(_lc(*PORT, base, img, **head, **rules), device="cpu",
                       seed=1)
        if rules:
            assert all(h.img_rules[key] == 2 and
                       h.img_rules[f"{key}_fallback"] == fallback
                       for h in model.bbox_head.heads)
        with torch.no_grad():
            outs[fallback] = model(batch)
    for a, b in zip(outs[-1], outs[None]):
        assert torch.equal(a, b)
    assert not torch.equal(outs[0][0], outs[None][0])
    bf16 = _lc(*PORT, base, dict(img, compute_dtype="bfloat16"), **head,
               **{patch: 2})
    model = SRFDet(bf16, device="cpu", seed=1)
    assert model.img_dtype == torch.bfloat16
    with torch.no_grad():
        logits, boxes = model(batch)
    assert logits.dtype == torch.float32 and boxes.dtype == torch.float32
    assert torch.isfinite(logits).all() and torch.isfinite(boxes).all()
    assert not torch.equal(logits, outs[None][0])
