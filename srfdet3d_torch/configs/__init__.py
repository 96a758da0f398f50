"""The configs the port runs, built exactly as the JAX package builds them:
all 11 shipped models, the five LiDAR-only ones (the flagship voxel, the
pillar and the dynamic-voxel nuScenes models, the KITTI voxel model, the
Waymo dynamic-voxel model) and their six LiDAR-camera (LC) twins, and the
miniature test configs of the voxel, KITTI and pillar families.
`get_config(name)` resolves them by the JAX package's names.  The tiny LC
configs (`tiny_lc_test_config`) are the port's own: the JAX package ships
none, and its tests build the same ones from its own config classes."""

from __future__ import annotations

import dataclasses

from ..config import (AugConfig, BackboneConfig, HeadConfig,
                      ImgBranchConfig, LossConfig, MiddleConfig, OptimConfig,
                      OTAConfig, SRFDetConfig, TestConfig, VFEConfig)

NUS_CLASSES = ("car", "truck", "construction_vehicle", "bus", "trailer",
               "barrier", "motorcycle", "bicycle", "pedestrian",
               "traffic_cone")
KITTI_CLASSES = ("Pedestrian", "Cyclist", "Car")
WAYMO_CLASSES = ("Car", "Pedestrian", "Cyclist")

# mmdet3d SparseEncoder defaults (used by the KITTI configs, which do not
# override encoder_channels; sparse_encoder_custom.py:30-34)
_KITTI_ENC_CHANNELS = ((16,), (32, 32, 32), (64, 64, 64), (64, 64, 64))
_KITTI_ENC_PADDINGS = ((1,), (1, 1, 1), (1, 1, 1), ((0, 1, 1), 1, 1))


def srfdet_voxel_nusc_L() -> SRFDetConfig:
    """configs/nus/srfdet_voxel_nusc_L.py: the flagship, LiDAR only, with the
    32-cell patch RoIAlign and 64 fallback slots for misfit RoIs."""
    base = SRFDetConfig(name="srfdet_voxel_nusc_L")
    return base.replace(
        head=dataclasses.replace(base.head, roi_patch=32,
                                 roi_patch_fallback=64))


def srfdet_pillar_nusc_L() -> SRFDetConfig:
    """configs/nus/srfdet_pillar_nusc_L.py: PillarFeatureNet on a 512 x 512
    pillar grid, the pillar scatter, a stride-2 SECOND, max-pool FPN extras
    (the pillar neck never sets add_extra_convs) and head strides
    (2, 4, 8, 16)."""
    pc = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)
    return SRFDetConfig(
        name="srfdet_pillar_nusc_L",
        pc_range=pc,
        voxel_size=(0.2, 0.2, 8.0),
        out_size_factor=2,
        max_points_per_voxel=20,
        voxels_cap=40000,
        vfe=VFEConfig(kind="pillar", in_channels=5, feat_channels=(64,)),
        middle=MiddleConfig(kind="pillar_scatter", in_channels=64),
        backbone=BackboneConfig(out_channels=(64, 128, 256),
                                layer_nums=(3, 5, 5),
                                layer_strides=(2, 2, 2)),
        neck_extra_convs=False,
        head=HeadConfig(lidar_strides=(2, 4, 8, 16)),
        test=TestConfig(post_center_range=(
            -61.2, -61.2, -10.0, 61.2, 61.2, 10.0)),
        ota=OTAConfig(pc_range=pc))


def srfdet_dvoxel_waymo_L() -> SRFDetConfig:
    """configs/waymo/srfdet_dvoxel_waymo_L.py: dynamic voxelization on a
    41 x 1536 x 1536 grid, DynamicVFE (5, 5) without the centroid MLP, the
    basicblock encoder, a 3-class code-8 head."""
    pc = (-76.8, -76.8, -2.0, 76.8, 76.8, 4.0)
    return SRFDetConfig(
        name="srfdet_dvoxel_waymo_L",
        dataset="waymo",
        class_names=WAYMO_CLASSES,
        pc_range=pc,
        voxel_size=(0.1, 0.1, 0.15),
        points_cap=262144,
        points_dim=5,
        gt_cap=256,
        max_points_per_voxel=-1,
        voxels_cap=131072,
        vfe=VFEConfig(kind="dynamic", in_channels=5, feat_channels=(5, 5),
                      with_centroid_aware=False),
        middle=MiddleConfig(kind="sparse", in_channels=5),
        head=HeadConfig(num_classes=3, code_size=8),
        ota=OTAConfig(pc_range=pc),
        loss=LossConfig(code_weights=(1.0,) * 8, num_classes=3),
        test=TestConfig(post_center_range=(-80.0, -80.0, -10.0, 80.0, 80.0,
                                           10.0)),
        optim=OptimConfig(epochs=36, warmup_iters=3000),
        aug=AugConfig(scale_range=(0.95, 1.05),
                      trans_std=(0.0, 0.0, 0.0)))


def srfdet_dvoxel_nusc_L() -> SRFDetConfig:
    """configs/others/srfdet_dvoxel_nusc_L.py: the flagship's grid with
    dynamic voxelization (160k voxel slots), DynamicVFE (5, 5), a 256-channel
    FPN and head, 6 iterations, dim_feedforward 1024, dynamic_dim 64."""
    return SRFDetConfig(
        name="srfdet_dvoxel_nusc_L",
        max_points_per_voxel=-1,
        voxels_cap=160000,
        vfe=VFEConfig(kind="dynamic", in_channels=5, feat_channels=(5, 5),
                      with_centroid_aware=False),
        middle=MiddleConfig(kind="sparse", in_channels=5),
        neck_out_channels=256,
        head=HeadConfig(feat_channels_lidar=256, num_heads=6,
                        dim_feedforward=1024, dynamic_dim=64),
        optim=OptimConfig(batch_size_per_device=4))


# the nuScenes LC fine-tune schedule: batch 1, 10 epochs, warmup 5000,
# the LiDAR branch frozen
_NUSC_LC_OPTIM = OptimConfig(freeze_lidar=True, batch_size_per_device=1,
                             epochs=10, warmup_iters=5000)


def srfdet_voxel_nusc_LC() -> SRFDetConfig:
    """configs/nus/srfdet_voxel_nusc_LC.py: the flagship with VoVNet-99 on
    six 928 x 1600 cameras and 320 image-RoI slots a camera."""
    base = srfdet_voxel_nusc_L()
    return base.replace(
        name="srfdet_voxel_nusc_LC", use_img=True,
        img=ImgBranchConfig(backbone="vovnet-99", num_cams=6,
                            img_shape=(928, 1600), mode="pad"),
        head=dataclasses.replace(base.head, img_roi_cap=320,
                                 unroll_predict=True),
        optim=_NUSC_LC_OPTIM, aug=AugConfig.none())


def srfdet_voxel_r50_LC() -> SRFDetConfig:
    """configs/nus/srfdet_voxel_r50_nusc_LC.py: ResNet-50 (pytorch style,
    RGB input) in VoVNet-99's place."""
    return srfdet_voxel_nusc_LC().replace(
        name="srfdet_voxel_r50_LC",
        img=ImgBranchConfig(backbone="resnet-50", num_cams=6,
                            img_shape=(928, 1600), mode="pad",
                            frozen_stages=1, bgr=False))


def srfdet_pillar_r50_LC() -> SRFDetConfig:
    """configs/nus/srfdet_pillar_r50_nusc_LC.py: the pillar model with
    ResNet-50 (every camera-proposal pair pooled: no RoI cap)."""
    return srfdet_pillar_nusc_L().replace(
        name="srfdet_pillar_r50_LC", use_img=True,
        img=ImgBranchConfig(backbone="resnet-50", num_cams=6,
                            img_shape=(928, 1600), mode="pad",
                            frozen_stages=1, bgr=False),
        optim=_NUSC_LC_OPTIM, aug=AugConfig.none())


def srfdet_pillar_v299_LC() -> SRFDetConfig:
    """configs/nus/srfdet_pillar_v299_nusc_LC.py: the pillar model with
    VoVNet-99."""
    return srfdet_pillar_nusc_L().replace(
        name="srfdet_pillar_v299_LC", use_img=True,
        img=ImgBranchConfig(backbone="vovnet-99", num_cams=6,
                            img_shape=(928, 1600), mode="pad"),
        optim=_NUSC_LC_OPTIM, aug=AugConfig.none())


def srfdet_voxel_kitti_LC() -> SRFDetConfig:
    """configs/kitti/srfdet_voxel_kitti_LC.py: the KITTI voxel model with
    VoVNet-99 on one 384 x 1248 front camera, hidden_dim 256."""
    base = srfdet_voxel_kitti_L()
    return base.replace(
        name="srfdet_voxel_kitti_LC", use_img=True,
        img=ImgBranchConfig(backbone="vovnet-99", num_cams=1,
                            img_shape=(384, 1248), mode="pad"),
        head=dataclasses.replace(base.head, hidden_dim=256),
        optim=OptimConfig(freeze_lidar=True, batch_size_per_device=4,
                          epochs=20, warmup_iters=200),
        aug=dataclasses.replace(AugConfig.none(), flip_horizontal=0.5,
                                sync_flip_2d=True))


def srfdet_dvoxel_waymo_LC() -> SRFDetConfig:
    """configs/others/srfdet_dvoxel_waymo_LC.py: the Waymo dynamic-voxel
    model with a caffe-style ResNet-101, DCNv2 in stages 3-4, on five
    640 x 960 cameras, and a 128-channel BN + ReLU image neck (equal to
    hidden_dim: no img_conv)."""
    base = srfdet_dvoxel_waymo_L()
    return base.replace(
        name="srfdet_dvoxel_waymo_LC", use_img=True,
        img=ImgBranchConfig(backbone="resnet-101", num_cams=5,
                            img_shape=(640, 960), mode="resize",
                            frozen_stages=1, neck_out_channels=128,
                            neck_norm=True, resnet_style="caffe",
                            stage_with_dcn=(False, False, True, True),
                            norm_frozen=True),
        head=dataclasses.replace(base.head, feat_channels_img=128),
        optim=OptimConfig(freeze_lidar=True, batch_size_per_device=2,
                          epochs=15, warmup_iters=3000),
        aug=AugConfig.none())


def tiny_test_config(**overrides) -> SRFDetConfig:
    """A miniature config for fast unit/integration tests."""
    pc = (-10.0, -10.0, -5.0, 10.0, 10.0, 3.0)
    cfg = SRFDetConfig(
        name="tiny",
        class_names=("car", "pedestrian", "cyclist"),
        pc_range=pc,
        voxel_size=(0.25, 0.25, 0.2),     # 80x80x40 grid
        points_cap=2048,
        gt_cap=8,
        max_points_per_voxel=10,
        voxels_cap=2048,
        vfe=VFEConfig(kind="hard_simple", in_channels=5),
        middle=MiddleConfig(
            kind="sparse", in_channels=5, base_channels=8,
            output_channels=32,
            encoder_channels=((8, 16), (16, 16), (16, 16), (16, 16)),
            encoder_paddings=((0, 1), (0, 1), (0, (0, 1, 1)), (0, 0)),
            block_type="basicblock",
            capacities=(1024, 512, 256, 256)),
        backbone=BackboneConfig(out_channels=(32, 64), layer_nums=(1, 1),
                                layer_strides=(1, 2)),
        neck_out_channels=32,
        head=HeadConfig(num_classes=3, feat_channels_lidar=32,
                        hidden_dim=32, num_proposals=24, num_heads=2,
                        num_dpg_exp=2, dim_feedforward=64, num_attn_heads=4,
                        dynamic_dim=8, dropout=0.0),
        ota=OTAConfig(pc_range=pc),
        loss=LossConfig(num_classes=3),
        test=TestConfig(max_per_img=16,
                        post_center_range=(-12.0, -12.0, -10.0, 12.0, 12.0,
                                           10.0)))
    return cfg.replace(**overrides) if overrides else cfg


def srfdet_voxel_kitti_L() -> SRFDetConfig:
    """configs/kitti/srfdet_voxel_kitti_L.py: dynamic voxelization, the
    conv_module encoder, max-pool FPN extras, a 3-class code-8 head at
    width 256."""
    pc = (0.0, -40.0, -3.0, 70.4, 40.0, 1.0)
    return SRFDetConfig(
        name="srfdet_voxel_kitti_L",
        dataset="kitti",
        class_names=KITTI_CLASSES,
        pc_range=pc,
        voxel_size=(0.05, 0.05, 0.1),
        points_cap=131072,
        points_dim=4,
        gt_cap=64,
        max_points_per_voxel=-1,          # dynamic voxelization
        voxels_cap=65536,
        vfe=VFEConfig(kind="dynamic", in_channels=4, feat_channels=(4,),
                      with_centroid_aware=False),
        middle=MiddleConfig(
            kind="sparse", in_channels=4, output_channels=128,
            encoder_channels=_KITTI_ENC_CHANNELS,
            encoder_paddings=_KITTI_ENC_PADDINGS,
            block_type="conv_module",
            capacities=(40000, 25000, 15000, 15000)),
        neck_out_channels=256,
        # the KITTI pts_neck never sets add_extra_convs: max-pool extras
        neck_extra_convs=False,
        head=HeadConfig(num_classes=3, feat_channels_lidar=256,
                        code_size=8, dim_feedforward=1024, dynamic_dim=64),
        ota=OTAConfig(pc_range=pc),
        loss=LossConfig(code_weights=(1.0,) * 8, num_classes=3),
        test=TestConfig(post_center_range=(0.0, -50.0, -5.0, 80.4, 50.0,
                                           5.0)),
        optim=OptimConfig(epochs=40, warmup_iters=200),
        aug=AugConfig(scale_range=(0.95, 1.05), trans_std=(0.0, 0.0, 0.0),
                      flip_vertical=0.0, object_noise=True))


def tiny_kitti_test_config(**overrides) -> SRFDetConfig:
    """Miniature KITTI-style config: dynamic voxelization, code size 8,
    the conv_module sparse encoder, max-pool FPN extras."""
    pc = (0.0, -10.0, -3.0, 20.0, 10.0, 1.0)
    cfg = tiny_test_config().replace(
        name="tiny_kitti",
        dataset="kitti",
        class_names=("Pedestrian", "Cyclist", "Car"),
        neck_extra_convs=False,
        pc_range=pc,
        voxel_size=(0.25, 0.25, 0.1),     # 80 x 80 x 40 grid
        points_dim=4,
        max_points_per_voxel=-1,
        vfe=VFEConfig(kind="dynamic", in_channels=4, feat_channels=(4,)),
        middle=MiddleConfig(
            kind="sparse", in_channels=4, base_channels=8,
            output_channels=32,
            encoder_channels=((8,), (16, 16), (16, 16), (16, 16)),
            encoder_paddings=((1,), (1, 1), (1, 1), ((0, 1, 1), 1)),
            block_type="conv_module",
            capacities=(1024, 512, 256, 256)),
        head=HeadConfig(num_classes=3, feat_channels_lidar=32,
                        hidden_dim=32, num_proposals=24, num_heads=2,
                        num_dpg_exp=2, dim_feedforward=64, num_attn_heads=4,
                        dynamic_dim=8, dropout=0.0, code_size=8),
        ota=OTAConfig(pc_range=pc),
        loss=LossConfig(code_weights=(1.0,) * 8, num_classes=3),
        test=TestConfig(max_per_img=16,
                        post_center_range=(-2.0, -12.0, -10.0, 22.0, 12.0,
                                           10.0)))
    return cfg.replace(**overrides) if overrides else cfg


def tiny_pillar_test_config(**overrides) -> SRFDetConfig:
    """Miniature pillar config: PillarFeatureNet -> pillar scatter ->
    stride-2 SECOND -> max-pool FPN extras, head strides (2, 4, 8, 16)."""
    pc = (-10.0, -10.0, -5.0, 10.0, 10.0, 3.0)
    cfg = tiny_test_config().replace(
        name="tiny_pillar",
        pc_range=pc,
        voxel_size=(0.25, 0.25, 8.0),     # 80 x 80 x 1 grid
        out_size_factor=2,
        max_points_per_voxel=8,
        voxels_cap=1024,
        vfe=VFEConfig(kind="pillar", in_channels=5, feat_channels=(32,)),
        middle=MiddleConfig(kind="pillar_scatter", in_channels=32),
        backbone=BackboneConfig(out_channels=(32, 32, 64),
                                layer_nums=(1, 1, 1),
                                layer_strides=(2, 2, 2)),
        neck_extra_convs=False,
        neck_out_channels=32,
        head=dataclasses.replace(tiny_test_config().head,
                                 lidar_strides=(2, 4, 8, 16)),
        ota=OTAConfig(pc_range=pc))
    return cfg.replace(**overrides) if overrides else cfg


def tiny_lc_test_config(backbone: str = "vovnet", freeze_img: bool = False,
                        freeze_lidar: bool = True, **img) -> SRFDetConfig:
    """A miniature LC config on tiny_test_config: two 64 x 128 cameras and
    the LiDAR branch frozen, as in the shipped LC fine-tunes.  "vovnet":
    VoVNet-19-slim, a 64-channel plain image neck reduced to the head's 32
    by img_conv, every camera-proposal pair pooled; "r50_dcn": a caffe
    ResNet-50 with DCNv2 in stages 3-4, a 32-channel BN + ReLU neck (no
    img_conv) and 8 image-RoI slots a camera.  `img` overrides
    ImgBranchConfig fields (frozen_stages, norm_frozen, norm_eval,
    use_grid_mask, ...)."""
    base = tiny_test_config()
    if backbone == "vovnet":
        branch = dict(backbone="vovnet-19-slim", neck_out_channels=64)
        head = dict(feat_channels_img=64)
    elif backbone == "r50_dcn":
        branch = dict(backbone="resnet-50", neck_out_channels=32,
                      neck_norm=True, resnet_style="caffe",
                      stage_with_dcn=(False, False, True, True))
        head = dict(feat_channels_img=32, img_roi_cap=8)
    else:
        raise KeyError(f"no tiny LC backbone {backbone!r}: 'vovnet' or "
                       f"'r50_dcn'")
    branch = {"num_cams": 2, "img_shape": (64, 128), **branch, **img}
    return base.replace(
        name=f"tiny_lc_{backbone}", use_img=True,
        img=ImgBranchConfig(**branch),
        head=dataclasses.replace(base.head, **head),
        optim=dataclasses.replace(base.optim, freeze_img=freeze_img,
                                  freeze_lidar=freeze_lidar))


CONFIGS = {
    fn.__name__: fn for fn in (
        srfdet_voxel_nusc_L, srfdet_voxel_nusc_LC, srfdet_voxel_r50_LC,
        srfdet_pillar_nusc_L, srfdet_pillar_r50_LC, srfdet_pillar_v299_LC,
        srfdet_voxel_kitti_L, srfdet_voxel_kitti_LC,
        srfdet_dvoxel_waymo_L, srfdet_dvoxel_waymo_LC, srfdet_dvoxel_nusc_L)
}
CONFIGS["tiny"] = lambda: tiny_test_config()
CONFIGS["tiny_kitti"] = lambda: tiny_kitti_test_config()
CONFIGS["tiny_pillar"] = lambda: tiny_pillar_test_config()

def get_config(name: str) -> SRFDetConfig:
    if name in CONFIGS:
        return CONFIGS[name]()
    raise KeyError(f"no config {name!r}; the port has {sorted(CONFIGS)}")
