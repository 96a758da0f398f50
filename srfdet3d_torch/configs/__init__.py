"""The configs the port runs so far, built exactly as the JAX package builds
them: the flagship LiDAR-only nuScenes model, the KITTI voxel model, and the
miniature test configs of both families."""

from __future__ import annotations

import dataclasses

from ..config import (AugConfig, BackboneConfig, HeadConfig, LossConfig,
                      MiddleConfig, OptimConfig, OTAConfig, SRFDetConfig,
                      TestConfig, VFEConfig)

KITTI_CLASSES = ("Pedestrian", "Cyclist", "Car")

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
