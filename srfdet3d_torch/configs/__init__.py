"""The configs the port runs so far: the flagship LiDAR-only model and the
miniature test config, built exactly as the JAX package builds them."""

from __future__ import annotations

import dataclasses

from ..config import (BackboneConfig, HeadConfig, LossConfig, MiddleConfig,
                      OTAConfig, SRFDetConfig, TestConfig, VFEConfig)


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
