"""Configuration dataclasses of the PyTorch port.

A copy of the JAX package's typed configs (field for field, same defaults),
so that a config built here describes the same experiment as its JAX
counterpart.  Capacity fields (`points_cap`, `voxels_cap`, sparse
`capacities`, `gt_cap`) size the static buffers both packages use.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class VoxelizationSpec:
    voxel_size: Tuple[float, float, float]
    point_cloud_range: Tuple[float, float, float, float, float, float]
    max_num_points: int  # -1 => dynamic voxelization (no per-voxel cap)
    max_voxels: int      # static voxel capacity V_cap

    @property
    def grid_size(self) -> Tuple[int, int, int]:
        """(nx, ny, nz) voxel counts."""
        pc = self.point_cloud_range
        vs = self.voxel_size
        return (
            int(round((pc[3] - pc[0]) / vs[0])),
            int(round((pc[4] - pc[1]) / vs[1])),
            int(round((pc[5] - pc[2]) / vs[2])),
        )

    @property
    def sparse_shape(self) -> Tuple[int, int, int]:
        """(D, H, W) = (nz + 1, ny, nx): the mmdet3d convention of one
        always-empty top z plane (41 planes for a 40-cell z grid)."""
        nx, ny, nz = self.grid_size
        return (nz + 1, ny, nx)


@dataclasses.dataclass(frozen=True)
class OTAConfig:
    """Static assigner parameters (carried by SRFDetConfig; train only)."""
    cls_weight: float = 2.0
    cls_alpha: float = 0.25
    cls_gamma: float = 2.0
    cls_eps: float = 1e-8
    reg_weight: float = 0.25
    iou_weight: float = 0.25
    center_radius: float = 2.5
    candidate_topk: int = 8
    num_heads: int = 6
    pc_range: Tuple[float, ...] = (-55.2, -55.2, -5.0, 55.2, 55.2, 3.0)


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """loss_cls / loss_bbox settings (carried by SRFDetConfig; train only)."""
    cls_weight: float = 2.0
    cls_alpha: float = 0.25
    cls_gamma: float = 2.0
    bbox_weight: float = 0.25
    code_weights: Tuple[float, ...] = (
        1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.2, 0.2)
    num_classes: int = 10
    assigner: str = "ota"


@dataclasses.dataclass(frozen=True)
class TestConfig:
    use_nms: bool = True
    nms_thr: float = 0.4
    score_thr: float = 0.1
    max_per_img: int = 300
    post_center_range: Tuple[float, ...] = (
        -61.2, -61.2, -10.0, 61.2, 61.2, 10.0)


@dataclasses.dataclass(frozen=True)
class VFEConfig:
    kind: str = "hard_simple"          # hard_simple | pillar | dynamic
    in_channels: int = 5
    feat_channels: Tuple[int, ...] = ()
    with_distance: bool = False
    with_cluster_center: bool = True
    with_voxel_center: bool = True
    with_centroid_aware: bool = False


@dataclasses.dataclass(frozen=True)
class MiddleConfig:
    kind: str = "sparse"               # sparse | pillar_scatter
    in_channels: int = 5
    base_channels: int = 16
    output_channels: int = 128
    encoder_channels: Tuple[Tuple[int, ...], ...] = (
        (16, 16, 32), (32, 32, 64), (64, 64, 128), (128, 128))
    encoder_paddings: Tuple[Tuple, ...] = (
        (0, 0, 1), (0, 0, 1), (0, 0, (0, 1, 1)), (0, 0))
    block_type: str = "basicblock"
    # static voxel capacities after each downsample stage + conv_out
    capacities: Tuple[int, ...] = (60000, 30000, 15000, 15000)
    rulebook: str = "bitmap"


@dataclasses.dataclass(frozen=True)
class BackboneConfig:
    out_channels: Tuple[int, ...] = (128, 256)
    layer_nums: Tuple[int, ...] = (5, 5)
    layer_strides: Tuple[int, ...] = (1, 2)


@dataclasses.dataclass(frozen=True)
class ImgBranchConfig:
    backbone: str = "vovnet-99"
    frozen_stages: int = 2
    norm_eval: bool = True
    neck_out_channels: int = 256
    neck_num_outs: int = 4
    relu_before_extra_convs: bool = True
    neck_norm: bool = False
    norm_frozen: bool = False
    compute_dtype: str = ""
    resnet_style: str = "pytorch"
    stage_with_dcn: Tuple[bool, ...] = (False, False, False, False)
    num_cams: int = 6
    img_shape: Tuple[int, int] = (928, 1600)
    mode: str = "pad"
    bgr: bool = True
    use_grid_mask: bool = True


@dataclasses.dataclass(frozen=True)
class HeadConfig:
    num_classes: int = 10
    feat_channels_lidar: int = 128
    feat_channels_img: int = 256
    hidden_dim: int = 128
    lidar_feat_lvls: int = 4
    img_feat_lvls: int = 4
    num_proposals: int = 900
    num_heads: int = 5
    deep_supervision: bool = True
    prior_prob: float = 0.01
    with_dpg: bool = True
    num_dpg_exp: int = 4
    with_lidar_encoder: bool = False
    code_size: int = 10
    dim_feedforward: int = 512
    num_cls_convs: int = 2
    num_reg_convs: int = 3
    num_attn_heads: int = 8
    dropout: float = 0.1
    dynamic_dim: int = 32
    lidar_strides: Tuple[int, ...] = (8, 16, 32, 64)
    img_strides: Tuple[int, ...] = (4, 8, 16, 32)
    img_roi_cap: int = 0
    # >0: patch RoIAlign window of P cells; RoIs whose weighted cells do not
    # fit take `roi_patch_fallback` slots in RoI order (-1 = all of them,
    # 0 = none) and the misfits past those slots pool to zeros
    roi_patch: int = 0
    roi_patch_fallback: int = -1
    img_roi_patch: int = 0
    img_roi_patch_fallback: int = -1
    img_roi_xpatch: int = 0
    img_roi_xpatch_fallback: int = -1
    remat: bool = False
    unroll_train: bool = True
    unroll_predict: bool = False


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    lr: float = 2e-4
    batch_size_per_device: int = 6
    weight_decay: float = 0.01
    grad_clip: float = 35.0
    warmup_iters: int = 2000
    warmup_ratio: float = 1.0 / 3
    min_lr_ratio: float = 1e-3
    epochs: int = 20
    freeze_img: bool = False
    freeze_lidar: bool = False
    accum_steps: int = 1


@dataclasses.dataclass(frozen=True)
class AugConfig:
    rot_scale_trans: bool = True
    rot_range: Tuple[float, float] = (-0.785, 0.785)
    scale_range: Tuple[float, float] = (0.9, 1.1)
    trans_std: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    flip_horizontal: float = 0.5
    flip_vertical: float = 0.5
    sync_flip_2d: bool = False
    object_noise: bool = False
    object_noise_trans: Tuple[float, float, float] = (1.0, 1.0, 0.5)
    object_noise_rot: Tuple[float, float] = (-0.78539816, 0.78539816)
    object_noise_tries: int = 100

    @staticmethod
    def none() -> "AugConfig":
        return AugConfig(rot_scale_trans=False, flip_horizontal=0.0,
                         flip_vertical=0.0)


@dataclasses.dataclass(frozen=True)
class SRFDetConfig:
    """One experiment = one reference config file."""
    name: str = "srfdet_voxel_nusc_L"
    dataset: str = "nuscenes"          # nuscenes | kitti | waymo
    compute_dtype: str = "float32"
    class_names: Tuple[str, ...] = (
        "car", "truck", "construction_vehicle", "bus", "trailer", "barrier",
        "motorcycle", "bicycle", "pedestrian", "traffic_cone")
    pc_range: Tuple[float, ...] = (-55.2, -55.2, -5.0, 55.2, 55.2, 3.0)
    voxel_size: Tuple[float, ...] = (0.075, 0.075, 0.2)
    out_size_factor: int = 8
    use_img: bool = False
    points_cap: int = 262144
    points_dim: int = 5
    gt_cap: int = 256
    max_points_per_voxel: int = 10
    voxels_cap: int = 120000
    vfe: VFEConfig = VFEConfig()
    middle: MiddleConfig = MiddleConfig()
    backbone: BackboneConfig = BackboneConfig()
    neck_out_channels: int = 128
    neck_num_outs: int = 4
    neck_extra_convs: bool = True
    img: Optional[ImgBranchConfig] = None
    head: HeadConfig = HeadConfig()
    ota: OTAConfig = OTAConfig()
    loss: LossConfig = LossConfig()
    test: TestConfig = TestConfig()
    optim: OptimConfig = OptimConfig()
    aug: AugConfig = AugConfig()

    @property
    def num_classes(self) -> int:
        return len(self.class_names)

    @property
    def voxelization(self) -> VoxelizationSpec:
        return VoxelizationSpec(
            voxel_size=tuple(self.voxel_size),
            point_cloud_range=tuple(self.pc_range),
            max_num_points=self.max_points_per_voxel,
            max_voxels=self.voxels_cap)

    @property
    def grid_size(self) -> Tuple[int, int, int]:
        return self.voxelization.grid_size

    def replace(self, **kw) -> "SRFDetConfig":
        return dataclasses.replace(self, **kw)
