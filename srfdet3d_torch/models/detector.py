"""SRFDet detector, LiDAR path (reference models/detectors/srfdet.py).

Voxelization -> HardSimpleVFE -> sparse encoder -> SECOND -> FPN -> SRFDet
head.  Input contract, as in the JAX package:

    batch = {"points": (B, P_cap, D) padded float32 point clouds,
             "points_mask": (B, P_cap) bool}

The model lives on `cuda` unless built with device="cpu"; weights are a
seeded random init (`seed`) or come from the JAX package through
`utils.jax_params.load_jax_params`.  It is built in eval mode; `.train()`
puts it in train mode (batch-statistics BN, the head's dropout, whose masks
come from the generator passed to `forward`), except that with
`cfg.optim.freeze_lidar` the `pts_*` modules stay in eval mode and keep
their BN statistics, and their features are detached (JAX
`detector.py:191-203`).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .. import resolve_device, set_backend_flags
from ..config import SRFDetConfig
from ..ops.voxelize import VoxelizedPoints, voxelize_points_batched
from .fpn import FPN
from .head import SRFDetHead, decode_boxes, focal_bias
from .layers import MaskedBatchNorm
from .second import SECOND
from .sparse_encoder import GatheredConvBN, SparseEncoder
from .vfe import HardSimpleVFE

# the LiDAR branch that cfg.optim.freeze_lidar freezes
LIDAR_MODULES = ("pts_voxel_encoder", "pts_middle_encoder", "pts_backbone",
                 "pts_neck")


def _flatten_voxelization(vox: VoxelizedPoints, v_cap: int
                          ) -> VoxelizedPoints:
    """Merge the batch dim into the voxel and point dims with per-sample
    slot offsets, so the VFE's segment mean runs once over the batch."""
    b, p = vox.point_voxel_idx.shape
    offset = (torch.arange(b, device=vox.point_voxel_idx.device) *
              v_cap)[:, None]
    flat_idx = torch.where(vox.point_voxel_idx < v_cap,
                           vox.point_voxel_idx + offset, b * v_cap)
    return VoxelizedPoints(
        point_voxel_idx=flat_idx.reshape(-1),
        point_mask=vox.point_mask.reshape(-1),
        voxel_coords=vox.voxel_coords.reshape(-1, 3),
        voxel_mask=vox.voxel_mask.reshape(-1))


def _conv_out_size(n: int, stride: int = 2, pad: int = 1) -> int:
    return (n + 2 * pad - 3) // stride + 1


def bev_geometry(cfg: SRFDetConfig):
    """(depth of the encoder's output, the FPN levels' (H, W)): the plan
    size after the encoder's downsamples, then SECOND's strides and the
    FPN's stride-2 extra levels."""
    m = cfg.middle
    d, h, w = cfg.voxelization.sparse_shape
    n_stages = len(m.encoder_channels)
    for i, blocks in enumerate(m.encoder_channels[:n_stages - 1]):
        pad = m.encoder_paddings[i][len(blocks) - 1]
        pz, py, px = (pad,) * 3 if isinstance(pad, int) else pad
        d = _conv_out_size(d, 2, pz)
        h, w = _conv_out_size(h, 2, py), _conv_out_size(w, 2, px)
    d = _conv_out_size(d, 2, 0)
    sizes = []
    for s in cfg.backbone.layer_strides:
        h, w = _conv_out_size(h, s), _conv_out_size(w, s)
        sizes.append((h, w))
    while len(sizes) < cfg.neck_num_outs:
        h, w = _conv_out_size(h), _conv_out_size(w)
        sizes.append((h, w))
    return d, sizes


def _check_supported(cfg: SRFDetConfig) -> None:
    unsupported = []
    if cfg.use_img:
        unsupported.append("use_img")
    if cfg.compute_dtype != "float32":
        unsupported.append(f"compute_dtype={cfg.compute_dtype}")
    if cfg.vfe.kind != "hard_simple":
        unsupported.append(f"vfe.kind={cfg.vfe.kind}")
    if cfg.middle.kind != "sparse" or cfg.middle.rulebook != "bitmap":
        unsupported.append("middle: sparse bitmap only")
    if cfg.middle.block_type != "basicblock":
        unsupported.append(f"block_type={cfg.middle.block_type}")
    if not cfg.neck_extra_convs:
        unsupported.append("neck_extra_convs=False")
    if not cfg.head.with_dpg or cfg.head.with_lidar_encoder:
        unsupported.append("head: DPG on, no lidar encoder")
    if unsupported:
        raise NotImplementedError(
            "srfdet3d_torch runs the LiDAR voxel path only; not yet ported: "
            + ", ".join(unsupported))


class SRFDet(nn.Module):
    """forward(batch) -> (pred_logits (L, B, n_p, #cls), pred_boxes
    (L, B, n_p, code) with absolute centers); predict(batch) decodes."""

    def __init__(self, cfg: SRFDetConfig, device=None, seed: int = 0):
        super().__init__()
        _check_supported(cfg)
        dev = resolve_device(device)
        set_backend_flags()
        self.cfg = cfg
        spec = cfg.voxelization
        m = cfg.middle
        self.pts_voxel_encoder = HardSimpleVFE(cfg.vfe.in_channels)
        self.pts_middle_encoder = SparseEncoder(
            m.in_channels, spec.sparse_shape, m.base_channels,
            m.output_channels, m.encoder_channels, m.encoder_paddings,
            m.capacities)

        d, sizes = bev_geometry(cfg)
        bb = cfg.backbone
        self.pts_backbone = SECOND(d * m.output_channels, bb.out_channels,
                                   bb.layer_nums, bb.layer_strides)
        self.pts_neck = FPN(bb.out_channels, cfg.neck_out_channels,
                            cfg.neck_num_outs)
        hc = cfg.head
        if hc.feat_channels_lidar != cfg.neck_out_channels:
            raise ValueError("head.feat_channels_lidar must equal the neck's")
        self.bbox_head = SRFDetHead(
            cfg.num_classes, hc.feat_channels_lidar, cfg.neck_num_outs,
            sizes[-1][0] * sizes[-1][1], num_proposals=hc.num_proposals,
            num_heads=hc.num_heads, num_dpg_exp=hc.num_dpg_exp,
            code_size=hc.code_size, deep_supervision=hc.deep_supervision,
            pc_range=tuple(cfg.pc_range), voxel_size=tuple(cfg.voxel_size),
            dim_feedforward=hc.dim_feedforward,
            num_cls_convs=hc.num_cls_convs, num_reg_convs=hc.num_reg_convs,
            num_attn_heads=hc.num_attn_heads, dynamic_dim=hc.dynamic_dim,
            lidar_strides=tuple(hc.lidar_strides), roi_patch=hc.roi_patch,
            roi_patch_fallback=hc.roi_patch_fallback, dropout=hc.dropout)
        self._init_weights(torch.Generator().manual_seed(seed))
        self.to(dev)
        self.eval()

    def train(self, mode: bool = True) -> "SRFDet":
        super().train(mode)
        if mode and self.cfg.optim.freeze_lidar:
            for name in LIDAR_MODULES:
                getattr(self, name).eval()
        return self

    @property
    def device(self) -> torch.device:
        return self.bbox_head.init_proposal_boxes.device

    @torch.no_grad()
    def _init_weights(self, g: torch.Generator) -> None:
        """Seeded init in the JAX package's families: xavier-uniform dense
        layers, lecun-normal convs, kaiming-normal sparse kernels, N(0, 1)
        proposal embeddings, unit norms, the focal prior on class biases."""
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                fan_out, fan_in = mod.weight.shape
                lim = math.sqrt(6.0 / (fan_in + fan_out))
                mod.weight.copy_(torch.rand(mod.weight.shape, generator=g)
                                 * 2 * lim - lim)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.Conv2d):
                fan_in = mod.weight[0].numel()
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=g)
                                 / math.sqrt(fan_in))
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, GatheredConvBN):
                k, cin, _ = mod.kernel.shape
                mod.kernel.copy_(torch.randn(mod.kernel.shape, generator=g)
                                 * math.sqrt(2.0 / (k * cin)))
            elif isinstance(mod, (nn.LayerNorm, nn.BatchNorm2d,
                                  MaskedBatchNorm)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        head = self.bbox_head
        for p in (head.init_proposal_boxes, head.init_proposal_feats):
            p.copy_(torch.randn(p.shape, generator=g))
        for single in head.heads:
            single.class_logits.bias.fill_(focal_bias(self.cfg.head.prior_prob))

    def _inputs(self, batch: Dict[str, torch.Tensor]):
        dev = self.device
        points = torch.as_tensor(batch["points"], device=dev).float()
        mask = torch.as_tensor(batch["points_mask"], device=dev).bool()
        return points, mask

    def voxel_features(self, points: torch.Tensor,
                       points_mask: torch.Tensor):
        """(B, P, D) points -> ((B, V_cap, F) voxel features, the
        voxelization) through the voxelizer and the VFE."""
        spec = self.cfg.voxelization
        v_cap = spec.max_voxels
        b, p, d = points.shape
        vox = voxelize_points_batched(points, points_mask, spec)
        flat = _flatten_voxelization(vox, v_cap)
        feats = self.pts_voxel_encoder(points.reshape(b * p, d), flat,
                                       b * v_cap)
        return feats.reshape(b, v_cap, -1), vox

    def extract_point_features(self, points: torch.Tensor,
                               points_mask: torch.Tensor
                               ) -> Tuple[torch.Tensor, ...]:
        """(B, P, D) points -> the FPN's NCHW BEV maps."""
        feats, vox = self.voxel_features(points, points_mask)
        bev = self.pts_middle_encoder(feats, vox.voxel_coords,
                                      vox.voxel_mask)   # (B, H, W, D*C)
        stages = self.pts_backbone(bev.permute(0, 3, 1, 2).contiguous())
        return self.pts_neck(stages)

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None):
        """generator: the head's dropout masks in train mode (on the
        model's device)."""
        points, mask = self._inputs(batch)
        maps = self.extract_point_features(points, mask)
        if self.training and self.cfg.optim.freeze_lidar:
            maps = tuple(f.detach() for f in maps)
        return self.bbox_head(maps, generator)

    @torch.no_grad()
    def predict(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """Inference + decode (reference simple_test, srfdet.py:309-335)."""
        pred_logits, pred_boxes = self(batch)
        t = self.cfg.test
        return decode_boxes(pred_logits[-1], pred_boxes[-1],
                            use_nms=t.use_nms, nms_thr=t.nms_thr,
                            score_thr=t.score_thr, max_per_img=t.max_per_img,
                            post_center_range=t.post_center_range)
