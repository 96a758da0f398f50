"""SRFDet decoder head: DPG init proposals, iterative refinement, and box
decoding with rotated multiclass NMS; LiDAR only, or fused with the camera
images (LC configs).

Box code: [cx, cy, cz, log w, log l, log h, sin, cos (, vx, vy)], centers
normalized to [0, 1] within pc_range between iterations and absolute in the
returned predictions.  The JAX package scans the iterations over stacked
weights; here they are `num_heads` modules in a list.

Train mode (`.train()`) applies dropout where flax's head does: on the
attention weights (one (n_q, n_k) mask shared by batch and heads, flax's
broadcast_dropout), after self-attention, after the dynamic conv, inside
the FFN and after it.  Its masks come from a `torch.Generator` the caller
passes; there is no global seed.

The fusion path (JAX `head.py:120-236`): each proposal's 3D box projects
through every camera's lidar2img to an image RoI; the image levels are
RoI-aligned per (camera, proposal) pair and summed over the cameras, either
for every pair (`img_roi_cap` 0) or for at most `img_roi_cap` visible pairs
a camera, compacted in proposal order (the pairs past the cap are
dropped); a Dense layer projects [image RoI, LiDAR RoI] to the head's
width.  The DPG mixes its LiDAR logits with ones from a staircase over the
image levels.  The image RoIAlign takes the capacity rules of the patch
and xpatch options (`ops.roi_align`) per (sample, camera) row, after the
cap's compaction.

Options no shipped config turns on: `with_dpg=False` (the learned
proposals, broadcast over the batch, with no DPG modules),
`with_lidar_encoder` (the deformable-attention BEV encoder over the LiDAR
levels before the proposals, `deform_attn.LidarBEVEncoder`), and `remat`
(each refinement iteration recomputed in the backward pass,
`torch.utils.checkpoint`).  The JAX package's `unroll_train` and
`unroll_predict` choose how XLA compiles its scan; the port runs the
iterations eagerly, one module each, which is what both give.

In bfloat16 (`dtype`, layers.set_dtype) the Linear layers, the attention,
the DynamicConv and the LayerNorms compute in bfloat16 (JAX `head.py:75-98`,
`:332-387`, `:484-570`); the RoIAlign's float32 weights promote its pooled
features to float32, which promotes DynamicConv's first product, as in the
JAX package.  The proposal boxes, the DPG's mixture of the learned
proposals, `apply_deltas` and decode are float32 in every mode.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..geometry.boxes import boxes3d_to_corners3d, denormalize_bbox
from ..geometry.iou import multiclass_nms_3d
from ..ops.roi_align import multilevel_roi_align
from .deform_attn import LidarBEVEncoder
from .layers import (Conv2d, ConvBNReLU, LayerNorm, Linear, dropout,
                     softmax)

_DEFAULT_SCALE_CLAMP = math.log(100000.0 / 16)


def focal_bias(prior_prob: float) -> float:
    return -math.log((1 - prior_prob) / prior_prob)


def denormalize_centers(boxes: torch.Tensor, pc_range) -> torch.Tensor:
    """[0, 1] centers -> absolute within pc_range (columns 0:3)."""
    lo = boxes.new_tensor(pc_range[:3])
    hi = boxes.new_tensor(pc_range[3:6])
    return torch.cat([boxes[..., :3] * (hi - lo) + lo, boxes[..., 3:]], -1)


def lidar_rois_from_boxes(boxes_abs: torch.Tensor, pc_range, voxel_size
                          ) -> torch.Tensor:
    """(..., code) boxes with absolute centers -> (..., 4) axis-aligned BEV
    RoIs [x1, y1, x2, y2] in the stride-1 grid frame."""
    corners = boxes3d_to_corners3d(boxes_abs[..., :8], bottom_center=False,
                                   yaw_as_sincos=True, log_size=True)
    lo = boxes_abs.new_tensor(pc_range[:2])
    vs = boxes_abs.new_tensor(voxel_size[:2])
    xy = (corners[..., :2] - lo) / vs
    return torch.cat([xy.amin(-2), xy.amax(-2)], -1)


def img_rois_from_boxes(boxes_abs: torch.Tensor,
                        lidar2img: torch.Tensor) -> torch.Tensor:
    """(B, n_p, code) boxes with absolute centers, lidar2img (B, n_cam, 4,
    4) -> (B, n_cam, n_p, 4) image RoIs [x1, y1, x2, y2]: the min and max
    of the 8 projected corners, depth clamped at 1e-5 (a corner behind the
    camera lands far outside the image, as in the reference)."""
    corners = boxes3d_to_corners3d(boxes_abs[..., :8], bottom_center=False,
                                   yaw_as_sincos=True, log_size=True)
    hom = torch.cat([corners, torch.ones_like(corners[..., :1])], -1)
    cam = torch.einsum("bkij,bpcj->bkpci", lidar2img, hom)
    xy = cam[..., 0:2] / cam[..., 2:3].clamp_min(1e-5)
    return torch.cat([xy.amin(-2), xy.amax(-2)], -1)


def visible_mask(cam_rois: torch.Tensor, img_shape, strides) -> torch.Tensor:
    """Which RoIs reach the image within the coarsest level's sample reach
    (2 * max stride); past it every bilinear sample reads zero."""
    h_img, w_img = img_shape
    margin = float(2 * max(strides))
    x1, y1, x2, y2 = cam_rois.unbind(-1)
    return ((x2 >= -margin) & (x1 <= w_img + margin) &
            (y2 >= -margin) & (y1 <= h_img + margin))


def visible_pair_counts(cam_rois: torch.Tensor, img_shape, strides
                        ) -> torch.Tensor:
    """(B, n_cam) RoIs each camera would keep; the compaction of
    pooled_img_roi is exact while every count stays <= img_roi_cap.  A box
    behind a camera projects to a huge RoI that straddles the image and
    counts."""
    return visible_mask(cam_rois, img_shape, strides).sum(-1)


def compact_pairs(cam_rois: torch.Tensor, img_shape, strides, cap: int):
    """The visible pairs of each camera in `cap` slots, in proposal order
    (a cumulative sum); the pairs past the cap are dropped.  cam_rois
    (B, n_cam, n_p, 4) -> (rois (B*n_cam, cap, 4), the off-image RoI -1e6
    in unused slots; src (B*n_cam, cap) each slot's proposal, n_p where
    unused)."""
    b, n_cam, n_p, _ = cam_rois.shape
    bc = b * n_cam
    vis = visible_mask(cam_rois, img_shape, strides).reshape(bc, n_p)
    slot = torch.cumsum(vis.long(), 1) - 1
    slot = torch.where(vis & (slot < cap), slot, cap)
    rois = cam_rois.new_full((bc, cap + 1, 4), -1e6).scatter_(
        1, slot[..., None].expand(-1, -1, 4), cam_rois.reshape(bc, n_p, 4))
    prop = torch.arange(n_p, device=slot.device).expand(bc, n_p)
    src = torch.full((bc, cap + 1), n_p, device=slot.device).scatter_(
        1, slot, prop)
    return rois[:, :cap], src[:, :cap]


def pooled_img_roi(img_feats: Sequence[torch.Tensor], cam_rois: torch.Tensor,
                   strides: Sequence[int], res: int, cap: int = 0,
                   patch: int = 0, patch_fallback: int = -1,
                   xpatch: int = 0, xpatch_fallback: int = -1
                   ) -> torch.Tensor:
    """Camera-summed multi-level RoIAlign.  img_feats: L maps (B*n_cam,
    H_l, W_l, C); cam_rois (B, n_cam, n_p, 4) -> (B, n_p, res, res, C).

    cap 0: every (camera, proposal) pair.  cap > 0: the pairs of
    compact_pairs, whose unused slots pool to zeros, added back to their
    proposals.  patch / xpatch and their fallbacks: multilevel_roi_align's
    capacity rules, whose slots count per (sample, camera)."""
    b, n_cam, n_p, _ = cam_rois.shape
    bc = b * n_cam
    c = img_feats[0].shape[-1]
    rules = dict(out_size=res, patch=patch, patch_fallback=patch_fallback,
                 xpatch=xpatch, xpatch_fallback=xpatch_fallback)
    if not cap:
        pooled = multilevel_roi_align(img_feats, cam_rois.reshape(bc, n_p, 4),
                                      strides, **rules)
        return pooled.reshape(b, n_cam, n_p, res, res, c).sum(1)
    img_shape = (img_feats[0].shape[1] * strides[0],
                 img_feats[0].shape[2] * strides[0])
    rois, src = compact_pairs(cam_rois, img_shape, strides, cap)
    pooled = multilevel_roi_align(img_feats, rois, strides, **rules)
    b_idx = torch.arange(b, device=src.device).repeat_interleave(n_cam)
    flat_prop = torch.where(src < n_p, b_idx[:, None] * n_p + src, b * n_p)
    out = pooled.new_zeros(b * n_p + 1, res * res * c).index_add_(
        0, flat_prop.reshape(-1), pooled.reshape(bc * cap, -1))
    return out[:b * n_p].reshape(b, n_p, res, res, c)


def torch_nearest_resize(x: torch.Tensor, hw) -> torch.Tensor:
    """torch's legacy 'nearest' on NCHW as the JAX package builds it: the
    source index floor(i * in / out), computed in float64 with numpy (the
    rounding of F.interpolate's own index differs at some sizes, e.g. 70
    -> 30)."""
    h, w = x.shape[-2:]
    iy = (np.arange(hw[0]) * (h / hw[0])).astype(np.int32)
    ix = (np.arange(hw[1]) * (w / hw[1])).astype(np.int32)
    return x[:, :, torch.as_tensor(iy, device=x.device)][
        ..., torch.as_tensor(ix, device=x.device)]


class MultiHeadAttention(nn.Module):
    """Self-attention as flax's MultiHeadDotProductAttention computes it:
    q, k, v projections with bias, q scaled by 1/sqrt(head_dim), softmax
    over keys, dropout on the weights in train mode, output projection."""

    def __init__(self, c: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = Linear(c, c)
        self.k_proj = Linear(c, c)
        self.v_proj = Linear(c, c)
        self.out_proj = Linear(c, c)

    def forward(self, x: torch.Tensor, rate: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, n, c = x.shape
        h = self.num_heads
        dh = c // h
        # flax divides by sqrt(depth) cast to the compute dtype
        scale = math.sqrt(dh) if x.dtype == torch.float32 else \
            torch.tensor(math.sqrt(dh), dtype=x.dtype).item()
        q = self.q_proj(x).view(b, n, h, dh).transpose(1, 2) / scale
        k = self.k_proj(x).view(b, n, h, dh).transpose(1, 2)
        v = self.v_proj(x).view(b, n, h, dh).transpose(1, 2)
        att = softmax(q @ k.transpose(-1, -2), -1)
        att = dropout(att, rate, generator, (1, 1, n, n))
        out = (att @ v).transpose(1, 2).reshape(b, n, c)
        return self.out_proj(out)


class DynamicConv(nn.Module):
    """Proposal-conditioned dynamic 1x1 convs over each proposal's RoI
    (reference srfdet_head.py:2633-2693)."""

    def __init__(self, c: int, dynamic_dim: int, pooled_cells: int):
        super().__init__()
        self.c, self.d = c, dynamic_dim
        self.dynamic_layer = Linear(c, 2 * c * dynamic_dim)
        self.norm1 = LayerNorm(dynamic_dim, eps=1e-5)
        self.norm2 = LayerNorm(c, eps=1e-5)
        self.out_layer = Linear(pooled_cells * c, c)
        self.norm3 = LayerNorm(c, eps=1e-5)

    def forward(self, prop_feats: torch.Tensor, roi_feats: torch.Tensor
                ) -> torch.Tensor:
        """prop_feats (N, C), roi_feats (N, S, C) -> (N, C).  A float32
        roi_feats promotes the first product (jnp.einsum's promotion)."""
        n, s, c = roi_feats.shape
        params = self.dynamic_layer(prop_feats)
        p1 = params[:, :c * self.d].view(n, c, self.d)
        p2 = params[:, c * self.d:].view(n, self.d, c)
        dt = torch.promote_types(roi_feats.dtype, p1.dtype)
        f = F.relu(self.norm1(torch.bmm(roi_feats.to(dt), p1.to(dt))))
        f = F.relu(self.norm2(torch.bmm(f, p2)))
        return F.relu(self.norm3(self.out_layer(f.reshape(n, s * c))))


class SingleSRFDetHead(nn.Module):
    """One refinement iteration (reference SingleSRFDetHeadLiDAR,
    srfdet_head.py:1348, and the fusion SingleSRFDetHead, :2104).
    `img_channels` > 0 builds the fusion path: the image RoIs (of that
    width) and the LiDAR RoIs, image first, projected to the head's
    width by `output_fused_proj`."""

    def __init__(self, num_classes: int, feat_channels: int = 128,
                 pooler_resolution: int = 7, dim_feedforward: int = 512,
                 num_cls_convs: int = 2, num_reg_convs: int = 3,
                 num_attn_heads: int = 8, code_size: int = 10,
                 dynamic_dim: int = 32,
                 pc_range: Sequence[float] = (-55.2, -55.2, -5.0, 55.2,
                                              55.2, 3.0),
                 voxel_size: Sequence[float] = (0.075, 0.075, 0.2),
                 lidar_strides: Sequence[int] = (8, 16, 32, 64),
                 roi_patch: int = 0, roi_patch_fallback: int = -1,
                 scale_clamp: float = _DEFAULT_SCALE_CLAMP,
                 dropout: float = 0.0, img_channels: int = 0,
                 img_strides: Sequence[int] = (4, 8, 16, 32),
                 img_roi_cap: int = 0, img_roi_patch: int = 0,
                 img_roi_patch_fallback: int = -1, img_roi_xpatch: int = 0,
                 img_roi_xpatch_fallback: int = -1):
        super().__init__()
        c = feat_channels
        self.img_rules = dict(
            cap=img_roi_cap, patch=img_roi_patch,
            patch_fallback=img_roi_patch_fallback, xpatch=img_roi_xpatch,
            xpatch_fallback=img_roi_xpatch_fallback)
        self.res = pooler_resolution
        self.dropout = dropout
        self.pc_range, self.voxel_size = tuple(pc_range), tuple(voxel_size)
        self.lidar_strides = tuple(lidar_strides)
        self.roi_patch, self.roi_patch_fallback = roi_patch, roi_patch_fallback
        self.scale_clamp = scale_clamp
        self.img_strides = tuple(img_strides)
        if img_channels:
            self.output_fused_proj = Linear(img_channels + c, c)
        self.self_attn = MultiHeadAttention(c, num_attn_heads)
        self.norm_attn = LayerNorm(c, eps=1e-5)
        self.inst_interact = DynamicConv(c, dynamic_dim,
                                         pooler_resolution ** 2)
        self.norm_inst = LayerNorm(c, eps=1e-5)
        self.ffn1 = Linear(c, dim_feedforward)
        self.ffn2 = Linear(dim_feedforward, c)
        self.norm_ffn = LayerNorm(c, eps=1e-5)
        self.cls_fcs = nn.ModuleList(Linear(c, c, bias=False)
                                     for _ in range(num_cls_convs))
        self.cls_norms = nn.ModuleList(LayerNorm(c, eps=1e-5)
                                       for _ in range(num_cls_convs))
        self.reg_fcs = nn.ModuleList(Linear(c, c, bias=False)
                                     for _ in range(num_reg_convs))
        self.reg_norms = nn.ModuleList(LayerNorm(c, eps=1e-5)
                                       for _ in range(num_reg_convs))
        self.class_logits = Linear(c, num_classes)
        self.bboxes_delta = Linear(c, code_size)

    def forward(self, point_feats: Sequence[torch.Tensor],
                bboxes: torch.Tensor, prop_feats: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                img_feats: Optional[Sequence[torch.Tensor]] = None,
                lidar2img: Optional[torch.Tensor] = None):
        """point_feats: (B, H, W, C) maps; bboxes (B, n_p, code) with
        normalized centers; prop_feats (B, n_p, C); generator: dropout's
        masks in train mode; img_feats: (B*n_cam, H, W, C_img) maps with
        lidar2img (B, n_cam, 4, 4), or None (the LiDAR path alone).
        Returns (logits, refined boxes with normalized centers, object
        features)."""
        rate = self.dropout if self.training else 0.0

        def drop(x):
            return dropout(x, rate, generator)

        bs, n_p = bboxes.shape[:2]
        c = prop_feats.shape[-1]
        boxes_abs = denormalize_centers(bboxes, self.pc_range)
        rois = lidar_rois_from_boxes(boxes_abs, self.pc_range,
                                     self.voxel_size)
        roi = multilevel_roi_align(point_feats, rois, self.lidar_strides,
                                   out_size=self.res, patch=self.roi_patch,
                                   patch_fallback=self.roi_patch_fallback)
        if img_feats is not None:
            img_roi = pooled_img_roi(
                img_feats, img_rois_from_boxes(boxes_abs, lidar2img),
                self.img_strides, self.res, **self.img_rules)
            roi = self.output_fused_proj(torch.cat([img_roi, roi], -1))
        roi = roi.reshape(bs * n_p, self.res * self.res, c)

        x = self.norm_attn(prop_feats + drop(
            self.self_attn(prop_feats, rate, generator)))
        flat = x.reshape(bs * n_p, c)
        obj = self.norm_inst(flat + drop(self.inst_interact(flat, roi)))
        obj = self.norm_ffn(obj + drop(self.ffn2(drop(F.relu(
            self.ffn1(obj))))))
        cls_f = reg_f = obj
        for fc, norm in zip(self.cls_fcs, self.cls_norms):
            cls_f = F.relu(norm(fc(cls_f)))
        for fc, norm in zip(self.reg_fcs, self.reg_norms):
            reg_f = F.relu(norm(fc(reg_f)))
        logits = self.class_logits(cls_f).reshape(bs, n_p, -1)
        deltas = self.bboxes_delta(reg_f).reshape(bs, n_p, -1)
        return logits, self.apply_deltas(deltas, boxes_abs), \
            obj.reshape(bs, n_p, c)

    def apply_deltas(self, d: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Center deltas scale with the box extents, log sizes add (clamped),
        sin/cos (and velocities) are replaced; centers come back
        normalized and clipped to [0, 1].  float32 in every mode: bfloat16
        would quantize the normalized centres by ~4e-3 (JAX
        `head.py:395-411`)."""
        d, b = d.float(), b.float()
        ctr = b[..., 0:3] + d[..., 0:3] * torch.exp(b[..., 3:6])
        new_sizes = b[..., 3:6] + d[..., 3:6].clamp_max(self.scale_clamp)
        lo = b.new_tensor(self.pc_range[:3])
        hi = b.new_tensor(self.pc_range[3:6])
        ctr = ((ctr - lo) / (hi - lo)).clamp(0.0, 1.0)
        return torch.cat([ctr, new_sizes, d[..., 6:]], -1)


class SRFDetHead(nn.Module):
    """DPG init proposals + `num_heads` refinement iterations (reference
    SRFDetHead, srfdet_head.py:48-1345).  `img_channels` > 0 (the image
    neck's width) adds the fusion path: `img_conv` 3x3 convs with bias to
    `hidden_dim` (only where the widths differ), the image DPG staircase
    resized to `img_dpg_hw` ((30, 30); (30, 15) on KITTI), and the fused
    RoIs in every iteration.  `with_dpg=False`: num_proposals learned
    proposals, no DPG; `with_lidar_encoder`: the deformable BEV encoder
    (`lidar_encoder`) over the LiDAR levels first; `remat`: each
    iteration recomputed in the backward pass."""

    dtype = torch.float32

    def __init__(self, num_classes: int, feat_channels: int, num_levels: int,
                 dpg_cells: int, num_proposals: int = 900,
                 num_heads: int = 5, num_dpg_exp: int = 4,
                 code_size: int = 10, deep_supervision: bool = True,
                 pc_range: Sequence[float] = (-55.2, -55.2, -5.0, 55.2,
                                              55.2, 3.0),
                 img_channels: int = 0, hidden_dim: int = 128,
                 img_levels: int = 4, img_dpg_hw=(30, 30),
                 with_dpg: bool = True, with_lidar_encoder: bool = False,
                 remat: bool = False, **single_kwargs):
        super().__init__()
        c = feat_channels
        self.num_proposals, self.num_dpg_exp = num_proposals, num_dpg_exp
        self.code_size, self.pc_range = code_size, tuple(pc_range)
        self.deep_supervision = deep_supervision
        self.with_dpg, self.remat = with_dpg, remat
        self.lidar_encoder = (LidarBEVEncoder(c, num_levels)
                              if with_lidar_encoder else None)
        n_emb = num_dpg_exp * num_proposals if with_dpg else num_proposals
        self.init_proposal_boxes = nn.Parameter(torch.zeros(n_emb, code_size))
        self.init_proposal_feats = nn.Parameter(torch.zeros(n_emb, c))
        if with_dpg:
            # depthwise stride-2 staircase: level l's input has (l+1)*C
            # channels
            self.dpg_dw = nn.ModuleList(
                ConvBNReLU((l + 1) * c, (l + 1) * c, 3, 2, 1,
                           groups=(l + 1) * c)
                for l in range(num_levels - 1))
            self.dpg_fc1 = Linear(dpg_cells, 1024)
            self.dpg_fc2 = Linear(1024, n_emb)
        self.use_img = bool(img_channels)
        self.img_conv = None
        if self.use_img:
            if hidden_dim != img_channels:
                self.img_conv = nn.ModuleList(
                    Conv2d(img_channels, hidden_dim, 3, 1, 1)
                    for _ in range(img_levels))
        if self.use_img and with_dpg:
            h = hidden_dim
            self.dpg_dw_img = nn.ModuleList(
                ConvBNReLU((l + 1) * h, (l + 1) * h, 3, 2, 1,
                           groups=(l + 1) * h)
                for l in range(img_levels - 1))
            self.img_dpg_hw = tuple(img_dpg_hw)
            self.dpg_fc1_img = Linear(img_dpg_hw[0] * img_dpg_hw[1], 1500)
            self.dpg_fc2_img = Linear(1500, n_emb)
        self.heads = nn.ModuleList(
            SingleSRFDetHead(num_classes, c, code_size=code_size,
                             pc_range=pc_range,
                             img_channels=hidden_dim if self.use_img else 0,
                             **single_kwargs)
            for _ in range(num_heads))

    def image_maps(self, img_feats: Sequence[torch.Tensor]
                   ) -> Sequence[torch.Tensor]:
        """The image neck's NCHW levels reduced to hidden_dim channels
        (img_conv), where the widths differ."""
        if self.img_conv is None:
            return list(img_feats)
        return [conv(f) for conv, f in zip(self.img_conv, img_feats)]

    def init_proposals(self, point_feats: Sequence[torch.Tensor],
                       img_maps: Optional[Sequence[torch.Tensor]] = None):
        """The DPG: the proposals (B, n_p, code), centers normalized, and
        their features (B, n_p, C), as softmax-weighted mixtures of the
        num_dpg_exp learned sets.  With img_maps (image_maps' output,
        B*n_cam maps a level) the mixture logits are the mean of the
        LiDAR staircase's and the image staircase's, whose last level is
        resized to img_dpg_hw and summed over cameras and channels.
        Without the DPG, the learned set itself for every sample."""
        bs = point_feats[0].shape[0]
        n_p, n_exp = self.num_proposals, self.num_dpg_exp
        if not self.with_dpg:
            boxes0 = self.init_proposal_boxes.expand(bs, n_p, self.code_size)
            prop = self.init_proposal_feats.expand(bs, n_p, -1)
            return torch.cat([torch.sigmoid(boxes0[..., :3]),
                              boxes0[..., 3:]], -1), prop.to(self.dtype)
        x = point_feats[0]
        for lvl, dw in enumerate(self.dpg_dw):
            x = torch.cat([point_feats[lvl + 1], dw(x)], 1)
        w = self.dpg_fc2(F.relu(self.dpg_fc1(x.sum(1).reshape(bs, -1))))
        w = w.view(bs, n_exp, n_p)
        if img_maps is not None:
            x = img_maps[0]
            for lvl, dw in enumerate(self.dpg_dw_img):
                x = torch.cat([img_maps[lvl + 1], dw(x)], 1)
            x = torch_nearest_resize(x, self.img_dpg_hw)
            x = x.reshape((bs, -1) + x.shape[1:]).sum(1)
            wimg = self.dpg_fc2_img(F.relu(self.dpg_fc1_img(
                x.sum(1).reshape(bs, -1))))
            w = (w + wimg.view(bs, n_exp, n_p)) / 2.0
        # the mixture promotes to the float32 proposal parameters
        w = softmax(w, 1).float()
        boxes0 = torch.einsum("ben,end->bnd", w, self.init_proposal_boxes
                              .view(n_exp, n_p, self.code_size))
        prop = torch.einsum("ben,enc->bnc", w, self.init_proposal_feats
                            .view(n_exp, n_p, -1))
        boxes = torch.cat([torch.sigmoid(boxes0[..., :3]), boxes0[..., 3:]],
                          -1)
        return boxes, prop.to(self.dtype)

    def forward(self, point_feats: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None,
                img_feats: Optional[Sequence[torch.Tensor]] = None,
                lidar2img: Optional[torch.Tensor] = None):
        """point_feats: L NCHW maps, strides lidar_strides; generator:
        dropout's masks in train mode; img_feats (with the image branch):
        the image neck's NCHW levels (B*n_cam, C_img, H, W), strides
        img_strides, with lidar2img (B, n_cam, 4, 4).  Returns pred_logits
        (L, B, n_p, #cls) and pred_boxes (L, B, n_p, code) with absolute
        centers; every iteration's outputs keep their graph, and only the
        boxes carried into the next iteration are detached (JAX:
        stop_gradient on the scan carry)."""
        nhwc = [f.permute(0, 2, 3, 1).contiguous() for f in point_feats]
        if self.lidar_encoder is not None:
            # JAX head.py:519-525: the encoded levels feed the DPG too
            nhwc = self.lidar_encoder(nhwc, generator)
            point_feats = [f.permute(0, 3, 1, 2) for f in nhwc]
        img_maps = img_nhwc = None
        if self.use_img and img_feats is not None:
            img_maps = self.image_maps(img_feats)
            img_nhwc = [f.permute(0, 2, 3, 1).contiguous() for f in img_maps]
        boxes, prop = self.init_proposals(point_feats, img_maps)
        logits_all, boxes_all = [], []
        for head in self.heads:
            args = (nhwc, boxes, prop, generator, img_nhwc, lidar2img)
            if self.remat and torch.is_grad_enabled():
                logits, pred, prop = _checkpointed(head, generator, args)
            else:
                logits, pred, prop = head(*args)
            boxes = pred.detach()
            logits_all.append(logits)
            boxes_all.append(pred)
        if not self.deep_supervision:
            logits_all, boxes_all = logits_all[-1:], boxes_all[-1:]
        return (torch.stack(logits_all),
                denormalize_centers(torch.stack(boxes_all), self.pc_range))


def _checkpointed(head: nn.Module, generator: Optional[torch.Generator],
                  args):
    """head(*args) under torch.utils.checkpoint: only its inputs are kept,
    and its forward runs again in the backward pass.  The recomputation
    draws its dropout masks from `generator` at the state the first run
    drew them from, and leaves the generator where it found it, so the
    masks, and the grads, equal the first run's (checkpoint's own RNG
    stashing covers only the default generators, which the head never
    draws from)."""
    if generator is None:
        return torch.utils.checkpoint.checkpoint(
            head, *args, use_reentrant=False, preserve_rng_state=False)
    state = generator.get_state()
    calls = []

    def run(*a):
        if not calls:                     # the forward pass
            calls.append(1)
            return head(*a)
        now = generator.get_state()       # the backward's recomputation
        generator.set_state(state)
        try:
            return head(*a)
        finally:
            generator.set_state(now)
    return torch.utils.checkpoint.checkpoint(
        run, *args, use_reentrant=False, preserve_rng_state=False)


def decode_boxes(pred_logits: torch.Tensor, pred_boxes: torch.Tensor,
                 use_nms: bool = True, nms_thr: float = 0.4,
                 score_thr: float = 0.1, max_per_img: int = 300,
                 post_center_range: Sequence[float] = (
                     -61.2, -61.2, -10.0, 61.2, 61.2, 10.0)
                 ) -> Dict[str, torch.Tensor]:
    """Last-layer predictions -> static-shape detections (reference
    SRFDetHead.get_bboxes, srfdet_head.py:1228-1334): sigmoid scores,
    decoded boxes with bottom-center z, rotated multiclass NMS (or plain
    top-k), post-center-range filter.

    pred_logits (B, n_p, #cls), pred_boxes (B, n_p, code) absolute centers.
    Returns boxes (B, max_per_img, 7|9), scores, labels, valid."""
    scores = torch.sigmoid(pred_logits.float())
    raw = denormalize_bbox(pred_boxes.float())
    raw = torch.cat([raw[..., :2], raw[..., 2:3] - 0.5 * raw[..., 5:6],
                     raw[..., 3:]], -1)
    if use_nms:
        bev = torch.cat([raw[..., 0:2], raw[..., 3:5], raw[..., 6:7]], -1)
        out_b, out_s, out_l, out_v = multiclass_nms_3d(
            raw, bev, scores, score_thr, max_per_img, nms_thr)
    else:
        b, n_p, c = scores.shape
        k_eff = min(max_per_img, n_p * c)
        fs, fi = torch.sort(scores.reshape(b, n_p * c), dim=-1,
                            descending=True, stable=True)
        out_s, idx = fs[:, :k_eff], fi[:, :k_eff]
        pad = max_per_img - k_eff
        out_s = F.pad(out_s, (0, pad))
        idx = F.pad(idx, (0, pad))
        out_l = idx % c
        out_b = torch.gather(raw, 1, (idx // c)[..., None].expand(
            -1, -1, raw.shape[-1]))
        out_v = F.pad(torch.ones(b, k_eff, dtype=torch.bool,
                                 device=raw.device), (0, pad))
    pcr = out_b.new_tensor(post_center_range)
    in_range = ((out_b[..., :3] >= pcr[:3]).all(-1) &
                (out_b[..., :3] <= pcr[3:]).all(-1))
    return {"boxes": out_b, "scores": out_s, "labels": out_l,
            "valid": out_v & in_range}
