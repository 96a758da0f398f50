"""SRFDet decoder head, LiDAR only: DPG init proposals, iterative
refinement, and box decoding with rotated multiclass NMS.

Box code: [cx, cy, cz, log w, log l, log h, sin, cos (, vx, vy)], centers
normalized to [0, 1] within pc_range between iterations and absolute in the
returned predictions.  The JAX package scans the iterations over stacked
weights; here they are `num_heads` modules in a list.

Train mode (`.train()`) applies dropout where flax's head does: on the
attention weights (one (n_q, n_k) mask shared by batch and heads, flax's
broadcast_dropout), after self-attention, after the dynamic conv, inside
the FFN and after it.  Its masks come from a `torch.Generator` the caller
passes; there is no global seed.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..geometry.boxes import boxes3d_to_corners3d, denormalize_bbox
from ..geometry.iou import multiclass_nms_3d
from ..ops.roi_align import multilevel_roi_align
from .layers import ConvBNReLU

_DEFAULT_SCALE_CLAMP = math.log(100000.0 / 16)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator],
            shape: Optional[Sequence[int]] = None) -> torch.Tensor:
    """flax's nn.Dropout: keep with probability 1 - rate, scale kept values
    by 1 / (1 - rate).  `shape` draws a mask that broadcasts over x."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode needs a torch.Generator")
    keep_prob = 1.0 - rate
    u = torch.rand(tuple(shape or x.shape), generator=generator,
                   device=x.device)
    return torch.where(u < keep_prob, x / keep_prob, 0.0)


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


class MultiHeadAttention(nn.Module):
    """Self-attention as flax's MultiHeadDotProductAttention computes it:
    q, k, v projections with bias, q scaled by 1/sqrt(head_dim), softmax
    over keys, dropout on the weights in train mode, output projection."""

    def __init__(self, c: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(c, c)
        self.k_proj = nn.Linear(c, c)
        self.v_proj = nn.Linear(c, c)
        self.out_proj = nn.Linear(c, c)

    def forward(self, x: torch.Tensor, rate: float = 0.0,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        b, n, c = x.shape
        h = self.num_heads
        dh = c // h
        q = self.q_proj(x).view(b, n, h, dh).transpose(1, 2) / math.sqrt(dh)
        k = self.k_proj(x).view(b, n, h, dh).transpose(1, 2)
        v = self.v_proj(x).view(b, n, h, dh).transpose(1, 2)
        att = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
        att = dropout(att, rate, generator, (1, 1, n, n))
        out = (att @ v).transpose(1, 2).reshape(b, n, c)
        return self.out_proj(out)


class DynamicConv(nn.Module):
    """Proposal-conditioned dynamic 1x1 convs over each proposal's RoI
    (reference srfdet_head.py:2633-2693)."""

    def __init__(self, c: int, dynamic_dim: int, pooled_cells: int):
        super().__init__()
        self.c, self.d = c, dynamic_dim
        self.dynamic_layer = nn.Linear(c, 2 * c * dynamic_dim)
        self.norm1 = nn.LayerNorm(dynamic_dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(c, eps=1e-5)
        self.out_layer = nn.Linear(pooled_cells * c, c)
        self.norm3 = nn.LayerNorm(c, eps=1e-5)

    def forward(self, prop_feats: torch.Tensor, roi_feats: torch.Tensor
                ) -> torch.Tensor:
        """prop_feats (N, C), roi_feats (N, S, C) -> (N, C)."""
        n, s, c = roi_feats.shape
        params = self.dynamic_layer(prop_feats)
        p1 = params[:, :c * self.d].view(n, c, self.d)
        p2 = params[:, c * self.d:].view(n, self.d, c)
        f = F.relu(self.norm1(torch.bmm(roi_feats, p1)))
        f = F.relu(self.norm2(torch.bmm(f, p2)))
        return F.relu(self.norm3(self.out_layer(f.reshape(n, s * c))))


class SingleSRFDetHead(nn.Module):
    """One refinement iteration of the LiDAR head (reference
    SingleSRFDetHeadLiDAR, srfdet_head.py:1348)."""

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
                 dropout: float = 0.0):
        super().__init__()
        c = feat_channels
        self.res = pooler_resolution
        self.dropout = dropout
        self.pc_range, self.voxel_size = tuple(pc_range), tuple(voxel_size)
        self.lidar_strides = tuple(lidar_strides)
        self.roi_patch, self.roi_patch_fallback = roi_patch, roi_patch_fallback
        self.scale_clamp = scale_clamp
        self.self_attn = MultiHeadAttention(c, num_attn_heads)
        self.norm_attn = nn.LayerNorm(c, eps=1e-5)
        self.inst_interact = DynamicConv(c, dynamic_dim,
                                         pooler_resolution ** 2)
        self.norm_inst = nn.LayerNorm(c, eps=1e-5)
        self.ffn1 = nn.Linear(c, dim_feedforward)
        self.ffn2 = nn.Linear(dim_feedforward, c)
        self.norm_ffn = nn.LayerNorm(c, eps=1e-5)
        self.cls_fcs = nn.ModuleList(nn.Linear(c, c, bias=False)
                                     for _ in range(num_cls_convs))
        self.cls_norms = nn.ModuleList(nn.LayerNorm(c, eps=1e-5)
                                       for _ in range(num_cls_convs))
        self.reg_fcs = nn.ModuleList(nn.Linear(c, c, bias=False)
                                     for _ in range(num_reg_convs))
        self.reg_norms = nn.ModuleList(nn.LayerNorm(c, eps=1e-5)
                                       for _ in range(num_reg_convs))
        self.class_logits = nn.Linear(c, num_classes)
        self.bboxes_delta = nn.Linear(c, code_size)

    def forward(self, point_feats: Sequence[torch.Tensor],
                bboxes: torch.Tensor, prop_feats: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """point_feats: (B, H, W, C) maps; bboxes (B, n_p, code) with
        normalized centers; prop_feats (B, n_p, C); generator: dropout's
        masks in train mode.  Returns (logits, refined boxes with
        normalized centers, object features)."""
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
        normalized and clipped to [0, 1]."""
        ctr = b[..., 0:3] + d[..., 0:3] * torch.exp(b[..., 3:6])
        new_sizes = b[..., 3:6] + d[..., 3:6].clamp_max(self.scale_clamp)
        lo = b.new_tensor(self.pc_range[:3])
        hi = b.new_tensor(self.pc_range[3:6])
        ctr = ((ctr - lo) / (hi - lo)).clamp(0.0, 1.0)
        return torch.cat([ctr, new_sizes, d[..., 6:]], -1)


class SRFDetHead(nn.Module):
    """DPG init proposals + `num_heads` refinement iterations (reference
    SRFDetHead, srfdet_head.py:48-1345), LiDAR only."""

    def __init__(self, num_classes: int, feat_channels: int, num_levels: int,
                 dpg_cells: int, num_proposals: int = 900,
                 num_heads: int = 5, num_dpg_exp: int = 4,
                 code_size: int = 10, deep_supervision: bool = True,
                 pc_range: Sequence[float] = (-55.2, -55.2, -5.0, 55.2,
                                              55.2, 3.0), **single_kwargs):
        super().__init__()
        c = feat_channels
        self.num_proposals, self.num_dpg_exp = num_proposals, num_dpg_exp
        self.code_size, self.pc_range = code_size, tuple(pc_range)
        self.deep_supervision = deep_supervision
        n_emb = num_dpg_exp * num_proposals
        self.init_proposal_boxes = nn.Parameter(torch.zeros(n_emb, code_size))
        self.init_proposal_feats = nn.Parameter(torch.zeros(n_emb, c))
        # depthwise stride-2 staircase: level l's input has (l+1)*C channels
        self.dpg_dw = nn.ModuleList(
            ConvBNReLU((l + 1) * c, (l + 1) * c, 3, 2, 1, groups=(l + 1) * c)
            for l in range(num_levels - 1))
        self.dpg_fc1 = nn.Linear(dpg_cells, 1024)
        self.dpg_fc2 = nn.Linear(1024, n_emb)
        self.heads = nn.ModuleList(
            SingleSRFDetHead(num_classes, c, code_size=code_size,
                             pc_range=pc_range, **single_kwargs)
            for _ in range(num_heads))

    def forward(self, point_feats: Sequence[torch.Tensor],
                generator: Optional[torch.Generator] = None):
        """point_feats: L NCHW maps, strides lidar_strides; generator:
        dropout's masks in train mode.  Returns pred_logits (L, B, n_p,
        #cls) and pred_boxes (L, B, n_p, code) with absolute centers; every
        iteration's outputs keep their graph, and only the boxes carried
        into the next iteration are detached (JAX: stop_gradient on the
        scan carry)."""
        bs = point_feats[0].shape[0]
        n_p, n_exp = self.num_proposals, self.num_dpg_exp
        x = point_feats[0]
        for lvl, dw in enumerate(self.dpg_dw):
            x = torch.cat([point_feats[lvl + 1], dw(x)], 1)
        w = F.relu(self.dpg_fc1(x.sum(1).reshape(bs, -1)))
        w = torch.softmax(self.dpg_fc2(w).view(bs, n_exp, n_p), dim=1)
        boxes0 = torch.einsum("ben,end->bnd", w, self.init_proposal_boxes
                              .view(n_exp, n_p, self.code_size))
        prop = torch.einsum("ben,enc->bnc", w, self.init_proposal_feats
                            .view(n_exp, n_p, -1))
        boxes = torch.cat([torch.sigmoid(boxes0[..., :3]), boxes0[..., 3:]],
                          -1)
        nhwc = [f.permute(0, 2, 3, 1).contiguous() for f in point_feats]
        logits_all, boxes_all = [], []
        for head in self.heads:
            logits, pred, prop = head(nhwc, boxes, prop, generator)
            boxes = pred.detach()
            logits_all.append(logits)
            boxes_all.append(pred)
        if not self.deep_supervision:
            logits_all, boxes_all = logits_all[-1:], boxes_all[-1:]
        return (torch.stack(logits_all),
                denormalize_centers(torch.stack(boxes_all), self.pc_range))


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
