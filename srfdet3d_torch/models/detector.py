"""SRFDet detector (reference models/detectors/srfdet.py).

LiDAR branch: voxelization -> VFE (HardSimpleVFE, DynamicVFE or
PillarFeatureNet) -> middle encoder (the sparse encoder, or the pillar
scatter) -> SECOND -> FPN.  Image branch (LC configs, `cfg.use_img`): the
camera images -> VoVNet or ResNet -> image FPN.  Both feed the SRFDet head.
Input contract, as in the JAX package:

    batch = {"points": (B, P_cap, D) padded float32 point clouds,
             "points_mask": (B, P_cap) bool,
             "images": (B, n_cam, H, W, 3) normalized float32 images,
                                                            [LC only]
             "lidar2img": (B, n_cam, 4, 4) float32 projections   [LC only]}

An LC model given no "images" runs its LiDAR branch alone, as the JAX
package's does.  In train mode the image branch applies GridMask
(`cfg.img.use_grid_mask`) to the flattened (B*n_cam) images before the
backbone, keeps the whole backbone's BN on its running statistics under
`cfg.img.norm_eval`, and under `cfg.optim.freeze_img` cuts the gradient
between the backbone and the neck (JAX `detector.py:148-186`); which
parameters train is `train.trainer.freeze_mask`'s.

The model lives on `cuda` unless built with device="cpu"; weights are a
seeded random init (`seed`) or come from the JAX package through
`utils.jax_params.load_jax_params`.  It is built in eval mode; `.train()`
puts it in train mode (batch-statistics BN, GridMask and the head's
dropout, whose draws come from the generator passed to `forward`: GridMask's
first, then the head's), except that with `cfg.optim.freeze_lidar` the
`pts_*` modules stay in eval mode and keep their BN statistics, and their
features are detached (JAX `detector.py:191-203`), and that with
`cfg.img.norm_eval` the image backbone stays in eval mode.

Compute dtypes (JAX `detector.py:68-71`, `:152-186`): `cfg.compute_dtype`
"bfloat16" runs every module in bfloat16 (`model.dtype`), and
`cfg.img.compute_dtype` the image backbone and neck (`model.img_dtype`; ""
inherits the model's dtype); any other string means float32.  The images
are cast to the branch dtype before GridMask and the image features back
to the model dtype before the head.  Parameters and BN statistics stay
float32 (`layers.set_dtype`); boxes, losses, assignment and decode are
float32 in every mode.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .. import resolve_device, set_backend_flags
from ..config import SRFDetConfig
from ..ops.voxelize import VoxelizedPoints, voxelize_points_batched
from ..parallel import mesh as pmesh
from ..utils import profiling
from .deform_conv import ModulatedDeformConv
from .fpn import FPN
from .grid_mask import grid_mask
from .head import GraphOutputs, SRFDetHead, decode_boxes, focal_bias
from .layers import MaskedBatchNorm, set_dtype
from .middle import PointPillarsScatter
from .resnet import ResNet
from .second import SECOND
from .sparse_encoder import GatheredConvBN, SparseEncoder, down_pads
from .tail_graph import TailGraphs
from .vfe import DynamicVFE, HardSimpleVFE, PillarFeatureNet
from .vovnet import VoVNet

# the LiDAR branch that cfg.optim.freeze_lidar freezes
LIDAR_MODULES = ("pts_voxel_encoder", "pts_middle_encoder", "pts_backbone",
                 "pts_neck")     # a pillar model has no pts_middle_encoder
# the modules predict's tail graph runs (models/tail_graph.py)
TAIL_MODULES = ("pts_middle_encoder", "pts_backbone", "pts_neck",
                "bbox_head")


def to_device(value, device: torch.device) -> torch.Tensor:
    """`value` (a tensor or an array) as a tensor on `device`.  On a card
    a copy from host memory waits for the stream (counter `host_sync`)."""
    t = torch.as_tensor(value)
    if t.device.type != device.type:
        profiling.count("host_sync")
    return t.to(device)


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
    """(depth of the middle encoder's output, the FPN levels' (H, W)): the
    BEV map's size (the pillar grid's (ny, nx), depth 1; or the sparse
    plan's after the encoder's downsamples and conv_out), then SECOND's
    strides and the FPN's stride-2 extra levels (a 3x3 conv with pad 1 and
    a kernel-1 max pool give the same size)."""
    m = cfg.middle
    if m.kind == "pillar_scatter":
        nx, ny, _ = cfg.grid_size
        d, h, w = 1, ny, nx
    else:
        d, h, w = cfg.voxelization.sparse_shape
        for pad in down_pads(m.block_type, m.encoder_channels,
                             m.encoder_paddings):
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


def compute_dtypes(cfg: SRFDetConfig) -> Tuple[torch.dtype, torch.dtype]:
    """(the model's dtype, the image branch's): "bfloat16" is bfloat16 and
    any other string float32, in both fields; an empty
    `img.compute_dtype` inherits the model's."""
    def of(name):
        return torch.bfloat16 if name == "bfloat16" else torch.float32
    model = of(cfg.compute_dtype)
    img = cfg.img.compute_dtype if cfg.img is not None else ""
    return model, (of(img) if img else model)


def _lidar_only(cfg: SRFDetConfig, batch: Dict[str, torch.Tensor]) -> bool:
    """Does a forward of this batch run the LiDAR branch alone (a
    LiDAR-only config, or an LC model given no images)?"""
    return not cfg.use_img or "images" not in batch


def _check_supported(cfg: SRFDetConfig) -> None:
    """The port runs every option of the JAX package's SRFDet; an unknown
    VFE or middle kind is an error in both."""
    if cfg.vfe.kind not in ("hard_simple", "dynamic", "pillar"):
        raise ValueError(f"vfe.kind={cfg.vfe.kind}")
    if cfg.middle.kind not in ("sparse", "pillar_scatter"):
        raise ValueError(f"middle.kind={cfg.middle.kind}")


class SRFDet(nn.Module):
    """forward(batch) -> (pred_logits (L, B, n_p, #cls), pred_boxes
    (L, B, n_p, code) with absolute centers); predict(batch) decodes."""

    def __init__(self, cfg: SRFDetConfig, device=None, seed: int = 0):
        super().__init__()
        _check_supported(cfg)
        self._tail_graphs = TailGraphs()
        dev = resolve_device(device)
        set_backend_flags()
        self.cfg = cfg
        spec = cfg.voxelization
        m = cfg.middle
        v = cfg.vfe
        if v.kind == "dynamic":
            self.pts_voxel_encoder = DynamicVFE(
                spec, v.in_channels, v.feat_channels,
                with_distance=v.with_distance,
                with_cluster_center=v.with_cluster_center,
                with_voxel_center=v.with_voxel_center,
                with_centroid_aware=v.with_centroid_aware)
        elif v.kind == "pillar":
            self.pts_voxel_encoder = PillarFeatureNet(
                spec, v.in_channels, v.feat_channels,
                with_distance=v.with_distance,
                with_cluster_center=v.with_cluster_center,
                with_voxel_center=v.with_voxel_center)
        else:
            self.pts_voxel_encoder = HardSimpleVFE(v.in_channels)
        d, sizes = bev_geometry(cfg)
        if m.kind == "pillar_scatter":
            # parameter-free, and not a JAX module: no pts_middle_encoder
            nx, ny, _ = cfg.grid_size
            self.pillar_scatter = PointPillarsScatter((ny, nx))
            bev_channels = v.feat_channels[-1]
        else:
            self.pts_middle_encoder = SparseEncoder(
                m.in_channels, spec.sparse_shape, m.base_channels,
                m.output_channels, m.encoder_channels, m.encoder_paddings,
                m.capacities, block_type=m.block_type, rulebook=m.rulebook)
            bev_channels = d * m.output_channels
        bb = cfg.backbone
        self.pts_backbone = SECOND(bev_channels, bb.out_channels,
                                   bb.layer_nums, bb.layer_strides)
        self.pts_neck = FPN(bb.out_channels, cfg.neck_out_channels,
                            cfg.neck_num_outs,
                            extra_convs=cfg.neck_extra_convs)
        hc = cfg.head
        if hc.feat_channels_lidar != cfg.neck_out_channels:
            raise ValueError("head.feat_channels_lidar must equal the neck's")
        img = {}
        if cfg.use_img:
            ic = cfg.img
            if ic.backbone.startswith("vovnet"):
                self.img_backbone = VoVNet(ic.backbone)
            else:
                self.img_backbone = ResNet(
                    int(ic.backbone.split("-")[1]), style=ic.resnet_style,
                    stage_with_dcn=tuple(ic.stage_with_dcn))
            self.img_neck = FPN(
                self.img_backbone.out_channels, ic.neck_out_channels,
                ic.neck_num_outs, use_norm=ic.neck_norm,
                relu_before_extra_convs=ic.relu_before_extra_convs)
            if hc.feat_channels_img != ic.neck_out_channels:
                raise ValueError("head.feat_channels_img must equal the "
                                 "image neck's")
            img = dict(
                img_channels=hc.feat_channels_img, hidden_dim=hc.hidden_dim,
                img_levels=hc.img_feat_lvls,
                img_dpg_hw=(30, 15) if cfg.dataset == "kitti" else (30, 30),
                img_strides=tuple(hc.img_strides),
                img_roi_cap=hc.img_roi_cap, img_roi_patch=hc.img_roi_patch,
                img_roi_patch_fallback=hc.img_roi_patch_fallback,
                img_roi_xpatch=hc.img_roi_xpatch,
                img_roi_xpatch_fallback=hc.img_roi_xpatch_fallback)
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
            roi_patch_fallback=hc.roi_patch_fallback, dropout=hc.dropout,
            with_dpg=hc.with_dpg, with_lidar_encoder=hc.with_lidar_encoder,
            remat=hc.remat, **img)
        self._init_weights(torch.Generator().manual_seed(seed))
        dtype, self.img_dtype = compute_dtypes(cfg)
        set_dtype(self, dtype)
        if cfg.use_img:
            set_dtype(self.img_backbone, self.img_dtype)
            set_dtype(self.img_neck, self.img_dtype)
        self.to(dev)
        self.eval()

    def train(self, mode: bool = True) -> "SRFDet":
        if mode:
            # a training model keeps no graph's memory
            self._tail_graphs.clear()
        super().train(mode)
        if mode and self.cfg.optim.freeze_lidar:
            for name in LIDAR_MODULES:
                if hasattr(self, name):
                    getattr(self, name).eval()
        if mode and self.cfg.use_img and self.cfg.img.norm_eval:
            self.img_backbone.eval()
        return self

    def _apply(self, fn, recurse: bool = True):
        # to(), cuda(), float() and the like move or replace the tensors a
        # captured graph reads
        self._tail_graphs.clear()
        return super()._apply(fn, recurse)

    @property
    def device(self) -> torch.device:
        return self.bbox_head.init_proposal_boxes.device

    @torch.no_grad()
    def _init_weights(self, g: torch.Generator) -> None:
        """Seeded init in the JAX package's families: xavier-uniform dense
        layers of the head, lecun-normal VFE dense layers and convs,
        kaiming-normal sparse kernels and DCNv2 kernels, zero DCNv2 offset
        convs, N(0, 1) proposal embeddings, unit norms, the focal prior on
        class biases."""
        for name, mod in self.named_modules():
            if (isinstance(mod, nn.Linear) and
                    name.startswith("pts_voxel_encoder.")):
                # DynamicVFE's and the PFN layers' Linears
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=g)
                                 / math.sqrt(mod.in_features))
            elif isinstance(mod, nn.Linear):
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
            elif isinstance(mod, ModulatedDeformConv):
                mod.kernel.copy_(torch.randn(mod.kernel.shape, generator=g)
                                 * math.sqrt(2.0 / mod.kernel.shape[0]))
            elif isinstance(mod, (nn.LayerNorm, nn.BatchNorm2d,
                                  MaskedBatchNorm)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        for mod in self.modules():
            if isinstance(mod, ModulatedDeformConv):
                mod.conv_offset.weight.zero_()
                mod.conv_offset.bias.zero_()
        head = self.bbox_head
        for p in (head.init_proposal_boxes, head.init_proposal_feats):
            p.copy_(torch.randn(p.shape, generator=g))
        if head.lidar_encoder is not None:
            head.lidar_encoder.init_weights(g)
        for single in head.heads:
            single.class_logits.bias.fill_(focal_bias(self.cfg.head.prior_prob))

    def _inputs(self, batch: Dict[str, torch.Tensor]):
        dev = self.device
        points = to_device(batch["points"], dev).float()
        mask = to_device(batch["points_mask"], dev).bool()
        return points, mask

    @profiling.span("voxelize")
    def voxel_features(self, points: torch.Tensor,
                       points_mask: torch.Tensor):
        """(B, P, D) points -> ((B, V_cap, F) voxel features, the
        voxelization) through the voxelizer and the VFE."""
        spec = self.cfg.voxelization
        v_cap = spec.max_voxels
        b, p, d = points.shape
        vox = voxelize_points_batched(points, points_mask, spec,
                                      with_counts=False)
        flat = _flatten_voxelization(vox, v_cap)
        feats = self.pts_voxel_encoder(points.reshape(b * p, d), flat,
                                       b * v_cap)
        return feats.reshape(b, v_cap, -1), vox

    @profiling.span("encoder")
    def middle(self, feats: torch.Tensor, vox: VoxelizedPoints,
               dense: bool = True):
        """(B, V_cap, F) voxel features -> the (B, H, W, C') BEV map: the
        sparse encoder's (C' = D*C, z-major groups) or the pillar
        scatter's (C' = F, cell y * nx + x).  With dense False (the sparse
        encoder), its fixed-capacity output before the scatter."""
        if self.cfg.middle.kind == "pillar_scatter":
            return self.pillar_scatter(feats, vox.voxel_coords,
                                       vox.voxel_mask)
        return self.pts_middle_encoder(feats, vox.voxel_coords,
                                       vox.voxel_mask, dense=dense)

    def bev_maps(self, bev: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """The (B, H, W, C') BEV map -> the FPN's NCHW maps."""
        with profiling.span("bev"):
            stages = self.pts_backbone(bev.permute(0, 3, 1, 2).contiguous())
            return self.pts_neck(stages)

    def extract_point_features(self, points: torch.Tensor,
                               points_mask: torch.Tensor
                               ) -> Tuple[torch.Tensor, ...]:
        """(B, P, D) points -> the FPN's NCHW BEV maps."""
        feats, vox = self.voxel_features(points, points_mask)
        return self.bev_maps(self.middle(feats, vox))

    def image_tensor(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The batch's (B, n_cam, H, W, 3) images as one NCHW
        (B*n_cam, 3, H, W) tensor on the model's device."""
        img = to_device(batch["images"], self.device).float()
        img = img.flatten(0, 1).permute(0, 3, 1, 2)
        return img.contiguous()

    @profiling.span("img")
    def extract_img_features(self, images: torch.Tensor,
                             generator: Optional[torch.Generator] = None
                             ) -> Tuple[torch.Tensor, ...]:
        """(B*n_cam, 3, H, W) images -> the image neck's NCHW levels
        (B*n_cam, C, H / s, W / s), strides 4-32 (reference
        extract_img_feat, srfdet.py:175-204).  In train mode: GridMask
        first, drawn from `generator`; under freeze_img the backbone's
        stages are detached before the neck, which still trains."""
        train = self.training
        if train and self.cfg.img.use_grid_mask:
            if generator is None:
                raise ValueError("GridMask in train mode needs a "
                                 "torch.Generator")
            images = grid_mask(images, generator)
        stages = self.img_backbone(images)
        if train and self.cfg.optim.freeze_img:
            stages = tuple(s.detach() for s in stages)
        return tuple(f.to(self.dtype) for f in self.img_neck(stages))

    def tail_graphed(self, batch: Dict[str, torch.Tensor]) -> bool:
        """Does this forward replay the tail graph (models/tail_graph.py)?
        On a card, with grad off and the model in eval mode, on the LiDAR
        branch alone, through the sparse encoder, with the head's
        proposals whole (no proposal block), and while no export or
        compile traces it.  Anything else runs eagerly."""
        return (self.device.type == "cuda" and not torch.is_grad_enabled()
                and not self.training and _lidar_only(self.cfg, batch)
                and self.cfg.middle.kind == "sparse"
                and not pmesh.shards(self.bbox_head.num_proposals)
                and not torch.compiler.is_compiling()
                and not torch.compiler.is_exporting())

    def _tail(self, feats: torch.Tensor, coords: torch.Tensor,
              mask: torch.Tensor):
        """The sparse encoder's output -> the head's outputs: the dense
        scatter, SECOND + FPN and the head."""
        maps = self.bev_maps(self.pts_middle_encoder.dense(feats, coords,
                                                           mask))
        with profiling.span("head"):
            return self.bbox_head(maps)

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None):
        """generator: in train mode GridMask's draws, then the head's
        dropout masks, in that order (on the model's device).  Where
        `tail_graphed`, everything after the sparse encoder is one CUDA
        graph's replay."""
        points, mask = self._inputs(batch)
        if self.tail_graphed(batch):
            feats, vox = self.voxel_features(points, mask)
            sparse = self.middle(feats, vox, dense=False)
            with profiling.span("tail_graph"):
                logits, boxes = self._tail_graphs.run(
                    self._tail, sparse, self, TAIL_MODULES)
            # the head's call hands this frame's outputs to its hooks, as
            # an eager call does
            return self.bbox_head(GraphOutputs(logits, boxes))
        if (self.device.type == "cuda" and not torch.is_grad_enabled()
                and _lidar_only(self.cfg, batch)):
            # an inference forward on the card that could not use the graph
            profiling.count("tail_graph.eager")
        maps = self.extract_point_features(points, mask)
        if self.training and self.cfg.optim.freeze_lidar:
            maps = tuple(f.detach() for f in maps)
        if _lidar_only(self.cfg, batch):
            # an LC model given no images runs its LiDAR branch alone
            with profiling.span("head"):
                return self.bbox_head(maps, generator)
        img_feats = self.extract_img_features(self.image_tensor(batch),
                                              generator)
        lidar2img = to_device(batch["lidar2img"], self.device).float()
        with profiling.span("head"):
            return self.bbox_head(maps, generator, img_feats, lidar2img)

    @torch.no_grad()
    @profiling.span("predict")
    def predict(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        """Inference + decode (reference simple_test, srfdet.py:309-335)."""
        return self.decode(self(batch))

    @profiling.span("decode")
    def decode(self, preds) -> Dict[str, torch.Tensor]:
        """The forward's (pred_logits, pred_boxes) -> the last layer's
        boxes after the config's test_cfg (score threshold, rotated NMS,
        top max_per_img); it reads no parameter."""
        pred_logits, pred_boxes = preds
        t = self.cfg.test
        return decode_boxes(pred_logits[-1], pred_boxes[-1],
                            use_nms=t.use_nms, nms_thr=t.nms_thr,
                            score_thr=t.score_thr, max_per_img=t.max_per_img,
                            post_center_range=t.post_center_range)
