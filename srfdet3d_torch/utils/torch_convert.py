"""Reference mm-stack checkpoints -> the port's state_dict.

The reference SRFDet3D is PyTorch too, so most tensors keep their layout:
Conv2d OIHW and Linear (out, in) go over as they are, and only the module
names change.  These transform:

  - spconv SubM/SparseConv3d weights -> the port's (K, Cin, Cout), K =
    kz*ky*kx in z-major (dz, dy, dx) offset order, the rulebooks' order.
    `layout` names the source: 'KIO' (kz, ky, kx, in, out), the
    reference's mmcv.ops import and the default; 'OKI' (out, kz, ky, kx,
    in), spconv 2.x.  It cannot be detected: a 3x3x3 kernel has small
    middle axes in both.
  - SECOND's first conv after the sparse encoder reads its input channels
    through `bev_in_perm`: the reference flattens the dense BEV as c*D + d,
    the port keeps the z-major d*C + c of the JAX package's encoder.
  - MultiheadAttention's in_proj_weight / in_proj_bias (3C, C) split into
    the port's q_proj, k_proj and v_proj Linears; out_proj as it is.
  - ModulatedDeformConv2d (DCNv2) weights (Cout, Cin, kh, kw) -> the port's
    tap-major (kh*kw*Cin, Cout).
  - BatchNorm weight, bias, running_mean and running_var -> the port's BN
    parameters and buffers of the same names.  The reference's step
    counters (`num_batches_tracked`) are not converted: the port's BNs run
    at a fixed momentum and never read theirs, which stay as built.
  - the head's per-iteration modules `bbox_head.head_series_lidar.{t}`
    map one to one onto the port's `bbox_head.heads.{t}` (the JAX package
    stacks them for its scan; the port keeps them apart).

A partial checkpoint converts what it has, top module by top module, as
the JAX package's converter does: a LiDAR-only checkpoint into an LC
config gives the LiDAR tensors and nothing for the image branch.  Nothing
is ever made up: every output tensor is one reference tensor, moved.

The same conversion as the JAX package's `utils/torch_convert.py`
followed by its tree's map onto the port's names, without the flax tree
in between.  Numpy and torch only.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..models.resnet import RESNET_DEPTHS
from ..models.sparse_encoder import down_pads
from ..models.vovnet import VOVNET_SPECS

SPCONV_LAYOUTS = ("KIO", "OKI")
BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def spconv_w(w: np.ndarray, layout: str) -> np.ndarray:
    """spconv kernel -> (K, in, out), K in z-major (kz, ky, kx) order."""
    w = np.asarray(w)
    if w.ndim != 5:
        raise ValueError(f"expected a 5D spconv weight, got {w.shape}")
    if layout not in SPCONV_LAYOUTS:
        raise ValueError(f"layout must be 'KIO' or 'OKI', got {layout!r}")
    if layout == "OKI":                      # (out, kz, ky, kx, in)
        w = np.transpose(w, (1, 2, 3, 4, 0))
    return w.reshape(w.shape[0] * w.shape[1] * w.shape[2], w.shape[3],
                     w.shape[4])


def dcn_w(w: np.ndarray) -> np.ndarray:
    """DCNv2 weight (Cout, Cin, kh, kw) -> tap-major (kh*kw*Cin, Cout)."""
    cout, cin, kh, kw = w.shape
    return np.transpose(w, (2, 3, 1, 0)).reshape(kh * kw * cin, cout)


def bev_in_perm(depth: int, channels: int) -> np.ndarray:
    """Input-channel order of SECOND's first conv: new_in[d*C + c] =
    old_in[c*D + d] (the reference's dense BEV is (N, C*D, H, W), the
    port's z-major (B, H, W, D*C))."""
    c_idx = np.arange(channels)[None, :]
    d_idx = np.arange(depth)[:, None]
    return (c_idx * depth + d_idx).reshape(-1)


def _encoder_out_depth(cfg) -> int:
    """z depth of the sparse encoder's dense BEV output (nuScenes: 41 ->
    21 -> 11 -> 5 -> conv_out -> 2), over the encoder's own downsample
    paddings."""
    mc = cfg.middle
    d = cfg.voxelization.sparse_shape[0]
    for pad in down_pads(mc.block_type, mc.encoder_channels,
                         mc.encoder_paddings):
        pz = pad[0] if isinstance(pad, (tuple, list)) else pad
        d = (d + 2 * pz - 3) // 2 + 1
    return (d - 3) // 2 + 1


class _Converter:
    """Reads reference tensors by name (recording each one used) and
    writes port tensors by name (refusing to write one twice)."""

    def __init__(self, state: Dict):
        self.state = state
        self.used = set()
        self.out: Dict[str, np.ndarray] = {}

    def has(self, key: str) -> bool:
        return key in self.state

    def any_under(self, prefix: str) -> bool:
        return any(k.startswith(prefix + ".") for k in self.state)

    def get(self, key: str) -> np.ndarray:
        v = self.state[key]
        self.used.add(key)
        if isinstance(v, torch.Tensor):
            return v.detach().cpu().numpy()
        return np.asarray(v)

    def put(self, key: str, value: np.ndarray) -> None:
        if key in self.out:
            raise KeyError(f"port tensor {key} set twice")
        self.out[key] = value

    def copy(self, src: str, dst: str) -> None:
        self.put(dst, self.get(src))

    def bn(self, src: str, dst: str) -> None:
        for leaf in BN_LEAVES:
            self.copy(f"{src}.{leaf}", f"{dst}.{leaf}")

    def weight_bias(self, src: str, dst: str, bias: bool = True) -> None:
        self.copy(f"{src}.weight", f"{dst}.weight")
        if bias:
            self.copy(f"{src}.bias", f"{dst}.bias")


def convert_vfe(c: _Converter, cfg) -> None:
    """pts_voxel_encoder: DynamicVFECustom's vfe_layers.{i}.linear/.norm
    and the centroid MLP cen2point_pos_enc.{0,1,3,4}, or
    PillarFeatureNetCustom's pfn_layers.{i} -> layers.{i}.linear/.bn,
    centroid_fc{1,2} / centroid_bn{1,2}.  HardSimpleVFE has none."""
    tp = "pts_voxel_encoder"
    kind = cfg.vfe.kind
    if kind not in ("dynamic", "pillar"):
        return
    src = "vfe_layers" if kind == "dynamic" else "pfn_layers"
    for i in range(len(cfg.vfe.feat_channels)):
        c.weight_bias(f"{tp}.{src}.{i}.linear",
                      f"{tp}.layers.{i}.linear", bias=False)
        c.bn(f"{tp}.{src}.{i}.norm", f"{tp}.layers.{i}.bn")
    if kind == "dynamic" and cfg.vfe.with_centroid_aware:
        for k, (li, bi) in enumerate(((0, 1), (3, 4)), start=1):
            c.weight_bias(f"{tp}.cen2point_pos_enc.{li}",
                          f"{tp}.centroid_fc{k}", bias=False)
            c.bn(f"{tp}.cen2point_pos_enc.{bi}", f"{tp}.centroid_bn{k}")


def convert_sparse_encoder(c: _Converter, cfg, layout: str) -> None:
    """SparseEncoderCustom -> the port's SparseEncoder: conv_input,
    encoder_layers.encoder_layer{i+1}.{j} (conv_module: SparseSequential
    (conv .0, BN .1), the downsample at j == 0 of stages 1..; basicblock:
    SparseBasicBlock conv1/bn1/conv2/bn2, the downsample last in every
    stage but the last) and conv_out -> conv_input, subm{i}_{j} /
    down{i} / bb{i}_{j}_conv{1,2}, conv_out, each .kernel and .bn."""
    tp = "pts_middle_encoder"

    def pair(src_conv: str, src_bn: str, dst: str) -> None:
        c.put(f"{tp}.{dst}.kernel", spconv_w(c.get(src_conv), layout))
        c.bn(src_bn, f"{tp}.{dst}.bn")

    pair(f"{tp}.conv_input.0.weight", f"{tp}.conv_input.1", "conv_input")
    mc = cfg.middle
    n_stages = len(mc.encoder_channels)
    for i, blocks in enumerate(mc.encoder_channels):
        for j in range(len(blocks)):
            tm = f"{tp}.encoder_layers.encoder_layer{i + 1}.{j}"
            if mc.block_type == "conv_module":
                dst = f"down{i}" if i != 0 and j == 0 else f"subm{i}_{j}"
                pair(f"{tm}.0.weight", f"{tm}.1", dst)
            elif j == len(blocks) - 1 and i != n_stages - 1:
                pair(f"{tm}.0.weight", f"{tm}.1", f"down{i}")
            else:
                for k in (1, 2):
                    pair(f"{tm}.conv{k}.weight", f"{tm}.bn{k}",
                         f"bb{i}_{j}_conv{k}")
    pair(f"{tp}.conv_out.0.weight", f"{tp}.conv_out.1", "conv_out")


def convert_second_backbone(c: _Converter, cfg) -> None:
    """SECONDCustom blocks.{stage} Sequential (Conv, BN, ReLU)* -> the
    port's flat blocks.{n}.conv / .bn; after a sparse encoder the first
    conv reads its input channels through bev_in_perm."""
    n = 0
    for stage, n_layers in enumerate(cfg.backbone.layer_nums):
        for j in range(n_layers + 1):
            w = c.get(f"pts_backbone.blocks.{stage}.{3 * j}.weight")
            if n == 0 and cfg.middle.kind == "sparse":
                w = w[:, bev_in_perm(_encoder_out_depth(cfg),
                                     cfg.middle.output_channels)]
            c.put(f"pts_backbone.blocks.{n}.conv.weight", w)
            c.bn(f"pts_backbone.blocks.{stage}.{3 * j + 1}",
                 f"pts_backbone.blocks.{n}.bn")
            n += 1


def convert_fpn(c: _Converter, prefix: str, num_ins: int, num_outs: int,
                with_bn: bool = True, extra_convs: bool = True) -> None:
    """mmdet FPN: lateral_convs.{i} and fpn_convs.{i} ConvModules (.conv,
    .bn), the extra 'on_output' convs appended to fpn_convs -> lateral.{i},
    fpn.{i}, extra.{e} (.conv, .bn).  Pool extras have no weights."""
    def one(src: str, dst: str) -> None:
        c.copy(f"{src}.conv.weight", f"{dst}.conv.weight")
        if c.has(f"{src}.conv.bias"):
            c.copy(f"{src}.conv.bias", f"{dst}.conv.bias")
        if with_bn:
            c.bn(f"{src}.bn", f"{dst}.bn")

    for i in range(num_ins):
        one(f"{prefix}.lateral_convs.{i}", f"{prefix}.lateral.{i}")
        one(f"{prefix}.fpn_convs.{i}", f"{prefix}.fpn.{i}")
    if extra_convs:
        for e in range(num_outs - num_ins):
            one(f"{prefix}.fpn_convs.{num_ins + e}", f"{prefix}.extra.{e}")


def convert_vovnet(c: _Converter, spec_name: str) -> None:
    """VoVNet (the reference's OrderedDict names): stem.stem_{k}/conv|norm,
    stage{S}.OSA{S}_{B}.layers.{i}.OSA{S}_{B}_{i}/conv|norm,
    .concat.OSA{S}_{B}_concat/conv|norm, .ese.fc -> stem{k},
    stages.{S-2}.{B-1}.convs.{i}, .concat (.conv, .bn) and .ese.fc."""
    tp = "img_backbone"
    spec = VOVNET_SPECS[spec_name]

    def convbn(src: str, dst: str) -> None:
        c.copy(f"{src}/conv.weight", f"{dst}.conv.weight")
        c.bn(f"{src}/norm", f"{dst}.bn")

    for k in (1, 2, 3):
        convbn(f"{tp}.stem.stem_{k}", f"{tp}.stem{k}")
    for si, nblocks in enumerate(spec["block_per_stage"]):
        s = si + 2
        for b in range(nblocks):
            src = f"{tp}.stage{s}.OSA{s}_{b + 1}"
            dst = f"{tp}.stages.{si}.{b}"
            for i in range(spec["layer_per_block"]):
                convbn(f"{src}.layers.{i}.OSA{s}_{b + 1}_{i}",
                       f"{dst}.convs.{i}")
            convbn(f"{src}.concat.OSA{s}_{b + 1}_concat", f"{dst}.concat")
            c.weight_bias(f"{src}.ese.fc", f"{dst}.ese.fc")


def convert_resnet(c: _Converter, depth: int, stage_with_dcn) -> None:
    """mmdet ResNet: conv1/bn1, layer{l}.{i}.conv{k}|bn{k} and
    downsample.0|1; a DCN bottleneck keeps its deformable weight at conv2
    with conv2.conv_offset -> conv1 / bn1, layers.{l-1}.{i}.conv{k} (.conv,
    .bn), .down, and for DCN .dcn2.kernel, .dcn2.conv_offset and .bn2."""
    tp = "img_backbone"
    kind, layers = RESNET_DEPTHS[depth]
    c.copy(f"{tp}.conv1.weight", f"{tp}.conv1.weight")
    c.bn(f"{tp}.bn1", f"{tp}.bn1")
    for l, n in enumerate(layers, start=1):
        dcn = stage_with_dcn[l - 1] and kind == "bottleneck"
        for i in range(n):
            src = f"{tp}.layer{l}.{i}"
            dst = f"{tp}.layers.{l - 1}.{i}"
            convs = (1, 2) if kind == "basic" else (1, 2, 3)
            for k in convs:
                if dcn and k == 2:
                    c.put(f"{dst}.dcn2.kernel",
                          dcn_w(c.get(f"{src}.conv2.weight")))
                    c.weight_bias(f"{src}.conv2.conv_offset",
                             f"{dst}.dcn2.conv_offset")
                    c.bn(f"{src}.bn2", f"{dst}.bn2")
                    continue
                c.copy(f"{src}.conv{k}.weight", f"{dst}.conv{k}.conv.weight")
                c.bn(f"{src}.bn{k}", f"{dst}.conv{k}.bn")
            if c.has(f"{src}.downsample.0.weight"):
                c.copy(f"{src}.downsample.0.weight",
                       f"{dst}.down.conv.weight")
                c.bn(f"{src}.downsample.1", f"{dst}.down.bn")


def convert_single_head(c: _Converter, cfg, t: int) -> None:
    """One iteration, reference SingleSRFDetHeadLiDAR
    `bbox_head.head_series_lidar.{t}` (attributes suffixed `_lidar`) ->
    the port's `bbox_head.heads.{t}`: self_attn (in_proj split into
    q/k/v), inst_interact, linear1/2 -> ffn1/2, norm1/2/3 -> norm_attn /
    norm_inst / norm_ffn, cls_module / reg_module [Linear, LN, ReLU]* ->
    cls_fcs / cls_norms and reg_fcs / reg_norms, class_logits,
    bboxes_delta, and a fusion iteration's output_fused_proj."""
    hc = cfg.head
    src = f"bbox_head.head_series_lidar.{t}"
    dst = f"bbox_head.heads.{t}"
    sfx = "_lidar"
    w = c.get(f"{src}.self_attn{sfx}.in_proj_weight")
    b = c.get(f"{src}.self_attn{sfx}.in_proj_bias")
    ch = w.shape[1]
    for i, name in enumerate(("q_proj", "k_proj", "v_proj")):
        c.put(f"{dst}.self_attn.{name}.weight", w[i * ch:(i + 1) * ch])
        c.put(f"{dst}.self_attn.{name}.bias", b[i * ch:(i + 1) * ch])
    c.weight_bias(f"{src}.self_attn{sfx}.out_proj",
                  f"{dst}.self_attn.out_proj")
    ii = f"{src}.inst_interact{sfx}"
    for name in ("dynamic_layer", "out_layer", "norm1", "norm2", "norm3"):
        c.weight_bias(f"{ii}.{name}", f"{dst}.inst_interact.{name}")
    c.weight_bias(f"{src}.linear1{sfx}", f"{dst}.ffn1")
    c.weight_bias(f"{src}.linear2{sfx}", f"{dst}.ffn2")
    for ref, port in (("norm1", "norm_attn"), ("norm2", "norm_inst"),
                      ("norm3", "norm_ffn")):
        c.weight_bias(f"{src}.{ref}{sfx}", f"{dst}.{port}")
    for tower, n in (("cls", hc.num_cls_convs), ("reg", hc.num_reg_convs)):
        for k in range(n):
            mod = f"{src}.{tower}_module{sfx}"
            c.weight_bias(f"{mod}.{3 * k}", f"{dst}.{tower}_fcs.{k}",
                          bias=False)
            c.weight_bias(f"{mod}.{3 * k + 1}", f"{dst}.{tower}_norms.{k}")
    c.weight_bias(f"{src}.class_logits{sfx}", f"{dst}.class_logits")
    c.weight_bias(f"{src}.bboxes_delta{sfx}", f"{dst}.bboxes_delta")
    if c.has(f"{src}.output_fused_proj.weight"):
        c.weight_bias(f"{src}.output_fused_proj", f"{dst}.output_fused_proj")


def convert_head(c: _Converter, cfg) -> None:
    """SRFDetHead: the proposal embeddings, the LiDAR DPG staircase
    (dpg_dw_convs_lidar.{lvl} depthwise ConvModules, dpg_fc1/2_lidar),
    an LC head's image extras (img_convs.{i}, where hidden_dim differs
    from the image features' width, and the image DPG: dpg_dw_convs_img,
    dpg_fc1/2_img) and the per-iteration heads."""
    hc = cfg.head
    tp = "bbox_head"
    if c.has(f"{tp}.init_proposal_boxes.weight"):
        c.copy(f"{tp}.init_proposal_boxes.weight",
               f"{tp}.init_proposal_boxes")
        c.copy(f"{tp}.init_proposal_feats.weight",
               f"{tp}.init_proposal_feats")
    if hc.with_dpg:
        for lvl in range(hc.lidar_feat_lvls - 1):
            src = f"{tp}.dpg_dw_convs_lidar.{lvl}"
            c.copy(f"{src}.conv.weight", f"{tp}.dpg_dw.{lvl}.conv.weight")
            c.bn(f"{src}.bn", f"{tp}.dpg_dw.{lvl}.bn")
        for fc in ("fc1", "fc2"):
            c.weight_bias(f"{tp}.dpg_{fc}_lidar", f"{tp}.dpg_{fc}")
    if c.any_under(f"{tp}.img_convs"):
        for i in range(hc.img_feat_lvls):
            c.weight_bias(f"{tp}.img_convs.{i}", f"{tp}.img_conv.{i}")
    if c.any_under(f"{tp}.dpg_dw_convs_img"):
        for lvl in range(hc.img_feat_lvls - 1):
            src = f"{tp}.dpg_dw_convs_img.{lvl}"
            c.copy(f"{src}.conv.weight",
                   f"{tp}.dpg_dw_img.{lvl}.conv.weight")
            c.bn(f"{src}.bn", f"{tp}.dpg_dw_img.{lvl}.bn")
        for fc in ("fc1", "fc2"):
            c.weight_bias(f"{tp}.dpg_{fc}_img", f"{tp}.dpg_{fc}_img")
    for t in range(hc.num_heads):
        convert_single_head(c, cfg, t)


def convert_reference_state_dict(state: Dict, cfg, spconv_layout: str = "KIO"
                                 ) -> Tuple[Dict[str, torch.Tensor],
                                            List[str]]:
    """A reference checkpoint's state_dict (numpy arrays or torch tensors,
    no `module.` prefix) -> (the port's state_dict for `cfg`, the sorted
    reference keys it did not use).  Each top module present in `state`
    converts whole (a key missing inside one raises KeyError); a top
    module absent from it gives no tensor."""
    if spconv_layout not in SPCONV_LAYOUTS:
        raise ValueError(f"spconv_layout must be 'KIO' or 'OKI', got "
                         f"{spconv_layout!r}")
    c = _Converter(state)
    if c.any_under("pts_voxel_encoder"):
        convert_vfe(c, cfg)
    if c.any_under("pts_middle_encoder"):
        convert_sparse_encoder(c, cfg, spconv_layout)
    if c.any_under("pts_backbone"):
        convert_second_backbone(c, cfg)
    if c.any_under("pts_neck"):
        convert_fpn(c, "pts_neck", len(cfg.backbone.out_channels),
                    cfg.neck_num_outs, extra_convs=cfg.neck_extra_convs)
    if cfg.use_img and c.any_under("img_backbone"):
        if cfg.img.backbone.startswith("vovnet"):
            convert_vovnet(c, cfg.img.backbone)
        else:
            convert_resnet(c, int(cfg.img.backbone.split("-")[1]),
                           tuple(cfg.img.stage_with_dcn))
    if cfg.use_img and c.any_under("img_neck"):
        convert_fpn(c, "img_neck", 4, cfg.img.neck_num_outs,
                    with_bn=cfg.img.neck_norm)
    if c.any_under("bbox_head"):
        convert_head(c, cfg)
    out = {k: torch.from_numpy(np.ascontiguousarray(v))
           for k, v in c.out.items()}
    return out, sorted(set(state) - c.used)
