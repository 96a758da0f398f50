"""Load a JAX `SRFDet` variable tree into the port's `SRFDet`.

`variables` is the flax tree {"params": ..., "batch_stats": ...} as nested
dicts of numpy arrays (e.g. `jax.tree_util.tree_map(np.asarray, v)`); this
module never imports JAX.  Every JAX leaf is mapped to one port tensor:

- Dense kernel (in, out) -> Linear weight (out, in); conv kernel HWIO ->
  OIHW; sparse-conv kernel (K, Cin, Cout) as it is;
- flax norms: scale -> weight, batch_stats mean/var -> running_mean/var;
- attention DenseGeneral kernels (C, heads, head_dim) and (heads,
  head_dim, C) -> (C, C) Linear weights;
- the head's scan-stacked head_series/single_head leaves (leading axis
  num_heads) -> one module per iteration;
- auto-named flax modules (Dense_0, LayerNorm_3, ...) -> the port's names;
- the head's deformable BEV encoder, lidar_encoder: level_embed,
  pos_{i}/{Dense_0, BatchNorm_0, Dense_1} -> pos.{i}.{fc1, bn, fc2},
  attn_{j} -> layers.{j}.attn, and the encoder's LayerNorm_{k} and
  Dense_{k} (two a layer, in call order) -> layers.{k // 2}.norm1|norm2
  and ffn1|ffn2;
- the image backbones: VoVNet's stem{k} and stage{s}_block{b} (conv{i},
  the concat 1x1 conv, whose input channels keep the join's order, and
  ese), ResNet's stem Conv_0 / BatchNorm_0 and layer{s}_{i} blocks
  (_ConvBN_{k} in call order, dcn2 with its conv_offset and its
  (kk*Cin, Cout) kernel as it is, the BN after it, down).

`jax_param_names` gives the same map by name alone (JAX parameter path ->
the port parameters it fills), for a tree of shapes; the tests hold the
port's freeze rules against JAX's through it.

It raises on a JAX leaf that maps to nothing and on a port parameter or
buffer left unset (torch's BatchNorm step counters, `num_batches_tracked`,
are not weights and stay as they are).
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

# single_head submodule -> port submodule of SingleSRFDetHead, given the
# numbers of cls and reg layers (flax numbers LayerNorms in call order)
_HEAD_NAMES = {"Dense_0": "ffn1", "Dense_1": "ffn2",
               "LayerNorm_0": "norm_attn", "LayerNorm_1": "norm_inst",
               "LayerNorm_2": "norm_ffn",
               "class_logits": "class_logits", "bboxes_delta": "bboxes_delta",
               "output_fused_proj": "output_fused_proj"}
_DYNCONV_NAMES = {"Dense_0": "dynamic_layer", "Dense_1": "out_layer",
                  "LayerNorm_0": "norm1", "LayerNorm_1": "norm2",
                  "LayerNorm_2": "norm3"}
_ATTN_NAMES = {"query": "q_proj", "key": "k_proj", "value": "v_proj",
               "out": "out_proj"}
_NORM_LEAF = {"scale": "weight", "bias": "bias", "mean": "running_mean",
              "var": "running_var"}


def _leaves(tree, prefix=()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _leaf(name: str, a: np.ndarray, norm: bool):
    """(port leaf name, array) of one module's leaf."""
    if norm:
        return _NORM_LEAF[name], a
    if name == "kernel":
        if a.ndim == 4:                          # conv HWIO -> OIHW
            return "weight", a.transpose(3, 2, 0, 1)
        return "weight", a.T                      # Dense (in, out)
    return name, a


def _single_head(path, a, n_cls):
    """Map one leaf under single_head (no leading iteration axis)."""
    mod = path[0]
    if mod == "self_attn":
        c = a.shape[0] if path[1] != "out" else a.shape[-1]
        if path[2] == "kernel":
            w = a.reshape(c, -1).T if path[1] != "out" else \
                a.reshape(-1, c).T
            return f"self_attn.{_ATTN_NAMES[path[1]]}.weight", w
        return f"self_attn.{_ATTN_NAMES[path[1]]}.bias", a.reshape(-1)
    if mod == "inst_interact":
        sub = _DYNCONV_NAMES[path[1]]
        name, arr = _leaf(path[2], a, path[1].startswith("LayerNorm"))
        return f"inst_interact.{sub}.{name}", arr
    m = re.fullmatch(r"(cls|reg)_(\d+)", mod)
    if m:
        name, arr = _leaf(path[1], a, False)
        return f"{m.group(1)}_fcs.{m.group(2)}.{name}", arr
    m = re.fullmatch(r"LayerNorm_(\d+)", mod)
    if m and int(m.group(1)) >= 3:
        i = int(m.group(1)) - 3
        sub = f"cls_norms.{i}" if i < n_cls else f"reg_norms.{i - n_cls}"
        return f"{sub}.{_NORM_LEAF[path[1]]}", a
    name, arr = _leaf(path[1], a, mod.startswith("LayerNorm"))
    return f"{_HEAD_NAMES[mod]}.{name}", arr


def _convbn(prefix: str, path, a):
    """A ConvBNReLU subtree: Conv_0 -> conv, BatchNorm_0 -> bn."""
    sub = {"Conv_0": "conv", "BatchNorm_0": "bn"}[path[0]]
    name, arr = _leaf(path[1], a, sub == "bn")
    return f"{prefix}.{sub}.{name}", arr


def _lidar_encoder(path, a):
    """One leaf under bbox_head/lidar_encoder."""
    pre = "bbox_head.lidar_encoder"
    sub = path[0]
    if sub == "level_embed":
        return f"{pre}.level_embed", a
    m = re.fullmatch(r"pos_(\d+)", sub)
    if m:
        mod = {"Dense_0": "fc1", "BatchNorm_0": "bn", "Dense_1": "fc2"}[
            path[1]]
        name, arr = _leaf(path[2], a, mod == "bn")
        return f"{pre}.pos.{m.group(1)}.{mod}.{name}", arr
    m = re.fullmatch(r"attn_(\d+)", sub)
    if m:
        if path[1] not in ("value_proj", "sampling_offsets",
                           "attention_weights", "output_proj"):
            raise KeyError(path[1])
        name, arr = _leaf(path[2], a, False)
        return f"{pre}.layers.{m.group(1)}.attn.{path[1]}.{name}", arr
    kind, k = re.fullmatch(r"(LayerNorm|Dense)_(\d+)", sub).groups()
    k = int(k)
    mod = ("norm" if kind == "LayerNorm" else "ffn") + str(k % 2 + 1)
    name, arr = _leaf(path[1], a, kind == "LayerNorm")
    return f"{pre}.layers.{k // 2}.{mod}.{name}", arr


def _img_backbone(path, a, dcn_blocks):
    """One leaf under img_backbone (VoVNet or ResNet)."""
    sub = path[0]
    if sub in ("stem1", "stem2", "stem3"):
        return _convbn(f"img_backbone.{sub}", path[1:], a)
    m = re.fullmatch(r"stage(\d)_block(\d+)", sub)
    if m:
        pre = (f"img_backbone.stages.{int(m.group(1)) - 2}."
               f"{m.group(2)}")
        part = path[1]
        if part == "ese":
            name, arr = _leaf(path[3], a, False)
            return f"{pre}.ese.fc.{name}", arr
        if part == "concat":
            return _convbn(f"{pre}.concat", path[2:], a)
        i = re.fullmatch(r"conv(\d+)", part).group(1)
        return _convbn(f"{pre}.convs.{i}", path[2:], a)
    if sub == "Conv_0":
        name, arr = _leaf(path[1], a, False)
        return f"img_backbone.conv1.{name}", arr
    if sub == "BatchNorm_0":
        return f"img_backbone.bn1.{_NORM_LEAF[path[1]]}", a
    s, i = re.fullmatch(r"layer(\d)_(\d+)", sub).groups()
    pre = f"img_backbone.layers.{int(s) - 1}.{i}"
    part = path[1]
    if part == "down":
        return _convbn(f"{pre}.down", path[2:], a)
    if part == "dcn2":
        if path[2] == "kernel":
            return f"{pre}.dcn2.kernel", a
        name, arr = _leaf(path[3], a, False)
        return f"{pre}.dcn2.conv_offset.{name}", arr
    if part == "BatchNorm_0":                       # the BN after dcn2
        return f"{pre}.bn2.{_NORM_LEAF[path[2]]}", a
    # _ConvBN_{k} in call order: conv1, conv2, conv3, with dcn2 in the
    # 3x3's place
    k = int(re.fullmatch(r"_ConvBN_(\d)", part).group(1))
    conv = 3 if k == 1 and sub in dcn_blocks else k + 1
    return _convbn(f"{pre}.conv{conv}", path[2:], a)


def _map(path, a, n_heads, n_cls, dcn_blocks=frozenset()):
    """JAX leaf path (collection dropped) -> [(port key, array)]."""
    top = path[0]
    if top == "img_backbone":
        return [_img_backbone(path[1:], a, dcn_blocks)]
    if top == "pts_voxel_encoder":
        # DynamicVFE's DynamicVFELayer_{i} and PillarFeatureNet's
        # PFNLayer_{i}, each {Dense_0, MaskedBatchNorm_0}; the centroid-aware
        # MLP's Dense_{0,1} / MaskedBatchNorm_{0,1}
        m = re.fullmatch(r"(?:DynamicVFE|PFN)Layer_(\d+)", path[1])
        if m:
            sub = {"Dense_0": "linear", "MaskedBatchNorm_0": "bn"}[path[2]]
            name, arr = _leaf(path[3], a, sub == "bn")
            return [(f"pts_voxel_encoder.layers.{m.group(1)}.{sub}.{name}",
                     arr)]
        kind, i = re.fullmatch(r"(Dense|MaskedBatchNorm)_([01])",
                               path[1]).groups()
        sub = {"Dense": "centroid_fc", "MaskedBatchNorm": "centroid_bn"}[kind]
        name, arr = _leaf(path[2], a, kind == "MaskedBatchNorm")
        return [(f"pts_voxel_encoder.{sub}{int(i) + 1}.{name}", arr)]
    if top == "pts_middle_encoder":
        conv = path[1]
        if path[2] == "kernel":
            return [(f"pts_middle_encoder.{conv}.kernel", a)]
        if path[2] == "MaskedBatchNorm_0":
            return [(f"pts_middle_encoder.{conv}.bn.{_NORM_LEAF[path[3]]}",
                     a)]
    elif top == "pts_backbone":
        i = int(re.fullmatch(r"ConvBNReLU_(\d+)", path[1]).group(1))
        return [_convbn(f"pts_backbone.blocks.{i}", path[2:], a)]
    elif top in ("pts_neck", "img_neck"):
        kind, i = re.fullmatch(r"(lateral|fpn|extra)_(\d+)",
                               path[1]).groups()
        return [_convbn(f"{top}.{kind}.{i}", path[2:], a)]
    elif top == "bbox_head":
        sub = path[1]
        if sub in ("init_proposal_boxes", "init_proposal_feats"):
            return [(f"bbox_head.{sub}", a)]
        if sub == "lidar_encoder":
            return [_lidar_encoder(path[2:], a)]
        m = re.fullmatch(r"dpg_dw_(lidar|img)_(\d+)", sub)
        if m:
            mod = "dpg_dw" if m.group(1) == "lidar" else "dpg_dw_img"
            return [_convbn(f"bbox_head.{mod}.{m.group(2)}", path[2:], a)]
        m = re.fullmatch(r"dpg_(fc1|fc2)_(lidar|img)", sub)
        if m:
            mod = f"dpg_{m.group(1)}" + ("_img" if m.group(2) == "img"
                                         else "")
            name, arr = _leaf(path[2], a, False)
            return [(f"bbox_head.{mod}.{name}", arr)]
        m = re.fullmatch(r"img_conv_(\d+)", sub)
        if m:
            name, arr = _leaf(path[2], a, False)
            return [(f"bbox_head.img_conv.{m.group(1)}.{name}", arr)]
        if sub == "head_series" and path[2] == "single_head":
            if a.shape[0] != n_heads:
                raise ValueError(f"{'/'.join(path)}: leading axis "
                                 f"{a.shape[0]} != num_heads {n_heads}")
            out = []
            for i in range(n_heads):
                key, arr = _single_head(path[3:], a[i], n_cls)
                out.append((f"bbox_head.heads.{i}.{key}", arr))
            return out
    raise KeyError("/".join(path))


def _dcn_blocks(variables: Dict) -> frozenset:
    img = variables.get("params", {}).get("img_backbone", {})
    return frozenset(k for k, v in img.items()
                     if isinstance(v, Mapping) and "dcn2" in v)


def jax_param_names(variables: Dict, n_heads: int, n_cls_convs: int
                    ) -> Dict[Tuple[str, ...], Tuple[str, ...]]:
    """JAX parameter path (under "params") -> the port parameters it fills
    (one, or one per iteration for the head's stacked leaves).  Leaves
    need only a `.shape`: the tree of `jax.eval_shape` will do."""
    names = {}
    dcn = _dcn_blocks(variables)

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, Mapping):
                walk(v, prefix + (k,))
                continue
            a = np.broadcast_to(np.zeros((), np.float32), tuple(v.shape))
            path = prefix + (k,)
            names[path] = tuple(key for key, _ in
                                _map(path, a, n_heads, n_cls_convs, dcn))
    walk(variables.get("params", {}), ())
    return names


def jax_state_dict(variables: Dict, n_heads: int, n_cls_convs: int
                   ) -> Dict[str, np.ndarray]:
    """The port's state dict (numpy) from a JAX variable tree; each JAX
    leaf is consumed once (a leaf that maps to nothing raises KeyError)."""
    state: Dict[str, np.ndarray] = {}
    dcn_blocks = _dcn_blocks(variables)
    for coll in ("params", "batch_stats"):
        for path, a in _leaves(variables.get(coll, {})):
            try:
                pairs = _map(path, a, n_heads, n_cls_convs, dcn_blocks)
            except (KeyError, AttributeError, IndexError) as e:
                raise KeyError(f"JAX leaf {coll}/{'/'.join(path)} maps to "
                               f"no port tensor") from e
            for key, arr in pairs:
                if key in state:
                    raise KeyError(f"port tensor {key} set twice")
                state[key] = arr
    return state


def load_jax_params(model: torch.nn.Module, variables: Dict) -> None:
    """Fill every parameter and buffer of the port's SRFDet from the JAX
    variable tree; raises on unused JAX leaves, unset port tensors, and
    shape mismatches."""
    hc = model.cfg.head
    state = jax_state_dict(variables, hc.num_heads, hc.num_cls_convs)
    target = {k: v for k, v in model.state_dict().items()
              if not k.endswith("num_batches_tracked")}
    extra = sorted(set(state) - set(target))
    if extra:
        raise KeyError(f"JAX leaves with no port tensor: {extra[:8]}")
    missing = sorted(set(target) - set(state))
    if missing:
        raise KeyError(f"port tensors the JAX tree does not set: "
                       f"{missing[:8]}")
    with torch.no_grad():
        for key, t in target.items():
            arr = np.array(state[key], copy=True)
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"{key}: JAX shape {arr.shape} vs port "
                                 f"{tuple(t.shape)}")
            t.copy_(torch.from_numpy(arr).to(t.dtype))
