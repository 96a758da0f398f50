"""Set-prediction losses of the SRFDet head (a port of the JAX package's
`models/losses.py`; reference srfdet_head.py loss_ota :1041,
loss_classification :1098, loss_boxes :1145, loss_hung :760).  The
assigner is `loss.assigner`: "ota" (the default), "hungarian" (scipy on
the host) or "auction" (on the device), each run per layer.

The loss normalizer spans every replica, as the JAX package's
`psum_if_sync` makes it (reference reduce_mean and sync_cls_avg_factor,
srfdet_head.py:873-884): under a process group (`parallel.mesh`) each
layer's positive count `num_inst` is summed over the data group (no
gradient; the model ranks of one data shard hold the same outputs),
and each rank's losses are its LOCAL focal and L1 sums over that global
count.  The ranks' losses then sum to the global batch's, and so do their
gradients once the step sums them (`all_reduce_grads`); the train step
reports the summed losses.  Without a group the count and the sums are the
local batch's, which is the whole batch.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..assign.hungarian import hungarian_assign
from ..assign.ota import ota_assign_batch
from ..config import LossConfig, OTAConfig
from ..geometry.boxes import normalize_bbox
from ..ops.focal_loss import sigmoid_focal_loss
from ..parallel import mesh
from ..utils import profiling


def _layer_losses(pred_logits: torch.Tensor, pred_boxes: torch.Tensor,
                  matched_gt: torch.Tensor, gt_boxes: torch.Tensor,
                  gt_labels: torch.Tensor, cfg: LossConfig,
                  num_inst: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder layer.  matched_gt (B, n_p), -1 = unmatched;
    pred_boxes (B, n_p, code) with absolute centers; num_inst the layer's
    normalizer (its positives over every rank, at least 1)."""
    code = len(cfg.code_weights)
    matched = matched_gt >= 0
    safe_idx = matched_gt.clamp_min(0).long()
    tgt_labels = torch.where(matched, gt_labels.long().gather(1, safe_idx),
                             cfg.num_classes)
    cls = sigmoid_focal_loss(pred_logits.float(), tgt_labels,
                             alpha=cfg.cls_alpha, gamma=cfg.cls_gamma)
    loss_cls = cfg.cls_weight * cls.sum() / num_inst

    tgt_boxes = gt_boxes.gather(1, safe_idx[..., None].expand(
        -1, -1, gt_boxes.shape[-1]))
    tgt_norm = normalize_bbox(tgt_boxes.float())[..., :code]
    cw = torch.tensor(cfg.code_weights, dtype=torch.float32,
                      device=pred_boxes.device)
    # on a card the copy from host memory waits for the stream
    profiling.count("host_sync")
    l1 = (pred_boxes[..., :code].float() - tgt_norm).abs() * cw
    # drop whole rows whose target has a non-finite element (reference
    # isnotnan, srfdet_head.py:1190), and non-finite elements of the rest
    row_ok = torch.isfinite(tgt_norm).all(-1, keepdim=True)
    l1 = torch.where(torch.isfinite(l1) & row_ok, l1, 0.0)
    l1 = torch.where(matched[..., None], l1, 0.0)
    loss_bbox = cfg.bbox_weight * l1.sum() / num_inst
    return torch.nan_to_num(loss_cls), torch.nan_to_num(loss_bbox)


def srfdet_losses(pred_logits: torch.Tensor, pred_boxes: torch.Tensor,
                  gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                  gt_mask: torch.Tensor, loss_cfg: LossConfig,
                  ota_cfg: OTAConfig, decoder_num_heads: int = 0
                  ) -> Dict[str, torch.Tensor]:
    """All-layer losses (reference loss_ota, srfdet_head.py:1041-1097).

    pred_logits (L, B, n_p, #cls); pred_boxes (L, B, n_p, code) absolute
    centers, log sizes; gt_boxes (B, G, 7|9) raw sizes, gravity-center z;
    gt_labels (B, G); gt_mask (B, G) bool.  Returns loss_cls / loss_bbox of
    the last layer and s.{i}.loss_* of the auxiliary layers."""
    if loss_cfg.assigner not in ("ota", "hungarian", "auction"):
        raise ValueError(f"unknown assigner {loss_cfg.assigner!r}")
    num_layers = pred_logits.shape[0]
    # aux layer i uses head_idx i + 1; the last uses the decoder's layer
    # count (reference srfdet_head.py:1067), so deep_supervision=False
    # keeps the final layer's schedule
    top_idx = decoder_num_heads or num_layers
    head_idxs = [top_idx if layer == num_layers - 1 else layer + 1
                 for layer in range(num_layers)]
    # every layer's assignment in one batched call
    lead = (num_layers,) + tuple(gt_boxes.shape[:1])

    def per_layer(t):
        return t[None].expand(lead + tuple(t.shape[1:]))
    gt = (per_layer(gt_boxes), per_layer(gt_labels), per_layer(gt_mask))
    if loss_cfg.assigner == "ota":
        matched_all = ota_assign_batch(
            pred_boxes, pred_logits, *gt,
            torch.tensor(head_idxs, dtype=torch.float32), ota_cfg)
    else:
        matched_all = hungarian_assign(
            pred_boxes, pred_logits, *gt, cls_weight=loss_cfg.cls_weight,
            reg_weight=loss_cfg.bbox_weight,
            on_device=loss_cfg.assigner == "auction")
    # every layer's positives, summed over the ranks in one collective
    num_inst = mesh.sum_if_sync(
        (matched_all >= 0).flatten(1).float().sum(1)).clamp_min(1.0)
    losses: Dict[str, torch.Tensor] = {}
    for layer in range(num_layers):
        loss_cls, loss_bbox = _layer_losses(
            pred_logits[layer], pred_boxes[layer], matched_all[layer],
            gt_boxes, gt_labels, loss_cfg, num_inst[layer])
        prefix = "" if layer == num_layers - 1 else f"s.{layer}."
        losses[f"{prefix}loss_cls"] = loss_cls
        losses[f"{prefix}loss_bbox"] = loss_bbox
    return losses
