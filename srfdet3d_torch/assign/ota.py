"""SimOTA-style dynamic-k assignment as fixed-shape masked ops.

A port of the JAX package's `assign/ota.py` (itself a redesign of the
reference OTAssignerSRFDet, ota_srfdet.py:19-330) over a (n_p, G_cap) pair
grid with a GT validity mask:

  - per-GT dynamic-k selection takes each GT's k smallest costs;
  - a pred matched to more than one GT keeps its global min-cost GT;
  - a bounded loop guarantees every valid GT at least one pred.

Kept from the JAX package: the stale-mask fix (the reference computes its
conflict mask once, before the guarantee loop; here, as there, every
iteration recomputes it) and the bound g + n_p on the loop.  Its batching
of 64 loop steps per convergence check is a TPU workaround: `step` is a
fixed-point map, so checking after every step gives the same matching.

Tie-breaking matches `lax.top_k` and `argmin`: the lower index wins.  The
k smallest costs come from a stable sort, not `torch.topk`, which promises
no order among ties.  Everything runs in float32 under `torch.no_grad`.

Every function takes any number of leading problem dims (batch, layers):
pred_boxes (..., n_p, 8|10), gt_boxes (..., G, 7|9).
"""

from __future__ import annotations

import torch

from ..config import OTAConfig
from ..geometry.boxes import (boxes3d_to_corners3d, denormalize_bbox,
                              normalize_bbox)
from ..geometry.iou import iou_3d
from ..ops.focal_loss import focal_loss_cost
from ..utils import profiling

_PAD_GT_COST = 1e8      # cost for padded GT columns (never matched)
_INVALID_COST = 1e4     # reference's +10000 for preds failing the gate
_MATCHED_BUMP = 1e5     # reference's +100000 inside the guarantee loop


def _in_gt_and_center(pred_boxes, gt_boxes, gt_mask, center_radius):
    """Gating masks (reference ota_srfdet.py:166-250): (valid (..., n_p),
    in_both (..., n_p, G)).  GT corners exponentiate the raw sizes
    (log_size=True), the reference's load-bearing quirk."""
    centers = pred_boxes[..., :, None, :3]                 # (..., n_p, 1, 3)
    corners = boxes3d_to_corners3d(gt_boxes[..., :7], bottom_center=False,
                                   yaw_as_sincos=False, log_size=True)
    mn = corners.amin(-2)[..., None, :, :]                 # (..., 1, G, 3)
    mx = corners.amax(-2)[..., None, :, :]
    in_box = ((centers > mn) & (centers < mx)).all(-1)
    gc = gt_boxes[..., None, :, :3]
    gs = gt_boxes[..., None, :, 3:6]
    in_center = ((centers > gc - center_radius * gs) &
                 (centers < gc + center_radius * gs)).all(-1)
    gm = gt_mask[..., None, :]
    in_box = in_box & gm
    in_center = in_center & gm
    valid = in_box.any(-1) | in_center.any(-1)
    return valid, in_box & in_center


def _dedup_rows(matching: torch.Tensor, best_onehot: torch.Tensor
                ) -> torch.Tensor:
    """Preds matched to more than one GT keep only their min-cost GT."""
    conflicted = matching.sum(-1, keepdim=True) > 1
    return torch.where(conflicted, best_onehot, matching)


@torch.no_grad()
def ota_assign_batch(pred_boxes: torch.Tensor, pred_logits: torch.Tensor,
                     gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                     gt_mask: torch.Tensor, head_idx, cfg: OTAConfig
                     ) -> torch.Tensor:
    """Assign every problem of the leading dims at once.

    pred_boxes (..., n_p, 8|10) absolute centers, log sizes; pred_logits
    (..., n_p, #cls); gt_boxes (..., G, 7|9) raw sizes, gravity-center z;
    gt_labels (..., G); gt_mask (..., G) bool; head_idx: the decoder layer
    index of the unit-increasing-k rule, a number or a tensor that
    broadcasts over the leading dims.  Returns matched_gt (..., n_p)
    int64, -1 = unmatched."""
    pred_boxes = pred_boxes.detach().float()
    pred_logits = pred_logits.detach().float()
    gt_boxes = gt_boxes.float()
    gt_mask = gt_mask.bool()
    n_p, g = pred_boxes.shape[-2], gt_boxes.shape[-2]
    dev = pred_boxes.device

    valid, in_both = _in_gt_and_center(pred_boxes, gt_boxes, gt_mask,
                                       cfg.center_radius)
    cls_cost = focal_loss_cost(pred_logits, gt_labels, alpha=cfg.cls_alpha,
                               gamma=cfg.cls_gamma, eps=cfg.cls_eps,
                               weight=cfg.cls_weight)     # (..., n_p, G)
    gt_norm = normalize_bbox(gt_boxes[..., :7])           # (..., G, 8)
    reg_cost = cfg.reg_weight * (pred_boxes[..., :, None, :8] -
                                 gt_norm[..., None, :, :]).abs().sum(-1)
    # the reference's BboxOverlaps3D reads z as the bottom center of
    # gravity-center boxes: shift both by +h/2 (JAX ota.py:145-151)
    pred_raw = denormalize_bbox(pred_boxes)
    pred_shift = torch.cat([pred_raw[..., :2], pred_raw[..., 2:3] +
                            0.5 * pred_raw[..., 5:6], pred_raw[..., 3:7]],
                           -1)
    gt_shift = torch.cat([gt_boxes[..., :2], gt_boxes[..., 2:3] +
                          0.5 * gt_boxes[..., 5:6], gt_boxes[..., 3:7]], -1)
    gm = gt_mask[..., None, :]
    ious = torch.where(gm, iou_3d(pred_shift, gt_shift), 0.0)
    iou_cost = -cfg.iou_weight * ious

    cost = cls_cost + reg_cost + iou_cost + 100.0 * (~in_both).float()
    cost = cost + _INVALID_COST * (~valid)[..., None].float()
    cost = torch.where(gm, cost, _PAD_GT_COST)

    # dynamic k per GT: the sum of its top-k IoUs, unit-increasing by head
    # index, truncated toward zero, at least 1
    k_top = min(cfg.candidate_topk, n_p)
    topk_ious = torch.topk(ious.transpose(-1, -2), k_top, dim=-1).values
    if not (isinstance(head_idx, torch.Tensor) and head_idx.device == dev):
        # on a card the copy from host memory waits for the stream
        profiling.count("host_sync")
    head = torch.as_tensor(head_idx, dtype=torch.float32, device=dev)
    head = head.reshape(head.shape + (1,) * (topk_ious.dim() - 1 -
                                             head.dim()))
    dynamic_ks = (topk_ious.sum(-1) - 0.5 * (cfg.num_heads - head)
                  ).to(torch.int32).clamp_min(1)          # (..., G)

    # each GT marks its dynamic_ks smallest-cost preds (a stable sort:
    # ties go to the lower pred index, as lax.top_k breaks them)
    cand = torch.sort(cost.transpose(-1, -2), dim=-1, stable=True
                      ).indices[..., :k_top]              # (..., G, k_top)
    sel = ((torch.arange(k_top, device=dev) < dynamic_ks[..., None]) &
           gt_mask[..., None])
    matching = torch.zeros(cost.shape[:-2] + (g, n_p), dtype=torch.uint8,
                           device=dev)
    matching = matching.scatter(-1, cand, sel.to(torch.uint8)
                                ).bool().transpose(-1, -2)
    row_best = cost.argmin(-1)                            # (..., n_p)
    best_onehot = row_best[..., None] == torch.arange(g, device=dev)
    matching = _dedup_rows(matching, best_onehot)

    # guarantee every valid GT >= 1 pred: each step matches every still
    # unmatched GT to its cheapest pred, matched preds bumped by 1e5 per
    # step they stay matched; at most g + n_p steps (each one matches a GT
    # or uses up a free pred)
    iota_p = torch.arange(n_p, device=dev)[:, None]
    bump = torch.zeros(cost.shape[:-1], device=dev)       # (..., n_p)
    for _ in range(g + n_p):
        un = gt_mask & ~matching.any(-2)                  # (..., G)
        profiling.count("host_sync")
        if not bool(un.any()):
            break
        bump = bump + _MATCHED_BUMP * matching.any(-1).float()
        best_pred = (cost + bump[..., None]).argmin(-2)   # (..., G)
        add = (best_pred[..., None, :] == iota_p) & un[..., None, :]
        matching = _dedup_rows(matching | add, best_onehot)

    matched = matching.any(-1)
    matched_gt = matching.to(torch.uint8).argmax(-1)
    return torch.where(matched, matched_gt, -1)


def ota_assign(pred_boxes: torch.Tensor, pred_logits: torch.Tensor,
               gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
               gt_mask: torch.Tensor, head_idx, cfg: OTAConfig
               ) -> torch.Tensor:
    """One sample: pred_boxes (n_p, 8|10), gt_boxes (G, 7|9) ->
    matched_gt (n_p,), -1 = unmatched."""
    return ota_assign_batch(pred_boxes[None], pred_logits[None],
                            gt_boxes[None], gt_labels[None], gt_mask[None],
                            head_idx, cfg)[0]
