"""Sigmoid focal loss and the focal matching cost (plain torch, as in the
JAX package, `ops/focal_loss.py`).

Targets are integer class labels in [0, num_classes]; num_classes means
background (an all-zero one-hot), mmdet's convention.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def sigmoid_focal_loss(logits: torch.Tensor, labels: torch.Tensor,
                       alpha: float = 0.25, gamma: float = 2.0,
                       weight: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """(..., C) logits, (...,) labels -> (...,) loss summed over classes."""
    c = logits.shape[-1]
    targets = F.one_hot(labels.long(), c + 1)[..., :c].to(logits.dtype)
    p = torch.sigmoid(logits)
    ce = -(targets * F.logsigmoid(logits) +
           (1 - targets) * F.logsigmoid(-logits))
    p_t = p * targets + (1 - p) * (1 - targets)
    alpha_t = alpha * targets + (1 - alpha) * (1 - targets)
    loss = (alpha_t * ((1 - p_t) ** gamma) * ce).sum(-1)
    if weight is not None:
        loss = loss * weight
    return loss


def focal_loss_cost(logits: torch.Tensor, gt_labels: torch.Tensor,
                    alpha: float = 0.25, gamma: float = 2.0,
                    eps: float = 1e-8, weight: float = 1.0) -> torch.Tensor:
    """mmdet's FocalLossCost: logits (..., n_p, C), gt_labels (..., G) ->
    cost (..., n_p, G)."""
    p = torch.sigmoid(logits)
    pos = -alpha * ((1 - p) ** gamma) * torch.log(p + eps)
    neg = -(1 - alpha) * (p ** gamma) * torch.log(1 - p + eps)
    cols = gt_labels.long()[..., None, :].expand(
        *logits.shape[:-1], gt_labels.shape[-1])
    return (pos.gather(-1, cols) - neg.gather(-1, cols)) * weight
