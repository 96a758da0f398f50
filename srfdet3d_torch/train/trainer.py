"""The train step: OTA losses, backward, grad clip and a flat AdamW with a
warmup-cosine schedule (a port of the JAX package's `train/trainer.py`;
reference AdamW lr 2e-4, wd 0.01, grad clip 35, cfg
srfdet_voxel_nusc_L.py:337-353).

    opt = make_optimizer(model, cfg, total_steps)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    metrics = train_step(model, opt, batch, gen)

`batch` holds points, points_mask, gt_boxes (B, G, 7|9), gt_labels (B, G)
and gt_mask (B, G).  The JAX package splits the step into a grad program
and an apply program to work around XLA; eager PyTorch needs no split.
Gradient accumulation (`optim.accum_steps > 1`) is not ported yet.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch

from ..config import OptimConfig, SRFDetConfig
from ..models.detector import LIDAR_MODULES
from ..models.losses import srfdet_losses

_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def make_lr_schedule(optim: OptimConfig, total_steps: int
                     ) -> Callable[[int], float]:
    """Linear warmup from lr * warmup_ratio, then a cosine to lr *
    min_lr_ratio taken at the ABSOLUTE iteration over total_steps (mmcv's
    CosineAnnealingLrUpdaterHook: after warmup the lr resumes on the cosine,
    slightly below lr)."""
    lr, warm = optim.lr, optim.warmup_iters
    init = lr * optim.warmup_ratio
    min_lr = lr * optim.min_lr_ratio

    def schedule(count: int) -> float:
        if count < warm:
            return init + (lr - init) * count / warm
        frac = min(max(count / max(total_steps, 1), 0.0), 1.0)
        return min_lr + (lr - min_lr) * 0.5 * (1.0 + math.cos(math.pi * frac))

    return schedule


def freeze_mask(model: torch.nn.Module, cfg: SRFDetConfig
                ) -> Dict[str, bool]:
    """Parameter name -> trainable.  freeze_lidar freezes every `pts_*`
    module (reference freeze_lidar_components, tools/train.py:221-276).
    The image branch's rules (freeze_img, frozen_stages, norm_frozen) come
    with the image branch."""
    frozen = tuple(f"{m}." for m in LIDAR_MODULES) \
        if cfg.optim.freeze_lidar else ()
    return {name: not name.startswith(frozen)
            for name, _ in model.named_parameters()}


class FlatAdamW:
    """Global-norm clip + AdamW over the trainable parameters as one flat
    vector (JAX `make_optimizer`).  Its moments are two flat buffers; the
    step count lives on the host.

    As in the JAX update: the clip is optax's select with no epsilon
    (g * clip / |g| when |g| >= clip), the schedule is read at the count
    BEFORE the increment, and decoupled weight decay applies to every
    trainable leaf.  Frozen parameters are not in the vector: their grads
    enter neither the norm nor an update."""

    def __init__(self, model: torch.nn.Module, cfg: SRFDetConfig,
                 total_steps: int):
        if cfg.optim.accum_steps > 1:
            raise NotImplementedError("optim.accum_steps > 1 is not ported "
                                      "yet")
        mask = freeze_mask(model, cfg)
        self.params: List[torch.nn.Parameter] = [
            p for name, p in model.named_parameters() if mask[name]]
        self.schedule = make_lr_schedule(cfg.optim, total_steps)
        self.weight_decay = cfg.optim.weight_decay
        self.clip = cfg.optim.grad_clip
        self.count = 0
        n = sum(p.numel() for p in self.params)
        dev = self.params[0].device
        self.mu = torch.zeros(n, device=dev)
        self.nu = torch.zeros(n, device=dev)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Apply one update from the parameters' .grad; returns the global
        grad norm (before the clip)."""
        g = torch.cat([p.grad.reshape(-1) if p.grad is not None
                       else torch.zeros_like(p).reshape(-1)
                       for p in self.params])
        flat = torch.cat([p.reshape(-1) for p in self.params])
        gn = torch.sqrt(torch.sum(g * g))
        g = torch.where(gn < self.clip, g, g * (self.clip / gn))
        self.mu.mul_(_B1).add_((1.0 - _B1) * g)
        self.nu.mul_(_B2).add_((1.0 - _B2) * (g * g))
        c = self.count + 1
        mhat = self.mu / (1.0 - _B1 ** c)
        nhat = self.nu / (1.0 - _B2 ** c)
        upd = -self.schedule(self.count) * (
            mhat / (torch.sqrt(nhat) + _EPS) + self.weight_decay * flat)
        self.count = c
        for p, u in zip(self.params, torch.split(
                upd, [p.numel() for p in self.params])):
            p.add_(u.view_as(p))
        return gn


def make_optimizer(model: torch.nn.Module, cfg: SRFDetConfig,
                   total_steps: int) -> FlatAdamW:
    return FlatAdamW(model, cfg, total_steps)


def losses_of(model, batch: Dict[str, torch.Tensor],
              generator: Optional[torch.Generator] = None
              ) -> Dict[str, torch.Tensor]:
    """Forward in train mode and the all-layer OTA losses."""
    cfg = model.cfg
    logits, boxes = model(batch, generator=generator)
    dev = model.device
    return srfdet_losses(
        logits, boxes, torch.as_tensor(batch["gt_boxes"], device=dev),
        torch.as_tensor(batch["gt_labels"], device=dev),
        torch.as_tensor(batch["gt_mask"], device=dev).bool(), cfg.loss,
        cfg.ota, decoder_num_heads=cfg.head.num_heads)


def train_step(model, opt: FlatAdamW, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None
               ) -> Dict[str, torch.Tensor]:
    """One step: forward in train mode, losses, backward, AdamW update.
    Returns the losses, `loss` (their sum) and `grad_norm`."""
    model.train()
    for p in opt.params:
        p.grad = None
    losses = losses_of(model, batch, generator)
    total = sum(losses.values())
    total.backward()
    grad_norm = opt.step()
    metrics = {k: v.detach() for k, v in losses.items()}
    metrics["loss"] = total.detach()
    metrics["grad_norm"] = grad_norm
    return metrics
