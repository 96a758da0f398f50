"""The train step: OTA losses, backward, grad clip and a flat AdamW with a
warmup-cosine schedule (a port of the JAX package's `train/trainer.py`;
reference AdamW lr 2e-4, wd 0.01, grad clip 35, cfg
srfdet_voxel_nusc_L.py:337-353).

    opt = make_optimizer(model, cfg, total_steps)
    metrics = train_step(model, opt, batch, step_generator(model, seed, step))
    out = eval_step(model, batch)

`batch` holds points, points_mask, gt_boxes (B, G, 7|9), gt_labels (B, G)
and gt_mask (B, G), and for an LC model images and lidar2img.  The
freeze rules (`freeze_mask`: freeze_lidar, freeze_img, the image
backbone's frozen_stages and norm_frozen) take effect when the optimizer
is made.  The JAX package splits the step into a grad program
and an apply program to work around XLA; eager PyTorch needs no split.
With `optim.accum_steps` = a > 1 the step runs a strided microbatches
(rows i, a+i, 2a+i, ...), as JAX's `_grads_accum`: each normalizes its
losses by its own positives, BN running statistics update once a
microbatch (chained, like consecutive steps), the grads are summed and
then divided by a, the reported losses are the microbatches' means, and
one AdamW update follows.

Under a process group (`parallel.mesh`, the JAX package's `mesh=` step)
each rank passes its rows of the global batch (`shard_rows`).  The
BatchNorms' statistics and the losses' normalizers span every rank; the
microbatches split the LOCAL batch strided, which makes microbatch i the
global batch's rows i, a+i, ... as in one process; the grads are summed
over the ranks once a step, after the microbatches (a sum: each rank's
loss already divides by the global positives), and the clip's norm is
taken after that sum; the reported losses are summed over the ranks.
Every rank then runs the same AdamW update on the same grads, so the
ranks' parameters stay bit-identical.  The step's generator folds in the
rank (`step_generator`), so dropout and GridMask masks differ across
ranks, as the JAX step folds in the replica index.

On a 2-D mesh (`mesh.make_mesh_2d`) "the ranks" above are the data
group, and the generator folds in the data index: the model ranks of one
data shard draw the same masks.  Inside `mesh.proposal_sharding` the head
runs its block of proposals on each model rank, and the grads are summed
over the whole world (the `parallel.mesh` docstring's gradient argument);
when the proposals do not divide by the model axis, over the data group.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import OptimConfig, SRFDetConfig
from ..models.detector import LIDAR_MODULES, to_device
from ..models.losses import srfdet_losses
from ..parallel import mesh
from ..utils import profiling

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


def frozen_branches(model: torch.nn.Module, cfg: SRFDetConfig
                    ) -> Tuple[str, ...]:
    """The top modules frozen whole: the LiDAR branch under freeze_lidar
    (reference freeze_lidar_components, tools/train.py:221-276), the image
    backbone under freeze_img (srfdet.py:83-89; its neck still trains)."""
    names = []
    if cfg.optim.freeze_lidar:
        names += [m for m in LIDAR_MODULES if hasattr(model, m)]
    if cfg.optim.freeze_img and hasattr(model, "img_backbone"):
        names.append("img_backbone")
    return tuple(names)


def freeze_mask(model: torch.nn.Module, cfg: SRFDetConfig
                ) -> Dict[str, bool]:
    """Parameter name -> trainable (JAX `train/trainer.py::freeze_mask`):
    frozen_branches; then, unless freeze_img, `cfg.img.frozen_stages` = N
    freezes the image backbone's stem and its first N stages (the
    backbone's `frozen_stage_modules`); `cfg.img.norm_frozen` freezes
    every BN scale and bias of the image backbone."""
    frozen = [f"{m}." for m in frozen_branches(model, cfg)]
    bn = set()
    backbone = getattr(model, "img_backbone", None)
    if backbone is not None:
        if not cfg.optim.freeze_img:
            frozen += [f"img_backbone.{m}." for m in
                       backbone.frozen_stage_modules(cfg.img.frozen_stages)]
        if cfg.img.norm_frozen:
            bn = {f"img_backbone.{n}.{leaf}"
                  for n, mod in backbone.named_modules()
                  if isinstance(mod, torch.nn.BatchNorm2d)
                  for leaf in ("weight", "bias")}
    frozen = tuple(frozen)
    return {name: not (name.startswith(frozen) or name in bn)
            for name, _ in model.named_parameters()}


class FlatAdamW:
    """Global-norm clip + AdamW over the trainable parameters as one flat
    vector (JAX `make_optimizer`).  Its moments are two flat buffers; the
    step count lives on the host.

    As in the JAX update: the clip is optax's select with no epsilon
    (g * clip / |g| when |g| >= clip), the schedule is read at the count
    BEFORE the increment, and decoupled weight decay applies to every
    trainable leaf.  Frozen parameters (freeze_mask) are not in the vector:
    their grads enter neither the norm nor an update.  The constructor
    sets requires_grad=False on them, so autograd computes no grad for
    them and none for the graph below a frozen stem and frozen stages;
    JAX computes those grads, reports their norm in its `grad_norm`, then
    zeroes them.  The port's `grad_norm` is the clip's norm, over the
    trainable grads (ROADMAP Queue 3, fault 7)."""

    def __init__(self, model: torch.nn.Module, cfg: SRFDetConfig,
                 total_steps: int):
        mask = freeze_mask(model, cfg)
        for name, p in model.named_parameters():
            p.requires_grad_(mask[name])
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
    with profiling.span("forward"):
        logits, boxes = model(batch, generator=generator)
    dev = model.device
    with profiling.span("loss_ota"):
        return srfdet_losses(
            logits, boxes, to_device(batch["gt_boxes"], dev),
            to_device(batch["gt_labels"], dev),
            to_device(batch["gt_mask"], dev).bool(), cfg.loss, cfg.ota,
            decoder_num_heads=cfg.head.num_heads)


def _frozen_stats(model) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """(buffer, copy) of the BN statistics of every frozen branch that
    runs in train mode: the image backbone under freeze_img without
    norm_eval.  JAX restores them after the step (trainer.py:311-329);
    the LiDAR branch under freeze_lidar, and the backbone under norm_eval,
    run in eval mode and leave theirs untouched."""
    return [(b, b.clone()) for name in frozen_branches(model, model.cfg)
            if getattr(model, name).training
            for b in getattr(model, name).buffers()]


def step_generator(model, seed: int, step: int) -> torch.Generator:
    """The generator of train step `step` of a run seeded `seed`, on the
    model's device: seeded from (seed, step) alone, as JAX folds the host
    step into its base key, so a resumed run draws what an uninterrupted
    one draws; under a process group from (seed, step, data index), as
    the JAX step folds in the replica index (`trainer.py:367`): the
    model ranks of one data shard draw the same masks."""
    key = (seed, step, mesh.data_index()) if mesh.active() else (seed, step)
    words = np.random.SeedSequence(key).generate_state(2, np.uint32)
    g = torch.Generator(device=model.device)
    g.manual_seed((int(words[0]) << 31) | (int(words[1]) >> 1))
    return g


def _microbatches(batch: Dict[str, torch.Tensor], accum: int
                  ) -> List[Dict[str, torch.Tensor]]:
    """Strided split of the batch axis: microbatch i takes rows i, a+i, ..."""
    out = [{} for _ in range(accum)]
    for k, v in batch.items():
        v = torch.as_tensor(v)
        if v.shape[0] % accum:
            raise ValueError(f"batch dim {v.shape[0]} not divisible by "
                             f"accum_steps={accum}")
        for i in range(accum):
            out[i][k] = v[i::accum]
    return out


@profiling.span("train_step")
def train_step(model, opt: FlatAdamW, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None
               ) -> Dict[str, torch.Tensor]:
    """One step: forward in train mode, losses, backward, AdamW update.
    Returns the losses, `loss` (their sum) and `grad_norm` (the clip's,
    over the trainable grads).  `generator` draws GridMask's and the
    head's dropout masks (the microbatches draw from it in turn)."""
    model.train()
    for p in opt.params:
        p.grad = None
    keep = _frozen_stats(model)
    accum = max(int(model.cfg.optim.accum_steps), 1)
    parts = [batch] if accum == 1 else _microbatches(batch, accum)
    sums: Dict[str, torch.Tensor] = {}
    for mb in parts:
        losses = losses_of(model, mb, generator)
        total = sum(losses.values())
        with profiling.span("backward"):
            total.backward()
        losses["loss"] = total
        for k, v in losses.items():
            sums[k] = v.detach() if k not in sums else sums[k] + v.detach()
    mesh.all_reduce_grads(opt.params)
    with torch.no_grad():
        for buf, saved in keep:
            buf.copy_(saved)
        if accum > 1:
            for p in opt.params:
                if p.grad is not None:
                    p.grad.div_(accum)
    with profiling.span("optimizer"):
        grad_norm = opt.step()
    if mesh.active():
        keys = sorted(sums)
        summed = mesh.sum_if_sync(torch.stack([sums[k] for k in keys]))
        sums = dict(zip(keys, summed))
    metrics = {k: v / accum if accum > 1 else v for k, v in sums.items()}
    metrics["grad_norm"] = grad_norm
    return metrics


@torch.no_grad()
def eval_step(model, batch: Dict[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
    """Predict in eval mode (JAX `make_eval_step`): decoded boxes, scores,
    labels and valid of every frame."""
    model.eval()
    return model.predict(batch)
