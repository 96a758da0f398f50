"""The train cell's checked steps: each step's discrete decisions recorded
on one side and played back on the other, and each step started from the
checked run's own state.

A train step takes discrete decisions whose side a float32 rounding of
the forward can change: each ReLU's mask (F.relu), each RoI's FPN level
(roi_align._level_geometry), each bilinear sample's corner cell and
out-of-map flag along each axis (roi_align._axis_corners, which also
decides which RoIs fit their patch and which take a fallback slot), the
OTA matches (losses.ota_assign_batch), which box corners bound each BEV
RoI (head.lidar_rois_from_boxes) and which refined centres and sizes are
clipped (SingleSRFDetHead.apply_deltas).  At random weights a rounding
flips some of them, and one flip moves the step's gradients by percents
(a ReLU input within a rounding of zero carries its element's whole
gradient).  So the run checked (the system, or the control in its place)
records its decisions, in call order, and the reference plays them back:
what remains between the two is rounding.  The same recorder serves both
sides: `Modules` names the side's own modules, which share these
functions' names (the reference is a frozen copy of the system's).
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict, List, NamedTuple, Optional

import torch
import torch.nn.functional as F

KINDS = ("level", "corners", "ota", "relu", "extreme", "clip")


class PlaybackError(RuntimeError):
    """The run followed took decisions that this one cannot take: another
    number of calls, or another shape (another batch, another model)."""


class Modules(NamedTuple):
    """The modules of one side whose functions take the decisions."""
    roi_align: object
    losses: object
    head: object
    boxes: object


def modules_of(package: str) -> Modules:
    """`srfdet3d_torch` (the system) or `benchmark.reference`."""
    def mod(name):
        return importlib.import_module(f"{package}.{name}")
    return Modules(mod("ops.roi_align"), mod("models.losses"),
                   mod("models.head"), mod("geometry.boxes"))


class Decisions:
    """While open, the step's decisions are recorded (`calls`, on the
    device until take()); with `replay` ({kind: [tensor a call]}) each
    call takes the recorded branch instead of its own.  The OTA calls'
    inputs are kept too (`ota_args`, on the host), so that the
    assignment stage can be held by itself."""

    def __init__(self, mods: Modules, replay: Optional[Dict] = None):
        self.m = mods
        head_cls = mods.head.SingleSRFDetHead
        self.orig = (mods.roi_align._level_geometry,
                     mods.roi_align._axis_corners,
                     mods.losses.ota_assign_batch, F.relu,
                     mods.head.lidar_rois_from_boxes,
                     head_cls.apply_deltas)
        self.replay = {k: list(replay[k]) for k in KINDS} if replay else None
        self.calls: Dict[str, List[torch.Tensor]] = {k: [] for k in KINDS}
        # decisions played back against this side's own, by kind (device)
        self.flips: Dict[str, torch.Tensor] = {}
        self.ota_args: List[list] = []
        mods.roi_align._level_geometry = self._level
        mods.roi_align._axis_corners = self._corners
        mods.losses.ota_assign_batch = self._ota
        F.relu = self._relu
        mods.head.lidar_rois_from_boxes = self._rois
        head_cls.apply_deltas = \
            lambda mod, d, b: self._apply_deltas(mod, d, b)

    def close(self) -> None:
        m = self.m
        (m.roi_align._level_geometry, m.roi_align._axis_corners,
         m.losses.ota_assign_batch, F.relu, m.head.lidar_rois_from_boxes,
         m.head.SingleSRFDetHead.apply_deltas) = self.orig

    def played_out(self) -> None:
        """Raises unless every recorded call was played back."""
        if self.replay is not None:
            left = {k: len(v) for k, v in self.replay.items() if v}
            if left:
                raise PlaybackError(f"decisions left unplayed: {left}")

    def _next(self, kind, own):
        """This side's own decision `own` recorded; the one played back in
        its place (None when not playing back)."""
        self.calls[kind].append(own)
        if self.replay is None:
            return None
        if not self.replay[kind]:
            raise PlaybackError(f"no {kind} decision left to play back")
        rec = self.replay[kind].pop(0).to(own.device)
        if rec.shape != own.shape:
            raise PlaybackError(f"{kind}: {tuple(rec.shape)} played back "
                                f"where {tuple(own.shape)} is taken")
        self.flips[kind] = self.flips.get(kind, 0) + (rec != own).sum()
        return rec

    def flip_counts(self) -> Dict[str, int]:
        return {k: int(v) for k, v in self.flips.items()}

    def _level(self, shapes, rois, strides, finest_scale):
        out = self.orig[0](shapes, rois, strides, finest_scale)
        lvl = self._next("level", out[0].detach().clone())
        if lvl is None:
            return out
        # the level's scale, extent and row offset, as _level_geometry
        # computes them
        dev = rois.device
        sizes = [h * w for h, w in shapes]
        hs = torch.tensor([float(h) for h, _ in shapes], device=dev)
        ws = torch.tensor([float(w) for _, w in shapes], device=dev)
        scales = torch.tensor([1.0 / s for s in strides],
                              dtype=torch.float32, device=dev)
        offsets = torch.tensor([sum(sizes[:i]) for i in range(len(shapes))],
                               device=dev)
        return lvl, scales[lvl], hs[lvl], ws[lvl], offsets[lvl]

    def _corners(self, pos, size):
        out = self.orig[1](pos, size)
        rec = self._next("corners", torch.stack(
            [out[0], out[4].long()]).to(torch.int32))
        if rec is None:
            return out
        # the recorded cell and flag, the weights linear in pos about that
        # cell, as _axis_corners computes them
        size = size[:, None]
        c0, oob = rec[0].float(), rec[1].bool()
        lc = torch.minimum(pos.clamp_min(0.0), size - 1.0) - c0
        c1 = torch.minimum(c0 + 1, size - 1.0)
        edge = c0 >= size - 1.0
        w0 = torch.where(oob, 0.0, torch.where(edge, 1.0, 1.0 - lc))
        w1 = torch.where(oob, 0.0, torch.where(edge, 0.0, lc))
        return c0.long(), c1.long(), w0, w1, oob

    def _ota(self, *args, **kwargs):
        out = self.orig[2](*args, **kwargs)
        self.ota_args.append([x.detach().cpu() if torch.is_tensor(x) else x
                              for x in args])
        rec = self._next("ota", out.detach().clone())
        return out if rec is None else rec

    def _relu(self, x, inplace=False):
        rec = self._next("relu", x > 0)
        if rec is None:
            return self.orig[3](x, inplace)
        return torch.where(rec, x, 0.0)

    def _rois(self, boxes_abs, pc_range, voxel_size):
        """lidar_rois_from_boxes, its extreme corners recorded (and played
        back through a gather)."""
        corners = self.m.boxes.boxes3d_to_corners3d(
            boxes_abs[..., :8], bottom_center=False, yaw_as_sincos=True,
            log_size=True)
        lo = boxes_abs.new_tensor(pc_range[:2])
        vs = boxes_abs.new_tensor(voxel_size[:2])
        xy = (corners[..., :2] - lo) / vs
        rec = self._next("extreme", torch.stack(
            [xy.argmin(-2), xy.argmax(-2)]).to(torch.int8))
        if rec is None:
            return self.orig[4](boxes_abs, pc_range, voxel_size)
        pick = [xy.gather(-2, i.long().unsqueeze(-2)).squeeze(-2)
                for i in rec]
        return torch.cat(pick, -1)

    def _apply_deltas(self, mod, d, b):
        """SingleSRFDetHead.apply_deltas, its clipped centres and sizes
        recorded (and played back)."""
        d, b = d.float(), b.float()
        lo = b.new_tensor(mod.pc_range[:3])
        hi = b.new_tensor(mod.pc_range[3:6])
        raw = (b[..., 0:3] + d[..., 0:3] * torch.exp(b[..., 3:6]) - lo) / \
            (hi - lo)
        size = d[..., 3:6]
        rec = self._next("clip", torch.stack(
            [raw < 0.0, raw > 1.0, size > mod.scale_clamp]))
        if rec is None:
            return self.orig[5](mod, d, b)
        low, high, big = rec
        ctr = torch.where(low, 0.0, torch.where(high, 1.0, raw))
        new_sizes = b[..., 3:6] + torch.where(big, mod.scale_clamp, size)
        return torch.cat([ctr, new_sizes, d[..., 6:]], -1)

    def take(self) -> Dict[str, List[torch.Tensor]]:
        """The calls recorded, on the host."""
        return {k: [t.cpu() for t in v] for k, v in self.calls.items()}


def flat(params) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1) for p in params])


def checked_steps(net, opt, step: Callable[[int], Dict], mods: Modules,
                  steps: int, follow: Optional[dict] = None) -> dict:
    """`steps` train steps, `step(s)` running step s (the caller's call and
    feed, which returns the step's losses).  Kept on the host, a step:
    the state before it (parameters and buffers, Adam's moments and
    count), the flat trainable parameters before and after, Adam's first
    moment after (the gradient as the optimizer gets it, with the moment
    before), the losses, the decisions and the OTA inputs.

    `follow`: another run's record.  Each step then starts from that
    run's state before the step and plays back its decisions, so that
    the step's losses, gradient and update are held against that run's
    one step at a time; its states and decisions are not copied again.
    """
    rec = {"sizes": [p.numel() for p in opt.params],
           "names": [n for n, p in net.named_parameters()
                     if any(p is q for q in opt.params)], "before": [],
           "params_before": [], "params_after": [], "mu_after": [],
           "losses": [], "decisions": [], "ota_args": [], "flips": []}
    for s in range(steps):
        if follow is not None:
            load_state(net, opt, follow["before"][s])
            rec["before"].append(follow["before"][s])
        else:
            rec["before"].append(
                dict(state={k: v.detach().cpu().clone()
                            for k, v in net.state_dict().items()},
                     mu=opt.mu.cpu().clone(), nu=opt.nu.cpu().clone(),
                     count=opt.count))
        rec["params_before"].append(flat(opt.params).cpu())
        dec = Decisions(mods, None if follow is None else
                        follow["decisions"][s])
        try:
            out = step(s)
            dec.played_out()
        finally:
            dec.close()
        rec["losses"].append({k: float(v) for k, v in out.items()})
        rec["params_after"].append(flat(opt.params).cpu())
        rec["mu_after"].append(opt.mu.cpu().clone())
        if follow is None:
            rec["decisions"].append(dec.take())
        rec["flips"].append(dec.flip_counts())
        rec["ota_args"].append(dec.ota_args)
        del dec
    return rec


def load_state(net, opt, before: dict) -> None:
    """A model and its optimizer at a state checked_steps kept."""
    net.load_state_dict(before["state"])
    opt.mu.copy_(before["mu"])
    opt.nu.copy_(before["nu"])
    opt.count = before["count"]
