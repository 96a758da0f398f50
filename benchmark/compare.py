"""The comparison that decides `correct`: what the window produced against
the plain reference (`benchmark/reference`), run after the window, once
the system's state is freed, on the same inputs and the same seeded
weights.

predict (every pool entry the window served):
  - head_gap: over every head iteration's class logits and box codes of
    the frame, the 99th percentile of |got - ref| / (|ref| + 1).  A
    percentile and not the maximum: a RoI whose level or fallback slot
    flips under float32 rounding moves its own proposal's outputs by a
    large step, and the percentile is what the precision of the arithmetic
    sets.
  - answers_wrong: served answers (boxes, scores, labels, valid) that
    differ from the reference's decode and rotated NMS run on the head
    outputs the system produced for that frame.  The decode follows the
    system's own head outputs, so the head's outputs are held by
    head_gap and the decode by this count; both stages are checked.
  - answers_gap, read beside them and not compared: the served answers
    against the reference's own decode of its own head outputs, end to
    end (served_readings).  At the benchmark's seeded weights few scores
    pass the configs' score_thr, so most frames serve no detection and
    neither the system nor the control gives it a reading to set a
    limit from (PERF.md).

train (the first three steps, which set-up ran through the window's call
and feed, decisions.checked_steps): the reference follows the checked run
one step at a time, each step from the run's own state before it (its
parameters, buffers and Adam state) and with the run's discrete decisions
played back (ReLU masks, RoI levels, bilinear corners and so the patch
fits and fallback slots, box extremes, clips, the OTA assignment;
decisions.py), so that what remains between the two is rounding:
  - loss_gap: the largest |loss - ref| / |ref| of a step's total loss.
  - change_median_gap: over the leaves, the median of the gap between
    the norms of the parameters' change over the three steps, the run's
    and the reference's (its three updates summed), over the larger of
    the reference's norm of that leaf and of the median leaf; leaves
    whose reference gradient is under a thousandth of the median leaf's
    are left out (they move by round-off alone).
  - k3_dw_gap, k4_dw_gap: the first step's weight gradients of the
    sparse convs, K3's and K4's worst call, against the reference's own
    rulebook (probes.py).
  - theta0_gap: the run's parameters before the first step against the
    reference's own, made from the seed (the start, which following the
    run's state would otherwise take on trust); exact.
  - assign_wrong: entries where the reference's OTA, run on the checked
    run's own inputs, assigns otherwise than the checked run did (the
    assignment stage by itself).
  A run whose decisions the reference cannot play back (another batch,
  another number of calls) reads none of them, and fails.  Read beside
  them and not compared: each step's gradient by the worst leaf and the
  median leaf (grad_gap, grad_median_gap, as the optimizer got it), the
  worst leaf's change (change_gap), each step's loss gap, the clip's
  norm, and how many decisions the reference would have taken otherwise
  (flips.<kind>).  At random weights the LiDAR branch's gradient is not
  set by float32 arithmetic: the same seed read twice, or the system
  with its plain versions in float64, moves them by tens of percent
  (PERF.md), so no limit holds them.

Each number has its limit in the cell's limits file; `correct` holds when
every number is at most its limit and every answer came.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from . import port, roofline, weights
from .cells import (INPUT_KEYS, SCHEDULE_STEPS, TRAIN_KEYS,
                    to_device)

ADAM_B1 = 0.9
SMALL_GRAD = 1e-3


def reference(doc: dict, seed: int, dev, tf32: bool = False):
    """(config, detector) of the plain reference with the benchmark's
    seeded weights; TF32 on only for the lower-precision control."""
    from .reference import config as rconfig, set_backend_flags
    from .reference.models.detector import SRFDet
    cfg = port.build_config(rconfig, doc)
    set_backend_flags(tf32)
    with torch.device(dev):
        net = SRFDet(cfg, device=dev)
    net.load_state_dict(weights.seeded_state(net.state_dict(), seed, dev),
                        strict=False)
    return cfg, net


def rel_gap(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    got, ref = got.float().reshape(-1), ref.float().reshape(-1)
    return (got - ref).abs() / (ref.abs() + 1.0)


def decode(cfg, logits, boxes):
    from .reference.models.head import decode_boxes
    t = cfg.test
    return decode_boxes(logits, boxes, use_nms=t.use_nms, nms_thr=t.nms_thr,
                        score_thr=t.score_thr, max_per_img=t.max_per_img,
                        post_center_range=t.post_center_range)


def same_answer(ans: Dict[str, torch.Tensor], dec: Dict[str, torch.Tensor]
                ) -> bool:
    """A served answer against the reference decode of the same head
    outputs: labels and valid flags equal, boxes and scores equal to
    float32 round-off of the decode's own arithmetic."""
    for k in ("labels", "valid"):
        if not torch.equal(ans[k].cpu(), dec[k].cpu()):
            return False
    for k in ("boxes", "scores"):
        a, d = ans[k].cpu().float(), dec[k].cpu().float()
        if a.shape != d.shape or not bool(
                ((a - d).abs() <= 1e-5 * (d.abs() + 1.0)).all()):
            return False
    return True


@torch.no_grad()
def predict_readings(cell, ref_cfg, ref_net, count: bool = False):
    """(readings, {pool entry: (model flops, sparse convs)}) over the
    sampled frames of the window; the flops and convs only with `count`
    (the traced run's MFU and K1 roofline)."""
    from .reference.models.sparse_encoder import GatheredConvBN
    ref_out, per_entry = {}, {}
    for idx in sorted({s[0] for s in cell.sampled} |
                      (set(range(len(cell.pool))) if count else set())):
        batch = to_device(cell.pool[idx], INPUT_KEYS, cell.dev)
        if count:
            tally = roofline.SparseConvTally(ref_net, GatheredConvBN)
            out = []
            flops = roofline.count_flops(lambda: out.append(ref_net(batch)))
            tally.close()
            flops -= roofline.sparse_correction(tally.convs, False)
            per_entry[idx] = (flops, tally.convs)
            ref_out[idx] = out[0]
        else:
            ref_out[idx] = ref_net(batch)
    return served_readings(cell.sampled, ref_out, ref_cfg), per_entry


def nearest_gaps(ans: Dict[str, torch.Tensor], dec: Dict[str, torch.Tensor]
                 ) -> torch.Tensor:
    """For each valid detection of either answer, the gap to the nearest
    detection of the same label in the other: the largest over its box
    fields and score of |a - b| / (|b| + 1), b the reference's (inf where
    the other holds no detection of that label)."""
    def valid(a):
        v = a["valid"].reshape(-1).bool().cpu()
        code = a["boxes"].shape[-1]
        return (a["boxes"].reshape(-1, code).cpu().float()[v],
                a["scores"].reshape(-1).cpu().float()[v],
                a["labels"].reshape(-1).cpu()[v])
    sb, ss, sl = valid(ans)
    rb, rs, rl = valid(dec)
    if not len(sb) and not len(rb):
        return torch.zeros(0)
    box = ((sb[:, None] - rb[None]).abs() / (rb[None].abs() + 1.0)).amax(-1) \
        if len(sb) and len(rb) else torch.zeros(len(sb), len(rb))
    score = (ss[:, None] - rs[None]).abs() / (rs[None].abs() + 1.0)
    gap = torch.where(sl[:, None] == rl[None], torch.maximum(box, score),
                      torch.full_like(score, math.inf))
    inf = torch.tensor([math.inf])
    near_s = gap.amin(1) if len(rb) else inf.expand(len(sb))
    near_r = gap.amin(0) if len(sb) else inf.expand(len(rb))
    return torch.cat([near_s, near_r])


def served_readings(sampled, ref_out, ref_cfg) -> Dict[str, float]:
    """sampled: (pool entry, (head logits, head boxes), served answer) of
    each checked frame; ref_out: the reference's head outputs a pool
    entry.  answers_gap: the 90th percentile over the checked frames'
    detections, served and the reference's own (its decode and NMS of its
    own head outputs), of nearest_gaps: the served answer held against
    the reference from the points to the boxes; a percentile, as a RoI
    or an NMS keep that flips under rounding moves a detection or two by
    a large step."""
    gaps, near = [], []
    wrong = 0
    for idx, (plog, pbox), ans in sampled:
        rlog, rbox = ref_out[idx]
        gaps.append(rel_gap(plog, rlog))
        gaps.append(rel_gap(pbox, rbox))
        wrong += not same_answer(ans, decode(ref_cfg, plog[-1], pbox[-1]))
        near.append(nearest_gaps(ans, decode(ref_cfg, rlog[-1], rbox[-1])))
    if not gaps:
        return {"head_gap": math.inf, "head_gap_max": math.inf,
                "answers_wrong": math.inf, "answers_gap": math.inf,
                "checked": 0.0}
    every = torch.cat(gaps)
    near = torch.cat(near)
    return {"head_gap": float(torch.quantile(every, 0.99)),
            "head_gap_max": float(every.max()),
            "answers_wrong": float(wrong),
            "answers_gap": float(torch.quantile(near.clamp_max(1e30), 0.9))
            if len(near) else 0.0,
            "answers_compared": float(len(near)),
            "checked": float(len(sampled))}


def leaf_norms(flat: torch.Tensor, sizes: List[int]) -> torch.Tensor:
    return torch.stack([t.norm() for t in torch.split(flat.float(), sizes)])


def leaf_gaps(got: torch.Tensor, ref: torch.Tensor,
              keep: torch.Tensor = None) -> torch.Tensor:
    """Each leaf's | |got| - |ref| | over max(|ref|, the median leaf's
    |ref|), over the kept leaves (norms a leaf)."""
    if keep is not None:
        got, ref = got[keep], ref[keep]
    floor = ref.median()
    return (got - ref).abs() / torch.maximum(ref, floor)


def step_grad(run: dict, s: int) -> torch.Tensor:
    """Step s's gradient as the optimizer got it (clipped), from Adam's
    first moment before and after the step."""
    before = run["before"][s]["mu"]
    return (run["mu_after"][s] - ADAM_B1 * before) / (1 - ADAM_B1)


def train_readings(rec: dict, ref_run: dict) -> Dict[str, float]:
    """rec: the checked run's steps (TrainCell.record, or the control's
    reference_steps); ref_run: the reference's, following it
    (reference_steps with `played`)."""
    if not ref_run.get("followed", True):
        return {"playback_failed": 1.0}
    sizes = rec["sizes"]
    out = {}
    loss, grad, median = [], [], []
    for s, (p, r) in enumerate(zip(rec["losses"], ref_run["losses"])):
        loss.append(abs(p["loss"] - r["loss"]) / abs(r["loss"]))
        g_p = leaf_norms(step_grad(rec, s), sizes)
        g_r = leaf_norms(step_grad(ref_run, s), sizes)
        gaps = leaf_gaps(g_p, g_r)
        grad.append(float(gaps.max()))
        median.append(float(gaps.median()))
        out[f"loss_gap.{s}"] = loss[-1]
        out[f"grad_gap.{s}"] = grad[-1]
        out[f"grad_worst_leaf.{s}"] = float(gaps.argmax())
        if s == 0:
            keep = g_r >= SMALL_GRAD * g_r.median()
    d_p = leaf_norms(rec["params_after"][-1] - rec["params_before"][0],
                     sizes)
    d_r = leaf_norms(sum(a - b for a, b in zip(ref_run["params_after"],
                                               rec["params_before"])), sizes)
    change = leaf_gaps(d_p, d_r, keep)
    flips = {}
    for step in ref_run["flips"]:
        for k, v in step.items():
            flips[k] = flips.get(k, 0) + v
    out.update({f"flips.{k}": float(v) for k, v in flips.items()})
    if rec.get("conv_probes"):
        # each kernel's worst call; inf for a kernel the run probed that
        # the reference cannot hold
        for kernel in {c["kernel"] for c in rec["conv_probes"]}:
            got = [g for k, _, g in ref_run["conv_gaps"] if k == kernel]
            out[f"{kernel}_dw_gap"] = max(got) if got else math.inf
    return {"loss_gap": max(loss), "grad_gap": max(grad),
            "change_gap": float(change.max()),
            "theta0_gap": float((ref_run["theta0"] -
                                 rec["params_before"][0]).abs().max()),
            "assign_wrong": float(ref_run["assign_wrong"]),
            "grad_median_gap": max(median),
            "change_median_gap": float(change.median()),
            "grad_norm_gap": max(
                abs(p["grad_norm"] - r["grad_norm"]) / r["grad_norm"]
                for p, r in zip(rec["losses"], ref_run["losses"])),
            "leaves_left_out": float((~keep).sum()), **out}


def reference_steps(doc: dict, seed: int, pool: List[dict], dev,
                    steps: int, played: dict, tf32: bool = False,
                    count: bool = False) -> dict:
    """The reference's first `steps` train steps on pool batches 0, 1, ...
    with the same generators (decisions.checked_steps' record), and its
    own seeded parameters before any step (`theta0`); with `count`, each
    step's model flops (forward and backward, sparse convs by their hits)
    and sparse convs.

    `played`: the checked run's record.  Each step then starts from the
    checked run's state before it and plays back its decisions, which
    float32 rounding of the forward flips (decisions.py); if they cannot
    be played back (another batch, another number of calls) the record
    says `followed` False.  The assignment stage is held by itself: the
    reference's OTA on the checked run's own inputs must give the
    checked run's assignment (`assign_wrong` counts the entries that
    differ).  Without `played` (the control in the system's place) the
    steps run on their own from the seeded parameters."""
    from . import probes
    from .decisions import PlaybackError, checked_steps, modules_of
    from .reference.models import losses as rlosses
    from .reference.models.sparse_encoder import GatheredConvBN
    from .reference.train import trainer
    cfg, net = reference(doc, seed, dev, tf32)
    opt = trainer.make_optimizer(net, cfg, SCHEDULE_STEPS)
    theta0 = torch.cat([p.detach().reshape(-1) for p in opt.params]).cpu()
    flops, convs = [], []

    gaps = []

    def step(s):
        batch = to_device(pool[s % len(pool)], TRAIN_KEYS, dev)
        gen = trainer.step_generator(net, seed, s)
        if s == 0 and played is not None and played.get("conv_probes"):
            tap = probes.RulebookTap(net, GatheredConvBN)
            try:
                res = counted(batch, gen) if count else \
                    trainer.train_step(net, opt, batch, gen)
            finally:
                tap.close()
            gaps.extend(probes.conv_gaps(played["conv_probes"], tap.books))
            return res
        if not count:
            return trainer.train_step(net, opt, batch, gen)
        return counted(batch, gen)

    def counted(batch, gen):
        tally = roofline.SparseConvTally(net, GatheredConvBN)
        got = []
        f = roofline.count_flops(lambda: got.append(
            trainer.train_step(net, opt, batch, gen)))
        tally.close()
        trained = any(c.kernel.requires_grad for c in net.modules()
                      if isinstance(c, GatheredConvBN))
        flops.append(f - roofline.sparse_correction(tally.convs, trained))
        convs.append(tally.convs)
        return got[0]

    wrong = 0
    if played is not None:
        for calls, matched in zip(played["ota_args"], played["decisions"]):
            for a, m in zip(calls, matched["ota"]):
                args = [x.to(dev) if torch.is_tensor(x) else x for x in a]
                args[-2] = args[-2].cpu()   # head indices stay on the host
                args[-1] = cfg.ota
                wrong += int((rlosses.ota_assign_batch(*args).cpu() != m)
                             .sum())
    try:
        out = checked_steps(net, opt, step,
                            modules_of(__package__ + ".reference"), steps,
                            follow=played)
        out["followed"] = True
    except PlaybackError as err:
        out = {"followed": False, "why": str(err)}
    out["conv_gaps"] = gaps
    out["theta0"] = theta0
    out["assign_wrong"] = wrong
    out["flops"], out["convs"] = flops, convs
    return out


def judge(readings: Dict[str, float], limits: Dict[str, float]):
    """(correct, [(name, reading, limit)]) over the numbers the limits
    file names; a number that is not finite, or not read, fails."""
    rows = []
    ok = True
    for name, limit in limits.items():
        val = readings.get(name, math.inf)
        rows.append((name, val, limit))
        if not (math.isfinite(val) and val <= limit):
            ok = False
    return ok, rows
