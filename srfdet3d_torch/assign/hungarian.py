"""One-to-one (Hungarian) assignment, the secondary assigner: a port of the
JAX package's `assign/hungarian.py` (reference HungarianAssignerSRFDet,
hungarian_assigner_srfdet.py:15-127).

The cost is FocalLossCost + BBox3DL1Cost over normalize_bbox.  Two solvers:

  - `hungarian`: scipy's `linear_sum_assignment` on the host, as the JAX
    package and the reference do (hungarian_assigner_srfdet.py:109-118), so
    ties break as theirs do.  All problems of a step (layers x samples)
    cross to the host in one copy.
  - `auction`: Bertsekas' auction on the device, batched over the
    problems, round for round the JAX package's `while_loop`: the best
    column is the first maximum (`argmax`, as `lax.top_k` puts the lower
    index first), the runner-up the maximum over the other columns, and a
    pred's highest bid wins with ties to the lowest GT.  A round in which no
    GT bids changes nothing, so the rounds run in chunks of
    `AUCTION_CHUNK` between host checks, and stop at `max_rounds` exactly.
    A greedy pass in GT order then gives every valid GT still unassigned
    its best free pred.

Counters (`utils.profiling`): `hungarian.solves`, the scipy solves;
`hungarian.copy_ms` and `hungarian.host_ms`, the milliseconds of their
copy to the host (which waits for the work queued before it) and of the
solves themselves; `hungarian.auctions`, `hungarian.rounds` and
`hungarian.exhausted`, the auctions, their rounds and the budgets they
spent; `host_sync`, each read of a device value on the host.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..geometry.boxes import normalize_bbox
from ..ops.focal_loss import focal_loss_cost
from ..utils import profiling

AUCTION_CHUNK = 16
_BIG_NEG = -1e9


def _lsa_host(cost: np.ndarray, n_valid: int) -> np.ndarray:
    """Solve one (n_p, G) problem on its first n_valid columns: (n_p,)
    int64 matched GT per pred, -1 where unmatched."""
    from scipy.optimize import linear_sum_assignment
    out = np.full((cost.shape[0],), -1, np.int64)
    if n_valid > 0:
        rows, cols = linear_sum_assignment(cost[:, :n_valid])
        out[rows] = cols
    return out


def _assigned(owner: torch.Tensor, g: int) -> torch.Tensor:
    """(N, n_p) owners -> (N, G) bool: does some pred belong to the GT?"""
    hit = torch.zeros(owner.shape[0], g + 1, dtype=torch.bool,
                      device=owner.device)
    hit.scatter_(1, torch.where(owner >= 0, owner, g), True)
    return hit[:, :g]


@torch.no_grad()
def auction_assign(cost: torch.Tensor, gt_mask: torch.Tensor,
                   eps: float = 1e-3, max_rounds: int = 5000
                   ) -> torch.Tensor:
    """cost (..., n_p, G), gt_mask (..., G) -> matched GT per pred
    (..., n_p) int64, -1 where unmatched.  The total cost is within G*eps
    of the optimum when the budget suffices."""
    lead = cost.shape[:-2]
    n_p, g = cost.shape[-2:]
    cost = cost.reshape(-1, n_p, g).float()
    mask = gt_mask.reshape(-1, g).bool()
    n, dev = cost.shape[0], cost.device
    benefit = torch.where(mask[..., None], -cost.transpose(1, 2), _BIG_NEG)
    wide = benefit if n_p >= 2 else torch.cat(
        [benefit, benefit.new_full((n, g, 2 - n_p), _BIG_NEG)], -1)
    cols = wide.shape[-1]
    prices = cost.new_zeros(n, n_p)
    owner = torch.full((n, n_p), -1, dtype=torch.int64, device=dev)
    gt_ids = torch.arange(g, device=dev).expand(n, g)
    rounds = torch.zeros((), dtype=torch.int64, device=dev)
    done = 0
    while done < max_rounds:
        for _ in range(min(AUCTION_CHUNK, max_rounds - done)):
            bidder = mask & ~_assigned(owner, g)                # (N, G)
            rounds += bidder.any()
            values = wide - torch.cat(
                [prices, prices.new_zeros(n, cols - n_p)], -1)[:, None]
            best_pred = values.argmax(-1)                       # (N, G)
            top = values.gather(-1, best_pred[..., None])[..., 0]
            runner = values.scatter(-1, best_pred[..., None],
                                    float("-inf")).amax(-1)
            # only a non-bidder's best can be the padded column
            at = best_pred.clamp_max(n_p - 1)
            bid = prices.gather(1, at) + (top - runner) + eps
            bid = torch.where(bidder, bid, _BIG_NEG)
            best_bid = prices.new_full((n, cols), _BIG_NEG).scatter_reduce(
                1, best_pred, bid, "amax")[:, :n_p]
            wins = bidder & (bid >= best_bid.gather(1, at) - 1e-12)
            winner = torch.full((n, n_p + 1), g, dtype=torch.int64,
                                device=dev).scatter_reduce(
                1, torch.where(wins, best_pred, n_p), gt_ids,
                "amin")[:, :n_p]
            won = winner < g
            owner = torch.where(won, winner, owner)
            prices = torch.where(won, torch.maximum(prices, best_bid),
                                 prices)
        done += min(AUCTION_CHUNK, max_rounds - done)
        profiling.count("host_sync")
        if not bool((mask & ~_assigned(owner, g)).any()):
            break
    profiling.count("hungarian.auctions")
    profiling.count("hungarian.rounds", int(rounds))
    left = mask & ~_assigned(owner, g)
    profiling.count("host_sync", 2)
    if bool(left.any()):
        profiling.count("hungarian.exhausted")
        # greedy completion: each valid GT still unassigned, in GT order,
        # takes its best free pred
        rows = torch.arange(n, device=dev)
        for gi in range(g):
            free = owner < 0
            p = torch.where(free, benefit[:, gi], _BIG_NEG).argmax(-1)
            take = mask[:, gi] & ~_assigned(owner, g)[:, gi] & free[rows, p]
            owner[rows[take], p[take]] = gi
    return owner.reshape(lead + (n_p,))


def matching_cost(pred_boxes: torch.Tensor, pred_logits: torch.Tensor,
                  gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                  cls_weight: float = 2.0, reg_weight: float = 0.25
                  ) -> torch.Tensor:
    """FocalLossCost + BBox3DL1Cost (reference
    hungarian_assigner_srfdet.py:85-105) on detached inputs: pred_boxes
    (..., n_p, >=8) normalized code, pred_logits (..., n_p, C), gt_boxes
    (..., G, 7|9) raw -> (..., n_p, G)."""
    pred_boxes = pred_boxes.detach().float()
    pred_logits = pred_logits.detach().float()
    cls_cost = focal_loss_cost(pred_logits, gt_labels, weight=cls_weight,
                               eps=1e-12)
    gt_norm = normalize_bbox(gt_boxes[..., :7].float())
    reg_cost = reg_weight * (pred_boxes[..., :, None, :8] -
                             gt_norm[..., None, :, :]).abs().sum(-1)
    return cls_cost + reg_cost


def _scipy_assign(cost: torch.Tensor, gt_mask: torch.Tensor
                  ) -> torch.Tensor:
    """Every problem of the leading dims on the host, in one copy each
    way.  Valid GTs must come first."""
    t0 = time.perf_counter()
    n_p, g = cost.shape[-2:]
    both = torch.cat([cost.reshape(-1, n_p * g).float(),
                      gt_mask.reshape(-1, g).sum(-1, keepdim=True).float()],
                     1).cpu().numpy()
    t1 = time.perf_counter()
    host = both[:, :-1].reshape(-1, n_p, g)
    out = np.stack([_lsa_host(c, int(v)) for c, v in zip(host, both[:, -1])])
    t2 = time.perf_counter()
    profiling.count("hungarian.copy_ms", (t1 - t0) * 1e3)
    profiling.count("hungarian.host_ms", (t2 - t1) * 1e3)
    profiling.count("hungarian.solves", len(host))
    # the copy to the host, and the answer's copy back from pageable memory
    profiling.count("host_sync", 2)
    return torch.from_numpy(out).to(cost.device).reshape(
        cost.shape[:-1])


def hungarian_assign(pred_boxes: torch.Tensor, pred_logits: torch.Tensor,
                     gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
                     gt_mask: torch.Tensor, cls_weight: float = 2.0,
                     reg_weight: float = 0.25, on_device: bool = False
                     ) -> torch.Tensor:
    """Any number of leading problem dims: pred_boxes (..., n_p, >=8)
    normalized code, gt_boxes (..., G, 7|9) raw -> matched GT per pred
    (..., n_p) int64, -1 = unmatched.  on_device: the auction (any GT
    layout); else scipy on the host (valid GTs packed first)."""
    cost = matching_cost(pred_boxes, pred_logits, gt_boxes, gt_labels,
                         cls_weight, reg_weight)
    if on_device:
        return auction_assign(cost, gt_mask)
    return _scipy_assign(cost, gt_mask)
