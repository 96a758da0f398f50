"""PyTorch port vs JAX package: the one-to-one assigners.

`matching_cost` within rtol 1e-5; the scipy path's assignment exactly equal
to JAX `hungarian_assign` (valid GTs packed first; 0, 1 and many valid
GTs); the auction exactly equal to JAX `auction_assign` on seeded costs,
batched over problems as the losses batch them (padded GTs, one pred
column, an exhausted budget), and its total cost within G * eps of
scipy's; `srfdet_losses` with each assigner within rtol 1e-5 of JAX's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from srfdet3d_tpu.assign import OTAConfig as JOTAConfig
from srfdet3d_tpu.assign.hungarian import auction_assign as j_auction
from srfdet3d_tpu.assign.hungarian import hungarian_assign as j_hungarian
from srfdet3d_tpu.assign.hungarian import matching_cost as j_cost
from srfdet3d_tpu.models.losses import LossConfig as JLossConfig
from srfdet3d_tpu.models.losses import srfdet_losses as j_losses
from srfdet3d_torch.assign.hungarian import (auction_assign,
                                             hungarian_assign, matching_cost)
from srfdet3d_torch.config import LossConfig, OTAConfig
from srfdet3d_torch.models.losses import srfdet_losses
from srfdet3d_torch.utils import profiling

T = torch.from_numpy


def _outputs(rng, layers=2, b=2, n_p=16, ncls=3, g=4, n_valid=2):
    """tests/test_hungarian_loss.py's scene: predicted codes with absolute
    centers, raw GTs, the first n_valid GTs valid."""
    logits = rng.normal(-2, 1, (layers, b, n_p, ncls)).astype(np.float32)
    boxes = np.zeros((layers, b, n_p, 10), np.float32)
    boxes[..., 0:2] = rng.uniform(-8, 8, (layers, b, n_p, 2))
    boxes[..., 2] = rng.uniform(-2, 0, (layers, b, n_p))
    boxes[..., 3:6] = np.log(rng.uniform(0.5, 3, (layers, b, n_p, 3)))
    yaw = rng.uniform(-np.pi, np.pi, (layers, b, n_p))
    boxes[..., 6], boxes[..., 7] = np.sin(yaw), np.cos(yaw)
    gt = np.zeros((b, g, 9), np.float32)
    gt[..., 0:2] = rng.uniform(-8, 8, (b, g, 2))
    gt[..., 3:6] = rng.uniform(0.5, 3, (b, g, 3))
    labels = rng.integers(0, ncls, (b, g)).astype(np.int32)
    mask = np.zeros((b, g), bool)
    mask[:, :n_valid] = True
    return logits, boxes, gt, labels, mask


def test_matching_cost_matches_jax():
    logits, boxes, gt, labels, _ = _outputs(np.random.default_rng(0), g=6)
    ref = jax.jit(jax.vmap(jax.vmap(
        lambda pb, pl, gb, gl: j_cost(pb, pl, gb, gl, 2.0, 0.25)),
        in_axes=(0, 0, None, None)))(boxes, logits, gt, labels)
    got = matching_cost(T(boxes), T(logits), T(gt)[None].expand(2, -1, -1, -1),
                        T(labels)[None].expand(2, -1, -1), 2.0, 0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("n_valid", [0, 1, 7])
def test_scipy_assignment_equals_jax(n_valid):
    """Exactly JAX's matches, samples with 0, 1 and 7 of 8 GTs valid
    (packed first), every layer and sample in one host round trip."""
    logits, boxes, gt, labels, mask = _outputs(
        np.random.default_rng(10 + n_valid), layers=3, b=2, n_p=12, g=8,
        n_valid=n_valid)
    ref = np.stack([np.asarray(jax.vmap(
        lambda pb, pl, gb, gl, gm: j_hungarian(pb, pl, gb, gl, gm, 2.0, 0.25)
    )(boxes[l], logits[l], gt, labels, mask)) for l in range(3)])
    lead = (3, 2)
    profiling.reset()
    got = hungarian_assign(
        T(boxes), T(logits), T(gt).expand(lead + gt.shape[1:]),
        T(labels).expand(lead + labels.shape[1:]),
        T(mask).expand(lead + mask.shape[1:]), 2.0, 0.25)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert profiling.snapshot()["hungarian.solves"] == 6
    assert int((got >= 0).sum()) == 6 * n_valid


def _auction_cases():
    """(name, cost (N, n_p, G), mask (N, G), max_rounds): seeded uniform
    costs (test_auction.py's sizes) batched four problems at a time, with
    padded GTs, one pred column and a budget too small for near-ties."""
    out = []
    for seed, n_p, g in ((0, 50, 8), (1, 120, 20), (2, 30, 30)):
        rng = np.random.default_rng(seed)
        cost = rng.uniform(0, 10, (4, n_p, g)).astype(np.float32)
        mask = np.ones((4, g), bool)
        mask[1, g // 2:] = False                      # padded, packed
        mask[2, ::3] = False                          # padded, not packed
        out.append((f"uniform_{n_p}x{g}", cost, mask, 5000))
    rng = np.random.default_rng(3)
    cost = rng.uniform(0, 5, (2, 40, 10)).astype(np.float32)
    mask = np.zeros((2, 10), bool)
    mask[:, :4] = True
    out.append(("padded", cost, mask, 5000))
    out.append(("one_column", np.array([[[3.0, 1.0, 2.0]],
                                        [[0.5, 2.0, 9.0]]], np.float32),
                np.array([[True, True, True], [True, False, True]]), 5000))
    rng = np.random.default_rng(7)
    base = rng.uniform(0, 1e-6, (2, 1, 12))
    cost = np.tile(base, (1, 12, 1)).astype(np.float32)
    out.append(("exhausted", cost, np.ones((2, 12), bool), 2))
    return out


@pytest.mark.parametrize("case", _auction_cases(), ids=lambda c: c[0])
def test_auction_equals_jax(case):
    name, cost, mask, rounds = case
    ref = np.asarray(jax.jit(jax.vmap(
        lambda c, m: j_auction(c, m, max_rounds=rounds)))(cost, mask))
    profiling.reset()
    got = auction_assign(T(cost), T(mask), max_rounds=rounds).numpy()
    np.testing.assert_array_equal(got, ref)
    # one pred column and three GTs: they outbid each other to the budget
    spent = name in ("exhausted", "one_column")
    counts = profiling.snapshot()
    assert counts.get("hungarian.exhausted", 0) == int(spent)
    if spent:
        assert counts["hungarian.rounds"] == rounds
    for c, m, owner in zip(cost, mask, got):
        assigned = owner[owner >= 0]
        valid = min(int(m.sum()), c.shape[0])
        assert len(np.unique(assigned)) == len(assigned) == valid
        assert all(m[assigned])
        if spent:
            continue
        cols = np.flatnonzero(m)
        rows, picked = linear_sum_assignment(c[:, cols].T)
        want = c[:, cols].T[rows, picked].sum()
        total = sum(c[p, owner[p]] for p in range(c.shape[0])
                    if owner[p] >= 0)
        assert total <= want + len(cols) * 1e-3 + 1e-4, (total, want)


@pytest.mark.parametrize("assigner", ["hungarian", "auction"])
def test_losses_match_jax(assigner):
    logits, boxes, gt, labels, mask = _outputs(np.random.default_rng(0))
    pc = (-10, -10, -5, 10, 10, 3)
    ref = jax.jit(j_losses, static_argnums=(5, 6))(
        jnp.asarray(logits), jnp.asarray(boxes), jnp.asarray(gt),
        jnp.asarray(labels), jnp.asarray(mask),
        JLossConfig(num_classes=3, assigner=assigner), JOTAConfig(
            pc_range=pc))
    got = srfdet_losses(T(logits), T(boxes), T(gt), T(labels), T(mask),
                        LossConfig(num_classes=3, assigner=assigner),
                        OTAConfig(pc_range=pc))
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    assert float(got["loss_bbox"]) > 0
    with pytest.raises(ValueError, match="assigner"):
        srfdet_losses(T(logits), T(boxes), T(gt), T(labels), T(mask),
                      dataclasses.replace(LossConfig(num_classes=3),
                                          assigner="greedy"),
                      OTAConfig(pc_range=pc))
