"""The yardstick's arithmetic against hand counts."""

from __future__ import annotations

import pytest
import torch

from benchmark import roofline
from benchmark.roofline import SparseConv


def test_k1_cost_of_a_small_conv():
    # 10 input rows of 4 channels, 6 output rows, 3 offsets, 5 out
    # channels, 7 hits: 2 * 7 * 4 * 5 flops; 4 bytes each of 6 * 3
    # rulebook entries, 10 * 4 inputs, 3 * 4 * 5 weights, 6 * 5 outputs
    c = SparseConv("c", 10, 6, 3, 4, 5, 7, False, True)
    flops, nbytes = roofline.k1_cost(c)
    assert flops == 280.0
    assert nbytes == 4.0 * (18 + 40 + 60 + 30)


def test_k3_cost_with_and_without_dfeats():
    c = SparseConv("c", 8, 8, 27, 2, 3, 11, True, True)
    flops, nbytes = roofline.k3_cost(c)
    assert flops == 2 * 2.0 * 11 * 2 * 3
    assert nbytes == 4.0 * (16 + 216 + 24 + 2 * 162 + 16)
    first = c._replace(need_dfeats=False)
    flops, nbytes = roofline.k3_cost(first)
    assert flops == 2.0 * 11 * 2 * 3
    assert nbytes == 4.0 * (16 + 216 + 24 + 2 * 162)


def test_bound_takes_the_slower_of_flops_and_bytes():
    assert roofline.bound_s(roofline.PEAK_3XTF32, 0.0) == pytest.approx(1.0)
    assert roofline.bound_s(0.0, roofline.PEAK_BYTES) == pytest.approx(1.0)
    assert roofline.PEAK_3XTF32 == pytest.approx(165e12)


def test_k3_bound_counts_submanifold_convs_only():
    sub = SparseConv("s", 8, 8, 27, 2, 3, 11, True, True)
    down = SparseConv("d", 8, 4, 27, 2, 3, 11, False, True)
    assert roofline.k3_bound_s([sub, down]) == roofline.k3_bound_s([sub])


def test_sparse_correction_counts_misses():
    c = SparseConv("c", 10, 6, 3, 4, 5, 7, False, True)
    waste = 2.0 * (6 * 3 - 7) * 4 * 5
    assert roofline.sparse_correction([c], False) == waste
    assert roofline.sparse_correction([c], True) == 3 * waste
    assert roofline.sparse_correction([c._replace(need_dfeats=False)],
                                      True) == 2 * waste


def test_model_flops_of_a_hand_counted_model():
    """Linear 8 -> 16, then a 3x3 conv 2 -> 4 on 5 x 5 (padding 1), batch
    3: forward 2*3*8*16 + 2*3*25*4*2*9; forward and backward 3x that."""
    lin = torch.nn.Linear(8, 16)
    conv = torch.nn.Conv2d(2, 4, 3, padding=1)
    x, y = torch.randn(3, 8), torch.randn(3, 2, 5, 5)
    fwd = 2 * 3 * 8 * 16 + 2 * 3 * 25 * 4 * 2 * 9
    assert roofline.count_flops(lambda: (lin(x), conv(y))) == fwd
    x.requires_grad_(True)
    y.requires_grad_(True)
    total = roofline.count_flops(
        lambda: (lin(x).sum() + conv(y).sum()).backward())
    assert total == 3 * fwd


def test_tally_counts_hits_of_the_reference_convs():
    from benchmark.reference.models.sparse_encoder import GatheredConvBN
    net = torch.nn.Sequential()
    conv = GatheredConvBN(2, 3, 27, subm=True)
    net.add_module("c", conv)
    feats = torch.randn(1, 4, 2)
    gidx = torch.full((1, 4, 27), 4, dtype=torch.int32)
    gidx[0, :, 13] = torch.arange(4)
    gidx[0, 0, 0] = 1
    tally = roofline.SparseConvTally(net, GatheredConvBN)
    conv(feats, gidx, torch.ones(1, 4, dtype=torch.bool))
    tally.close()
    (c,) = tally.convs
    assert (c.n, c.m, c.k, c.cin, c.cout, c.hits, c.subm) == \
        (4, 4, 27, 2, 3, 5, True)
    assert c.need_dfeats is False
