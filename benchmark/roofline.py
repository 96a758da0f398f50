"""The yardstick's arithmetic: data-sheet peaks, the operations and bytes
of the sparse-conv kernels for the hits their inputs need, and the model
flops of a frame or a step.

Peaks are NVIDIA's data sheet for one H100 SXM (dense rates, 700 W); a run
prints the card's power limit beside its numbers.  The gather-GEMM kernels
(K1 forward, K3 / K4 backward) run float32 as three TF32 tensor-core
products per product (3xTF32), so their rate, and the rate the model flops
are held to, is a third of TF32's: the fastest path that keeps float32
accuracy, as the configs ask (float32, TF32 off).  The per-conv formulas
are the port's own bench script's (chip_smoke.py, `bounds` and its
gather_conv / conv_bwd cases)."""

from __future__ import annotations

from typing import List, NamedTuple

import torch
from torch.utils.flop_counter import FlopCounterMode

PEAK_BYTES = 3.35e12           # HBM3, bytes/s
PEAK_TF32 = 495e12             # dense TF32 tensor cores, flop/s
PEAK_3XTF32 = PEAK_TF32 / 3    # float32-faithful products, flop/s
PEAK_F32 = 67e12               # float32 CUDA cores, flop/s


class SparseConv(NamedTuple):
    """One gathered conv of the encoder on one batch: n input rows, m
    output rows, k offsets, widths, the rulebook's hits, whether it is a
    submanifold conv, and whether its backward needs dfeats."""
    name: str
    n: int
    m: int
    k: int
    cin: int
    cout: int
    hits: int
    subm: bool
    need_dfeats: bool


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of flops over the
    3xTF32 rate and bytes over HBM's rate."""
    return max(flops / PEAK_3XTF32, nbytes / PEAK_BYTES)


def k1_cost(c: SparseConv):
    """(flops, bytes) of K1 on one conv: 2 flops a hit and channel pair;
    the rulebook, the input rows, the weights read once and the output
    written once, 4 bytes each."""
    flops = 2.0 * c.hits * c.cin * c.cout
    nbytes = 4.0 * (c.m * c.k + c.n * c.cin + c.k * c.cin * c.cout +
                    c.m * c.cout)
    return flops, nbytes


def k3_cost(c: SparseConv):
    """(flops, bytes) of K3 (the submanifold backward) on one conv: the
    dW product and, where the step needs it, the dfeats product; reads the
    input rows, the rulebook, the output cotangent and the weights, writes
    dW and dfeats."""
    products = 2 if c.need_dfeats else 1
    flops = products * 2.0 * c.hits * c.cin * c.cout
    nbytes = 4.0 * (c.n * c.cin + c.m * c.k + c.m * c.cout +
                    2 * c.k * c.cin * c.cout +
                    (c.n * c.cin if c.need_dfeats else 0))
    return flops, nbytes


def k1_bound_s(convs: List[SparseConv]) -> float:
    return sum(bound_s(*k1_cost(c)) for c in convs)


def k3_bound_s(convs: List[SparseConv]) -> float:
    return sum(bound_s(*k3_cost(c)) for c in convs if c.subm)


class SparseConvTally:
    """Forward pre-hooks on a detector's gathered convs (the reference's
    `GatheredConvBN` modules) that record each conv's rows, widths and
    rulebook hits (entries below the miss row) as it runs."""

    def __init__(self, net: torch.nn.Module, conv_type):
        self.convs: List[SparseConv] = []
        self._handles = []
        first = True
        for name, mod in net.named_modules():
            if isinstance(mod, conv_type):
                self._handles.append(mod.register_forward_pre_hook(
                    self._hook(name, first)))
                first = False

    def _hook(self, name, first):
        def hook(mod, args):
            feats, gidx = args[0], args[1]
            b, v, cin = feats.shape
            _, m, k = gidx.shape
            hits = int((gidx < b * v).sum())
            self.convs.append(SparseConv(
                name, b * v, b * m, k, cin, mod.kernel.shape[2], hits,
                mod.subm, not first))
        return hook

    def close(self):
        for h in self._handles:
            h.remove()


def count_flops(fn) -> float:
    """Run fn() under a dense flop counter (matmuls, convolutions,
    attention; forward and backward) and return the flops it booked."""
    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def sparse_correction(convs: List[SparseConv], trained: bool) -> float:
    """What to take off a dense count of the plain gathered convs to count
    their rulebook hits instead of every entry: the forward product and,
    where the convs train, the dW product and the dfeats product."""
    out = 0.0
    for c in convs:
        waste = 2.0 * (c.m * c.k - c.hits) * c.cin * c.cout
        out += waste * (1 + (1 + c.need_dfeats if trained else 0))
    return out
