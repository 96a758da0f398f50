"""The RoIAlign backward (K5) from per-axis corners.

K5 takes each RoI's corners per axis (`Corners.cells`, `cw`, `level`) and
sums the RoI's window in shared memory before one global add per touched
(cell, channel).  Held here on the CPU, batch 2, four levels, RoIs from 1
to 245 cells wide, with and without the patch rule (patch 8, 2 fallback
slots):

- the per-axis corners expand to exactly the (R, 4, S, S) corners the
  forward gathers, and the wrapper's plain path equals `roi_scatter_plain`
  on them exactly;
- a numpy model of the kernel's arithmetic (per axis: the live corner
  candidates ranked to their distinct cells, each cell's weight per output
  cell column; then the two small products and one add per cell) equals
  `roi_scatter_plain` within rtol 1e-5 + atol 1e-5 * sqrt(adds into a row)
  (float32 sums in another order);
- the model's adds a RoI are its distinct live table rows, at most (2 S)^2
  whatever the RoI's span, and no more than its live corner samples: the
  counts chip_smoke.py reports as the global atomics before and after.
"""

import numpy as np
import pytest
import torch

from srfdet3d_torch.ops.roi_align import corner_samples
from srfdet3d_torch.ops.roi_scatter import (expand_axes, roi_scatter,
                                            roi_scatter_plain)

T = torch.from_numpy
B, R, C, OUT, SR = 2, 30, 6, 7, 2
SIZES = [(20, 24), (10, 12), (5, 6), (3, 3)]
STRIDES = (8, 16, 32, 64)
ROWS = B * sum(h * w for h, w in SIZES)


def _case(seed, patch, fallback):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-20, 170, (B, R, 2))
    ext = np.exp(rng.uniform(0, 5.5, (B, R, 2)))       # 1 to 245 cells
    rois = np.concatenate([lo, lo + ext], -1).astype(np.float32)
    cs = corner_samples(SIZES, T(rois), STRIDES, OUT, SR, patch=patch,
                        patch_fallback=fallback)
    gp = rng.normal(size=(B * R, OUT, OUT, C)).astype(np.float32)
    return cs, T(gp)


def _window_sum_model(gp, cells, cw, level, drop):
    """The kernel's arithmetic, per RoI, in numpy: returns the table
    cotangent and the adds (distinct live cells x channels) of each RoI."""
    r, out, _, c = gp.shape
    s = out * SR
    dt = np.zeros((ROWS, c), np.float32)
    adds = np.zeros(r, np.int64)
    for i in range(r):
        if drop[i]:
            continue
        wax, uniq = [], []
        for ax in range(2):
            cand = cells[i, 2 * ax:2 * ax + 2].reshape(-1)    # q * S + j
            wc = cw[i, 2 * ax:2 * ax + 2].reshape(-1)
            u = []
            for kk in range(2 * s):
                if wc[kk] != 0 and cand[kk] not in u:
                    u.append(cand[kk])
            w = np.zeros((len(u), out), np.float32)
            for ui, cell in enumerate(u):
                for cc in range(out):
                    for j in range(cc * SR, cc * SR + SR):
                        for q in range(2):
                            if cand[q * s + j] == cell:
                                w[ui, cc] += wc[q * s + j]
            wax.append(w)
            uniq.append(u)
        if not uniq[0] or not uniq[1]:
            continue
        h = np.einsum("xc,ycn->yxn", wax[1], gp[i])        # (out, nx, C)
        v = np.einsum("uy,yxn->uxn", wax[0], h) / (SR * SR)
        base, width = level[i]
        for uy, yc in enumerate(uniq[0]):
            for ux, xc in enumerate(uniq[1]):
                dt[base + yc * width + xc] += v[uy, ux]
        adds[i] = len(uniq[0]) * len(uniq[1]) * c
    return dt, adds


@pytest.mark.parametrize("patch,fallback", [(8, 2), (0, -1)])
def test_axes_expand_to_the_gathered_corners(patch, fallback):
    cs, gp = _case(4, patch, fallback)
    idx, wgt = expand_axes(cs.cells, cs.cw, cs.level)
    assert torch.equal(idx, cs.idx)
    assert torch.equal(wgt, cs.wgt.detach())
    assert cs.cells.dtype == cs.level.dtype == torch.int32
    assert not cs.cw.requires_grad
    got = roi_scatter(gp, cs.cells, cs.cw, cs.level, cs.drop, ROWS, SR)
    assert torch.equal(got, roi_scatter_plain(gp, cs.idx, cs.wgt.detach(),
                                              cs.drop, ROWS, SR))
    if patch:
        assert bool(cs.drop.any())


@pytest.mark.parametrize("patch,fallback", [(8, 2), (0, -1)])
def test_window_sum_model_matches_plain(patch, fallback):
    cs, gp = _case(5, patch, fallback)
    ref = roi_scatter_plain(gp, cs.idx, cs.wgt.detach(), cs.drop, ROWS,
                            SR).numpy()
    got, adds = _window_sum_model(gp.numpy(), cs.cells.numpy(),
                                  cs.cw.numpy(), cs.level.numpy(),
                                  cs.drop.numpy())
    live = (cs.wgt.detach() != 0) & ~cs.drop[:, None, None, None]
    per_row = int(torch.bincount(cs.idx[live], minlength=ROWS).max())
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.sqrt(per_row))
    # adds: the distinct live rows of each RoI, at most (2 S)^2 a channel,
    # never more than the live corner samples
    s = OUT * SR
    before = live.reshape(B * R, -1).sum(1).numpy() * C
    rid = torch.arange(B * R)[:, None, None, None].expand_as(cs.idx)
    distinct = torch.unique(rid[live] * ROWS + cs.idx[live])
    after = np.bincount((distinct // ROWS).numpy(), minlength=B * R) * C
    np.testing.assert_array_equal(adds, after)
    assert (adds <= (2 * s) ** 2 * C).all() and (adds <= before).all()
    assert adds.sum() * 4 < before.sum()
