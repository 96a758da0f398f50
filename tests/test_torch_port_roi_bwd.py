"""PyTorch port vs JAX package: the RoIAlign backward (K5's plain version
and the corner weights' cotangent).

Batch 2, four levels, RoIs from 1 to 245 cells wide, the patch path scaled
down (patch=8, patch_fallback=2) so that more RoIs misfit than there are
fallback slots and the capacity rule drops some.  The port's autograd
grads of the feature maps (the table cotangent K5 computes) and of the RoIs
are held against `jax.vjp` of the JAX package's `multilevel_roi_align`,
per sample.  Feature-map grads within rtol 1e-5 + atol 1e-5 (sums of a few
hundred float32 terms); RoI grads within 1e-4 of the largest (each sums
out * out * sr^2 * 4 * C products, in another order).  The dropped misfits
get zero grads on both sides, and the kernel's plain version equals a
per-sample scatter written out in numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srfdet3d_tpu.ops.roi_align import multilevel_roi_align as jroi
from srfdet3d_torch.ops.roi_align import multilevel_roi_align, patch_fits
from srfdet3d_torch.ops.roi_scatter import (expand_axes, roi_scatter,
                                            roi_scatter_plain)

T = torch.from_numpy
B, R, C = 2, 30, 6
SIZES = [(20, 24), (10, 12), (5, 6), (3, 3)]
STRIDES = (8, 16, 32, 64)


def _case(seed):
    rng = np.random.default_rng(seed)
    feats = [rng.normal(size=(B, h, w, C)).astype(np.float32)
             for h, w in SIZES]
    lo = rng.uniform(-20, 170, (B, R, 2))
    ext = np.exp(rng.uniform(0, 5.5, (B, R, 2)))       # 1 to 245 cells
    rois = np.concatenate([lo, lo + ext], -1).astype(np.float32)
    g = rng.normal(size=(B, R, 7, 7, C)).astype(np.float32)
    return feats, rois, g


@pytest.mark.parametrize("patch,fallback", [(8, 2), (0, -1)])
def test_roi_align_grads_match_jax(patch, fallback):
    feats, rois, g = _case(4)
    kw = dict(patch=patch, patch_fallback=fallback)

    @jax.jit
    def grads(fs, r, gg):
        return jax.vjp(lambda fs_, r_: jroi(fs_, r_, STRIDES, **kw),
                       fs, r)[1](gg)
    ref_df, ref_dr = [], []
    for i in range(B):
        dfs, dr = grads([jnp.asarray(f[i]) for f in feats],
                        jnp.asarray(rois[i]), jnp.asarray(g[i]))
        ref_df.append([np.asarray(d) for d in dfs])
        ref_dr.append(np.asarray(dr))
    ft = [T(f).requires_grad_() for f in feats]
    rt = T(rois).requires_grad_()
    multilevel_roi_align(ft, rt, STRIDES, **kw).backward(T(g))
    for lvl, f in enumerate(ft):
        ref = np.stack([ref_df[i][lvl] for i in range(B)])
        np.testing.assert_allclose(f.grad.numpy(), ref, rtol=1e-5,
                                   atol=1e-5)
    ref = np.stack(ref_dr)
    scale = float(np.abs(ref).max())
    assert scale > 0
    np.testing.assert_allclose(rt.grad.numpy(), ref, rtol=0,
                               atol=1e-4 * scale)
    if patch:
        mis = ~patch_fits(SIZES, T(rois.reshape(-1, 4)), STRIDES, patch
                          ).reshape(B, R).numpy()
        assert (mis.sum(1) > fallback).all()
        dropped = mis & (np.cumsum(mis, 1) > fallback)
        assert not np.abs(ref[dropped]).any()
        assert not rt.grad.numpy()[dropped].any()


def test_roi_scatter_plain_matches_loop():
    rng = np.random.default_rng(0)
    r, out, sr, c, rows = 5, 3, 2, 4, 40
    s = out * sr
    gp = rng.normal(size=(r, out, out, c)).astype(np.float32)
    idx = rng.integers(0, rows, (r, 4, s, s))
    w = rng.uniform(0, 1, (r, 4, s, s)).astype(np.float32)
    drop = np.array([False, True, False, False, True])
    ref = np.zeros((rows, c), np.float32)
    for i in range(r):
        if drop[i]:
            continue
        for q in range(4):
            for y in range(s):
                for x in range(s):
                    ref[idx[i, q, y, x]] += (w[i, q, y, x] *
                                             gp[i, y // sr, x // sr] /
                                             (sr * sr))
    args = (T(gp), T(idx), T(w), T(drop), rows, sr)
    np.testing.assert_allclose(roi_scatter_plain(*args).numpy(), ref,
                               rtol=1e-5, atol=1e-6)
    # the wrapper takes the corners per axis: on the CPU it expands them
    # and runs the plain version
    cells = rng.integers(0, 5, (r, 4, s)).astype(np.int32)
    cw = rng.uniform(0, 1, (r, 4, s)).astype(np.float32)
    level = np.stack([rng.integers(0, 10, r), np.full(r, 6)], 1)
    level = level.astype(np.int32)
    axes = (T(cells), T(cw), T(level))
    idx2, w2 = expand_axes(*axes)
    for i in range(r):
        for qy in range(2):
            for qx in range(2):
                q = 2 * qy + qx
                assert (idx2[i, q].numpy() == level[i, 0] + cells[
                    i, qy, :, None] * 6 + cells[i, 2 + qx, None, :]).all()
                assert (w2[i, q].numpy() == cw[i, qy, :, None] *
                        cw[i, 2 + qx, None, :]).all()
    assert torch.equal(roi_scatter(T(gp), *axes, T(drop), rows, sr),
                       roi_scatter_plain(T(gp), idx2, w2, T(drop), rows, sr))
