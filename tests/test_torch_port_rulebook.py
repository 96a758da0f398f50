"""PyTorch port vs JAX package: bitmap-column rulebooks and the eq-match
rulebook (K2's plain version).  Every output is integer and must match
exactly: column tables, site lists, masks and rulebooks.  The eq-match
reference is the Pallas kernel in interpret mode, including a window too
small for its tiles (its exact fallback path)."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srfdet3d_tpu.ops import bitmap_rulebook as jbr
from srfdet3d_torch.ops import bitmap_rulebook as tbr
from srfdet3d_torch.ops.eqmatch import mask_below, popcount64


def _scene(rng, b, v, shape, density=0.5):
    """Plan-major sorted voxels, invalid rows at each sample's tail."""
    d, h, w = shape
    n = int(v * density)
    coords = np.zeros((b, v, 3), np.int32)
    mask = np.zeros((b, v), bool)
    for s in range(b):
        cells = rng.choice(d * h * w, size=n - 3 * s, replace=False)
        z, yx = cells % d, cells // d
        y, x = yx // w, yx % w
        o = np.argsort((y * w + x) * d + z)
        coords[s, :len(o)] = np.stack([z[o], y[o], x[o]], -1)
        mask[s, :len(o)] = True
    return coords, mask


# the JAX references run jitted: one compile per function beats eager
# dispatch of their many small ops
_j_build = jax.jit(jbr.build_columns, static_argnums=2)
_j_subm = jax.jit(jbr.subm_rulebook_bitmap)
_j_down = jax.jit(partial(jbr.strided_downsample_bitmap, eqmatch=False,
                          return_yx=True), static_argnums=(1, 2))
_j_convout_sites = jax.jit(jbr.convout_sites_bitmap, static_argnums=1)
_j_convout_rb = jax.jit(jbr.convout_rulebook_bitmap)


def _cols(coords, mask, shape):
    jcs, jvcol, jvz = _j_build(jnp.asarray(coords), jnp.asarray(mask), shape)
    tcs, tvcol, tvz = tbr.build_columns(
        torch.from_numpy(coords).long(), torch.from_numpy(mask), shape)
    return (jcs, jvcol, jvz), (tcs, tvcol, tvz)


def _words(lo, hi):
    return (np.asarray(lo).astype(np.uint64) |
            (np.asarray(hi).astype(np.uint64) << np.uint64(32))
            ).view(np.int64)


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _eq_columns(tcs, jcs):
    m = np.asarray(jcs.cmask)
    _eq(tcs.cmask, m)
    np.testing.assert_array_equal(tcs.ccoords.numpy()[m],
                                  np.asarray(jcs.ccoords)[m])
    np.testing.assert_array_equal(tcs.cstart.numpy()[m],
                                  np.asarray(jcs.cstart)[m])
    np.testing.assert_array_equal(tcs.bits.numpy()[m],
                                  _words(jcs.lo, jcs.hi)[m])
    assert tcs.shape == tuple(jcs.shape) and tcs.row_cap == jcs.row_cap


def test_bit_helpers():
    rng = np.random.default_rng(0)
    words = rng.integers(-2 ** 63, 2 ** 63 - 1, size=4096, dtype=np.int64)
    want = np.array([bin(int(w) & (2 ** 64 - 1)).count("1") for w in words])
    _eq(popcount64(torch.from_numpy(words)), want)
    n = torch.arange(-2, 67)
    got = mask_below(n).numpy().view(np.uint64)
    ref = [(1 << max(0, min(int(k), 64))) - 1 for k in n]
    assert [int(g) for g in got] == ref


@pytest.mark.parametrize("b,v,shape", [
    (1, 512, (12, 24, 24)), (2, 384, (8, 16, 40)), (2, 600, (41, 20, 12))])
def test_columns_and_subm_match_jax(b, v, shape):
    rng = np.random.default_rng(v)
    coords, mask = _scene(rng, b, v, shape)
    (jcs, jvcol, jvz), (tcs, tvcol, tvz) = _cols(coords, mask, shape)
    _eq_columns(tcs, jcs)
    _eq(tvcol, jvcol)
    _eq(tvz, jvz)
    ref = _j_subm(jcs, jvcol, jvz, jnp.asarray(mask))
    got = tbr.subm_rulebook_bitmap(tcs, tvcol, tvz, torch.from_numpy(mask))
    assert got.dtype == torch.int32
    _eq(got, ref)
    # the kernel's wrapper takes the plain version on the CPU
    got_k = tbr.subm_rulebook_eqmatch(tcs, torch.from_numpy(coords).long(),
                                      torch.from_numpy(mask))
    _eq(got_k, ref)


@pytest.mark.parametrize("shape,density,wc,tm", [
    ((12, 24, 24), 0.5, 256, 128),
    ((8, 24, 24), 0.8, 128, 128),        # window too small: exact fallback
])
def test_subm_matches_pallas_eqmatch_interpret(shape, density, wc, tm):
    rng = np.random.default_rng(1)
    coords, mask = _scene(rng, 1, 512, shape, density=density)
    (jcs, jvcol, jvz), (tcs, tvcol, tvz) = _cols(coords, mask, shape)
    ref = jbr.subm_rulebook_eqmatch(jcs, jnp.asarray(coords), jvcol, jvz,
                                    jnp.asarray(mask), wc=wc, tm=tm,
                                    interpret=True)
    got = tbr.subm_rulebook_eqmatch(tcs, torch.from_numpy(coords).long(),
                                    torch.from_numpy(mask))
    _eq(got, ref)


@pytest.mark.parametrize("shape,pad,cap,density", [
    ((12, 20, 28), (1, 1, 1), 256, 0.6),
    ((12, 20, 28), (0, 1, 1), 192, 0.6),
    ((6, 16, 16), (1, 1, 1), 64, 0.9),     # capacity overflow drops sites
    ((41, 24, 24), (1, 1, 1), 400, 0.5),
])
def test_strided_downsample_matches_jax(shape, pad, cap, density):
    rng = np.random.default_rng(2)
    coords, mask = _scene(rng, 2, 400, shape, density=density)
    (jcs, _, _), (tcs, _, _) = _cols(coords, mask, shape)
    jout = _j_down(jcs, pad, cap)
    tout = tbr.strided_downsample_bitmap(tcs, pad, cap)
    jcs_o, jvcol, jvz, jvm, jgidx, jvyx = jout
    tcs_o, tvcol, tvz, tvm, tgidx, tvyx = tout
    _eq_columns(tcs_o, jcs_o)
    for t, j in ((tvcol, jvcol), (tvz, jvz), (tvm, jvm), (tgidx, jgidx),
                 (tvyx, jvyx)):
        _eq(t, j)
    if cap == 64:
        assert tvm.all(), "the overflow case must fill every site slot"
    # the next stage's subm rulebook guards rows past the capacity
    ref = _j_subm(jcs_o, jvcol, jvz, jvm)
    _eq(tbr.subm_rulebook_bitmap(tcs_o, tvcol, tvz, tvm), ref)


@pytest.mark.parametrize("shape,cap", [((5, 16, 16), 600), ((5, 16, 16), 90)])
def test_convout_matches_jax(shape, cap):
    rng = np.random.default_rng(3)
    coords, mask = _scene(rng, 2, 500, shape, density=0.7)
    (jcs, _, _), (tcs, _, _) = _cols(coords, mask, shape)
    jcs_o, jvcol, jvz, jvm = _j_convout_sites(jcs, cap)
    tcs_o, tvcol, tvz, tvm = tbr.convout_sites_bitmap(tcs, cap)
    _eq_columns(tcs_o, jcs_o)
    for t, j in ((tvcol, jvcol), (tvz, jvz), (tvm, jvm)):
        _eq(t, j)
    _eq(tbr.convout_rulebook_bitmap(tcs, tvcol, tvz, tvm),
        _j_convout_rb(jcs, jvcol, jvz, jvm))
