"""PyTorch port vs JAX package: the sparse-conv backward (K3, K4).

Real tiny rulebooks, batch 2: the `tiny_test_config` scene voxelized by the
port, its stage-0 submanifold rulebook and its first strided downsample.
dfeats and dW of the port's plain versions, and of the autograd Function
around the gather-GEMM, are held against `jax.vjp` of the JAX package's
`gathered_conv_apply_batched` within rtol 1e-5 plus an atol of
1e-5 * sqrt(terms summed): K * Cout for dfeats, the N input rows for dW
(float32 sums in another order).  The reverse rulebook is exact, and a
subm rulebook is its own reverse with the offsets flipped, the symmetry the
K3 backward rests on.

Two faults of the predict slice that only training shows are pinned here:
the kernel's output carries no graph of its own, so the autograd Function
is what gives the sparse weights their grads; and the encoder tells the
backward which of its convs are submanifold."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srfdet3d_tpu.ops.sparse_conv import \
    gathered_conv_apply_batched as j_apply
from srfdet3d_torch.configs import tiny_test_config
from srfdet3d_torch.models.sparse_encoder import (BitmapRulebooks,
                                                  GatheredConvBN,
                                                  SparseEncoder)
from srfdet3d_torch.ops import gather_conv_bwd as gcb
from srfdet3d_torch.ops import sparse_conv
from srfdet3d_torch.ops.gather_conv import gather_conv_plain
from srfdet3d_torch.ops.voxelize import voxelize_points_batched

B = 2


def _tols(n, k, cout):
    """(dfeats, dW) tolerances for sums of K * Cout and N terms."""
    return (dict(rtol=1e-5, atol=1e-5 * np.sqrt(k * cout)),
            dict(rtol=1e-5, atol=1e-5 * np.sqrt(n)))


@pytest.fixture(scope="module")
def rulebooks():
    """(stage-0 features rows V, subm rulebook (B, V, 27), strided rulebook
    (B, M, 27), coords, mask) of the tiny scene."""
    cfg = tiny_test_config()
    spec = cfg.voxelization
    rng = np.random.default_rng(7)
    p = cfg.points_cap
    pts = np.zeros((B, p, 5), np.float32)
    pts[:, :1500, :2] = rng.uniform(-9, 9, (B, 1500, 2))
    pts[:, :1500, 2] = rng.uniform(-4, 2, (B, 1500))
    mask = np.zeros((B, p), bool)
    mask[:, :1500] = True
    vox = voxelize_points_batched(torch.from_numpy(pts),
                                  torch.from_numpy(mask), spec)
    rb = BitmapRulebooks(vox.voxel_coords, vox.voxel_mask,
                         spec.sparse_shape)
    subm = rb.subm()
    down = rb.downsample(cfg.middle.encoder_paddings[0][-1],
                         cfg.middle.capacities[0])
    return spec.max_voxels, subm, down


def _case(rng, v, idx, cin, cout):
    feats = rng.normal(size=(B, v, cin)).astype(np.float32)
    w = (rng.normal(size=(idx.shape[-1], cin, cout)) /
         np.sqrt(idx.shape[-1] * cin)).astype(np.float32)
    g = rng.normal(size=(B, idx.shape[1], cout)).astype(np.float32)
    return feats, w, g


def _jax_vjp(feats, idx, w, g, subm):
    _, vjp = jax.vjp(lambda f, k: j_apply(f, jnp.asarray(idx), k,
                                          subm=subm),
                     jnp.asarray(feats), jnp.asarray(w))
    dfe, dw = vjp(jnp.asarray(g))
    return np.asarray(dfe), np.asarray(dw)


def test_reverse_rulebook_exact(rulebooks):
    v, subm, down = rulebooks
    n = B * v
    for idx in (subm.reshape(-1, 27), down.reshape(-1, 27)):
        m = idx.shape[0]
        rev = gcb.reverse_rulebook(idx, n)
        ref = np.full((n, 27), m, np.int32)
        a = idx.numpy()
        for mm, j in zip(*np.nonzero(a < n)):
            ref[a[mm, j], j] = mm
        np.testing.assert_array_equal(rev.numpy(), ref)
    # a subm rulebook is its own reverse, offsets flipped
    flat = subm.reshape(-1, 27)
    assert int((flat < n).sum()) > 2 * n // 10
    np.testing.assert_array_equal(gcb.reverse_rulebook(flat, n).numpy(),
                                  flat.flip(1).numpy())


@pytest.mark.parametrize("cin,cout", [(5, 8), (16, 16)])
def test_subm_bwd_matches_jax(rulebooks, cin, cout):
    v, subm, _ = rulebooks
    rng = np.random.default_rng(cin)
    feats, w, g = _case(rng, v, subm, cin, cout)
    ref_dfe, ref_dw = _jax_vjp(feats, subm.numpy(), w, g, True)
    tol_f, tol_w = _tols(B * v, 27, cout)
    f2, idx = torch.from_numpy(feats).reshape(-1, cin), subm.reshape(-1, 27)
    g2 = torch.from_numpy(g).reshape(-1, cout)
    dfe, dw = gcb.subm_conv_bwd(f2, idx, torch.from_numpy(w), g2)
    np.testing.assert_allclose(dfe.numpy(), ref_dfe.reshape(-1, cin), **tol_f)
    np.testing.assert_allclose(dw.numpy(), ref_dw, **tol_w)
    none, dw2 = gcb.subm_conv_bwd(f2, idx, torch.from_numpy(w), g2,
                                  need_dfeats=False)
    assert none is None and torch.equal(dw2, dw)
    # the autograd Function on the CPU
    ft = torch.from_numpy(feats).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = sparse_conv.gathered_conv_apply_batched(ft, subm, wt, subm=True)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(ft.grad.numpy(), ref_dfe, **tol_f)
    np.testing.assert_allclose(wt.grad.numpy(), ref_dw, **tol_w)


@pytest.mark.parametrize("cin,cout", [(8, 16), (16, 32)])
def test_strided_bwd_matches_jax(rulebooks, cin, cout):
    v, _, down = rulebooks
    rng = np.random.default_rng(cout)
    feats, w, g = _case(rng, v, down, cin, cout)
    ref_dfe, ref_dw = _jax_vjp(feats, down.numpy(), w, g, False)
    tol_f, tol_w = _tols(B * v, 27, cout)
    f2, idx = torch.from_numpy(feats).reshape(-1, cin), down.reshape(-1, 27)
    g2 = torch.from_numpy(g).reshape(-1, cout)
    w_t = torch.from_numpy(w)
    dfe, dw = gcb.strided_conv_bwd(f2, idx, w_t, g2)
    np.testing.assert_allclose(dfe.numpy(), ref_dfe.reshape(-1, cin), **tol_f)
    np.testing.assert_allclose(dw.numpy(), ref_dw, **tol_w)
    # the kernel's formula: a gather over the reverse rulebook
    rev = gcb.reverse_rulebook(idx, f2.shape[0])
    dfe2, dw2 = gcb.gather_bwd_plain(f2, rev, w_t, g2, flip=False)
    np.testing.assert_allclose(dfe2.numpy(), ref_dfe.reshape(-1, cin), **tol_f)
    np.testing.assert_allclose(dw2.numpy(), ref_dw, **tol_w)
    ft = torch.from_numpy(feats).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = sparse_conv.gathered_conv_apply_batched(ft, down, wt, subm=False)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(ft.grad.numpy(), ref_dfe, **tol_f)
    np.testing.assert_allclose(wt.grad.numpy(), ref_dw, **tol_w)


def test_weights_get_grads_through_a_graphless_kernel(rulebooks,
                                                      monkeypatch):
    """The CUDA kernel's output has no graph; with gather_conv replaced by
    a graph-less stand-in, the weight and feature grads must still equal
    those of the differentiable plain path."""
    v, subm, _ = rulebooks
    rng = np.random.default_rng(1)
    feats, w, g = _case(rng, v, subm, 8, 8)
    grads = []
    for graphless in (False, True):
        if graphless:
            monkeypatch.setattr(
                sparse_conv, "gather_conv",
                lambda f, i, k: gather_conv_plain(f.detach(), i,
                                                  k.detach()))
        ft = torch.from_numpy(feats).requires_grad_()
        wt = torch.from_numpy(w).requires_grad_()
        sparse_conv.gathered_conv_apply_batched(ft, subm, wt, subm=True
                                                ).backward(
            torch.from_numpy(g))
        grads.append((ft.grad, wt.grad))
    for a, b in zip(*grads):
        assert b is not None
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_encoder_picks_the_backward_per_conv(monkeypatch):
    """Every subm conv of the encoder takes the symmetric backward (K3) and
    the downsamples and conv_out the strided one (K4)."""
    cfg = tiny_test_config()
    m = cfg.middle
    spec = cfg.voxelization
    enc = SparseEncoder(5, spec.sparse_shape, m.base_channels,
                        m.output_channels, m.encoder_channels,
                        m.encoder_paddings, m.capacities)
    with torch.no_grad():
        for p in enc.parameters():
            p.normal_(0, 0.3)
    convs = [mod for mod in enc.modules() if isinstance(mod, GatheredConvBN)]
    n_subm = sum(c.subm for c in convs)
    assert n_subm == 1 + 2 * 5 and len(convs) - n_subm == 4
    calls = {"subm": 0, "strided": 0}

    def spy(kind, fn):
        def wrapped(*a, **k):
            calls[kind] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(sparse_conv, "subm_conv_bwd",
                        spy("subm", gcb.subm_conv_bwd))
    monkeypatch.setattr(sparse_conv, "strided_conv_bwd",
                        spy("strided", gcb.strided_conv_bwd))
    rng = np.random.default_rng(2)
    pts = np.zeros((B, cfg.points_cap, 5), np.float32)
    pts[:, :1500, :2] = rng.uniform(-9, 9, (B, 1500, 2))
    pts[:, :1500, 2] = rng.uniform(-4, 2, (B, 1500))
    pmask = np.zeros((B, cfg.points_cap), bool)
    pmask[:, :1500] = True
    vox = voxelize_points_batched(torch.from_numpy(pts),
                                  torch.from_numpy(pmask), spec)
    feats = torch.randn(B, spec.max_voxels, 5)
    enc.train()
    enc(feats, vox.voxel_coords, vox.voxel_mask).square().sum().backward()
    assert calls == {"subm": n_subm, "strided": 4}
    assert all(c.kernel.grad is not None and
               float(c.kernel.grad.abs().max()) > 0 for c in convs)
