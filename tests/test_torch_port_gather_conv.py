"""PyTorch port vs JAX package: the gather-GEMM (K1's plain version) and the
sparse encoder built on it.

gather_conv's plain version is held against the Pallas one-hot kernel in
interpret mode and against the JAX XLA gather path at rtol 2e-5 and
atol 2e-4 (summation order; the kernel's bf16x3 split).  The tiny sparse
encoder, on the same random weights (loaded through the port's JAX weight
bridge) and the same voxels, must give the same BEV map within 1e-4."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srfdet3d_tpu.configs import tiny_test_config as jax_tiny
from srfdet3d_tpu.models.sparse_encoder import SparseEncoder as JEncoder
from srfdet3d_tpu.ops import voxelize as jvox
from srfdet3d_tpu.ops.pallas_onehot import gather_matmul_onehot
from srfdet3d_torch.models.sparse_encoder import SparseEncoder
from srfdet3d_torch.ops.gather_conv import gather_conv, gather_conv_plain
from srfdet3d_torch.ops.sparse_conv import gathered_conv_apply_batched
from srfdet3d_torch.utils.jax_params import jax_state_dict


def _xla_ref(feats, idx, w):
    n, cin = feats.shape
    m, k = idx.shape
    table = jnp.concatenate([feats, jnp.zeros((1, cin), feats.dtype)])
    return jnp.dot(table[idx].reshape(m, k * cin), w.reshape(k * cin, -1),
                   precision=jax.lax.Precision.HIGHEST)


def _rulebook_like(rng, m, k, n, spread=64, miss_frac=0.15):
    base = np.sort(rng.integers(0, n, size=(m,)))
    idx = np.clip(base[:, None] + rng.integers(-spread, spread + 1, (m, k)),
                  0, n - 1).astype(np.int32)
    idx[rng.random((m, k)) < miss_frac] = n
    return idx


@pytest.mark.parametrize("cin,cout,k", [(5, 16, 27), (16, 32, 27),
                                        (64, 128, 3)])
def test_gather_conv_plain_matches_jax(cin, cout, k):
    rng = np.random.default_rng(cin)
    n, m = 1024, 512
    feats = rng.normal(size=(n, cin)).astype(np.float32)
    w = rng.normal(size=(k, cin, cout)).astype(np.float32)
    idx = _rulebook_like(rng, m, k, n)
    got = gather_conv(torch.from_numpy(feats), torch.from_numpy(idx),
                      torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(
        got, gather_conv_plain(torch.from_numpy(feats), torch.from_numpy(idx),
                               torch.from_numpy(w)).numpy(), rtol=0, atol=0)
    xla = np.asarray(_xla_ref(jnp.asarray(feats), jnp.asarray(idx),
                              jnp.asarray(w)))
    np.testing.assert_allclose(got, xla, rtol=2e-5, atol=2e-4)
    wp = max(16, 1024 // (128 // min(128, 1 << (cin - 1).bit_length())))
    pallas = np.asarray(gather_matmul_onehot(
        jnp.asarray(feats), jnp.asarray(idx), jnp.asarray(w), tm=256, wp=wp,
        interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=2e-5, atol=2e-4)


def test_gathered_conv_apply_batched_shapes():
    rng = np.random.default_rng(0)
    b, v, m, cin, cout = 2, 64, 48, 8, 16
    feats = torch.from_numpy(rng.normal(size=(b, v, cin)).astype(np.float32))
    gidx = torch.from_numpy(rng.integers(0, b * v + 1, (b, m, 27))
                            .astype(np.int32))
    w = torch.from_numpy(rng.normal(size=(27, cin, cout)).astype(np.float32))
    out = gathered_conv_apply_batched(feats, gidx, w)
    assert out.shape == (b, m, cout)
    ref = gather_conv_plain(feats.reshape(b * v, cin), gidx.reshape(-1, 27),
                            w).reshape(b, m, cout)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


def _random_tree(shapes, rng):
    def leaf(path, s):
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape)
        if name in ("mean", "bias"):
            return rng.normal(0, 0.1, s.shape)
        if name == "scale":
            return rng.uniform(0.8, 1.2, s.shape)
        return rng.normal(0, 1 / np.sqrt(np.prod(s.shape[:-1])), s.shape)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(leaf(p, s), np.float32), shapes)


def test_sparse_encoder_matches_jax():
    cfg = jax_tiny()
    spec = cfg.voxelization
    m = cfg.middle
    rng = np.random.default_rng(7)
    b, p = 2, cfg.points_cap
    pts = np.zeros((b, p, 5), np.float32)
    pts[:, :1500, :2] = rng.uniform(-9, 9, (b, 1500, 2))
    pts[:, :1500, 2] = rng.uniform(-4, 2, (b, 1500))
    mask = np.zeros((b, p), bool)
    mask[:, :1500] = True
    vox = jvox.voxelize_points_batched(jnp.asarray(pts), jnp.asarray(mask),
                                       spec)
    feats = rng.normal(size=(b, spec.max_voxels, 5)).astype(np.float32)
    vm = np.array(vox.voxel_mask)
    coords = np.where(vm[..., None], np.asarray(vox.voxel_coords), 0)

    enc = JEncoder(in_channels=5, sparse_shape=spec.sparse_shape,
                   base_channels=m.base_channels,
                   output_channels=m.output_channels,
                   encoder_channels=m.encoder_channels,
                   encoder_paddings=m.encoder_paddings,
                   block_type=m.block_type, capacities=m.capacities,
                   presorted=True)
    args = (jnp.asarray(feats), jnp.asarray(coords), jnp.asarray(vm))
    shapes = jax.eval_shape(partial(enc.init, train=False),
                            jax.random.PRNGKey(0), *args)
    variables = _random_tree(shapes, rng)
    ref = np.asarray(jax.jit(partial(enc.apply, train=False))(variables,
                                                              *args))

    port = SparseEncoder(5, spec.sparse_shape, m.base_channels,
                         m.output_channels, m.encoder_channels,
                         m.encoder_paddings, m.capacities)
    state = jax_state_dict({k: {"pts_middle_encoder": v}
                            for k, v in variables.items()}, 1, 0)
    prefix = "pts_middle_encoder."
    port.load_state_dict({k[len(prefix):]: torch.from_numpy(np.array(v))
                          for k, v in state.items()}, strict=True)
    port.eval()
    with torch.no_grad():
        got = port(torch.from_numpy(feats), torch.from_numpy(coords).long(),
                   torch.from_numpy(vm)).numpy()
    assert got.shape == ref.shape == (b, 10, 10, 2 * m.output_channels)
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("masked", [True, False])
def test_masked_batchnorm_train_matches_jax(masked):
    """Train-mode masked statistics and the running-stat update (torch's
    unbiased variance, momentum 0.01) within 1e-5."""
    from srfdet3d_tpu.models.layers import MaskedBatchNorm as JBN
    from srfdet3d_torch.models.layers import MaskedBatchNorm
    rng = np.random.default_rng(9)
    x = rng.normal(1.0, 2.0, (2, 50, 6)).astype(np.float32)
    mask = rng.random((2, 50)) < 0.6 if masked else None
    variables = {"params": {"scale": rng.uniform(0.5, 1.5, 6),
                            "bias": rng.normal(size=6)},
                 "batch_stats": {"mean": rng.normal(size=6),
                                 "var": rng.uniform(0.5, 2, 6)}}
    variables = jax.tree_util.tree_map(lambda a: a.astype(np.float32),
                                       variables)
    ref, upd = JBN().apply(variables, jnp.asarray(x),
                           None if mask is None else jnp.asarray(mask),
                           train=True, mutable=["batch_stats"])
    bn = MaskedBatchNorm(6)
    bn.load_state_dict({
        "weight": torch.from_numpy(variables["params"]["scale"]),
        "bias": torch.from_numpy(variables["params"]["bias"]),
        "running_mean": torch.from_numpy(variables["batch_stats"]["mean"]),
        "running_var": torch.from_numpy(variables["batch_stats"]["var"])})
    bn.train()
    got = bn(torch.from_numpy(x),
             None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(bn, ours).numpy(),
                                   np.asarray(upd["batch_stats"][theirs]),
                                   rtol=1e-5, atol=1e-6)
