"""PyTorch port vs JAX package: one tiny train step of the whole LiDAR
model in bfloat16 (`compute_dtype="bfloat16"`).

The JAX step runs in bf16, compiled without XLA's excess precision
(`torch_port_common.EXACT_BF16`, every op rounded to its dtype) and with
it, and in float32, on the same weights and batch.  The port's bf16 step:
losses within 1e-2 relative of JAX's exact bf16 ones; every leaf's grad
within JAX's own bf16 spread (`torch_port_common.check_bf16_grads`), and
over the tree closer to JAX's bf16 grads than those are to its float32
ones (measured on these seeds: 0.41 of that distance; the worst leaf 0.79
of its bound); the grads reach the float32 parameters as float32 (each
bf16 grad through its cast's backward), and the parameters and BN
statistics stay float32 after the AdamW update.  The losses, the
assignment and the boxes are float32 in both modes (JAX
`models/losses.py:68-77`)."""

import dataclasses

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from srfdet3d_tpu import configs as jconfigs
from srfdet3d_torch import configs as tconfigs
from srfdet3d_torch.models.detector import SRFDet
from srfdet3d_torch.train.trainer import make_optimizer, train_step
from srfdet3d_torch.utils.jax_params import load_jax_params
from torch_port_common import T, check_bf16_grads, jax_bf16_steps

# the measured tree ratio, and the bound the test keeps
TREE_RATIO = 0.41


def _cfg(mod, **kw):
    cfg = mod.tiny_test_config(points_cap=256, voxels_cap=256, gt_cap=4,
                               **kw)
    return cfg.replace(head=dataclasses.replace(
        cfg.head, roi_patch=8, roi_patch_fallback=2))


@pytest.fixture(scope="module")
def steps():
    """(port config, the port after its bf16 step, its metrics, the JAX
    steps' outputs)."""
    j16 = _cfg(jconfigs, compute_dtype="bfloat16")
    batch = {k: np.array(v) for k, v in graft._synthetic_batch(
        j16, 2, with_gt=True, seed=4).items()}
    variables, outs = jax_bf16_steps(j16, _cfg(jconfigs), batch, 21)
    tcfg = _cfg(tconfigs, compute_dtype="bfloat16")
    port = SRFDet(tcfg, device="cpu")
    load_jax_params(port, variables)
    opt = make_optimizer(port, tcfg, 100)
    metrics = train_step(port, opt, {k: T(v) for k, v in batch.items()},
                         torch.Generator().manual_seed(0))
    return tcfg, port, metrics, outs


def test_bf16_step_losses_match_jax(steps):
    _, _, metrics, outs = steps
    total, losses = outs["exact"][0], outs["exact"][1]
    for k, v in losses.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-2,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(metrics["loss"]), float(total),
                               rtol=1e-2)


def test_bf16_step_grads_within_jax_bf16_spread(steps):
    tcfg, port, _, outs = steps
    tree, _ = check_bf16_grads(port, tcfg, outs)
    assert tree <= 1.25 * TREE_RATIO, tree


def test_bf16_step_keeps_float32_state(steps):
    _, port, metrics, _ = steps
    assert all(p.dtype == torch.float32 for p in port.parameters())
    assert all(b.dtype in (torch.float32, torch.int64)
               for b in port.buffers())
    assert all(np.isfinite(float(v)) for v in metrics.values())
