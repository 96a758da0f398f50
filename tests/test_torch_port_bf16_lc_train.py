"""PyTorch port vs JAX package: one tiny LC train step with the image
branch in bfloat16 (`img.compute_dtype="bfloat16"` under a float32
model), VoVNet-19-slim with the LiDAR branch frozen, as the shipped LC
fine-tunes train (`test_torch_port_lc_train.py`'s STEP config and seeds).

The JAX step runs with the branch in bf16, compiled without XLA's excess
precision (`torch_port_common.EXACT_BF16`) and with it, and all in float32,
on the same weights and batch.  The port's step: losses within 1e-2
relative of JAX's exact bf16 ones; every trainable leaf's grad within JAX's
own bf16 spread (`torch_port_common.check_bf16_grads`), and over the tree
closer to JAX's bf16 grads than those are to its float32 ones (measured on
these seeds: 0.998 of that distance, while JAX's two bf16 programs sit 3.7
times as far from each other: the deep bf16 backward of the backbone
flips roundings differently in each; the worst leaf 0.65 of its bound);
the frozen leaves (the LiDAR branch, the stem and first stage) get no
grad; the parameters stay float32 after the update."""

import numpy as np
import pytest
import torch

from srfdet3d_torch import configs as tconfigs
from srfdet3d_torch.models.detector import SRFDet
from srfdet3d_torch.train.trainer import make_optimizer, train_step
from srfdet3d_torch.utils.jax_params import load_jax_params
from torch_port_common import (T, check_bf16_grads, jax_bf16_steps,
                               jax_tiny_lc, lc_batch_np)

IMG = dict(frozen_stages=1, use_grid_mask=False)
BATCH_SEED, WEIGHT_SEED = 4, 23


@pytest.fixture(scope="module")
def steps():
    j16 = jax_tiny_lc("vovnet", compute_dtype="bfloat16", **IMG)
    batch = lc_batch_np(j16, 2, BATCH_SEED)
    variables, outs = jax_bf16_steps(j16, jax_tiny_lc("vovnet", **IMG),
                                     batch, WEIGHT_SEED)
    tcfg = tconfigs.tiny_lc_test_config("vovnet", compute_dtype="bfloat16",
                                        **IMG)
    port = SRFDet(tcfg, device="cpu")
    load_jax_params(port, variables)
    opt = make_optimizer(port, tcfg, 100)
    metrics = train_step(port, opt, {k: T(v) for k, v in batch.items()},
                         torch.Generator().manual_seed(0))
    return tcfg, port, metrics, outs


def test_img_bf16_step_losses_match_jax(steps):
    _, _, metrics, outs = steps
    for k, v in outs["exact"][1].items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-2,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(outs["exact"][0]), rtol=1e-2)


def test_img_bf16_step_grads_within_jax_bf16_spread(steps):
    tcfg, port, _, outs = steps
    check_bf16_grads(port, tcfg, outs)
    assert any(n.startswith("img_backbone.") and p.grad is not None
               for n, p in port.named_parameters())


def test_img_bf16_step_keeps_float32_state(steps):
    _, port, metrics, _ = steps
    assert port.img_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in port.parameters())
    assert all(b.dtype in (torch.float32, torch.int64)
               for b in port.buffers())
    assert all(np.isfinite(float(v)) for v in metrics.values())
