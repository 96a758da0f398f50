"""The LiDAR-camera train step on the tiny caffe ResNet-50 LC config with
DCNv2 in stages 3-4, a BN + ReLU image neck and 8 image-RoI slots a
camera, stem and stage 1 frozen and every backbone BN's scale and bias
frozen (norm_frozen, as on Waymo LC), JAX make_train_step against the
port on the CPU (GridMask off, dropout 0): torch_port_common's
check_lc_train_step and check_reported_grad_norm.  Its own file: each JAX
train step compiles for ~20-25 s on the CPU."""

import pytest

from torch_port_common import (check_lc_train_step, check_reported_grad_norm,
                               jax_lc_train_step)

# (backbone, config options, batch seed, weight seed): the seeds where
# JAX's own grads move least under one-ulp image noise (3.7e-5 of a leaf's
# largest at the worst leaf, on the CPU; at weight seed 21 one DCN kernel's
# moves 0.14)
STEP = ("r50_dcn", dict(frozen_stages=1, norm_frozen=True,
                        use_grid_mask=False), 4, 25)


@pytest.fixture(scope="module")
def lc_step():
    return jax_lc_train_step(*STEP)


def test_tiny_lc_r50_train_step_matches_jax(lc_step):
    """DCNv2's kernels and offset convs in stages 3-4, the BN neck's batch
    statistics, the compacted image pairs' grads through index_add_:
    check_lc_train_step."""
    check_lc_train_step(lc_step)


def test_tiny_lc_r50_reported_grad_norm_differs_from_jax(lc_step):
    check_reported_grad_norm(lc_step)
