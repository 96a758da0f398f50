"""PyTorch port vs JAX package: one whole tiny train step without the
DPG (`with_dpg=False`: the proposal embeddings get their grads through the
RoIs alone) at test_torch_port_train.py's tolerances
(torch_port_common.compare_train_step): losses, every grad, the AdamW
update, the BN statistics; and a tiny predict with the deformable BEV
encoder under the DPG, whose staircase then reads the encoded levels, at
check_predict's tolerances (its train step:
test_torch_port_options_encoder.py, without the DPG).  Dropout 0."""

import dataclasses

import torch

from srfdet3d_tpu import configs as jconfigs
from srfdet3d_torch import configs as tconfigs
from srfdet3d_torch.models.detector import SRFDet
from srfdet3d_torch.train.trainer import make_optimizer, train_step
from srfdet3d_torch.utils.jax_params import load_jax_params
from torch_port_common import (T, check_predict, compare_train_step,
                               jax_train_step, port_step_result)

OPTS = dict(with_dpg=False)
WEIGHT_SEED, BATCH_SEED = 13, 5


def _cfg(mod):
    cfg = mod.tiny_test_config(points_cap=256, voxels_cap=256, gt_cap=4)
    return cfg.replace(head=dataclasses.replace(cfg.head, **OPTS))


def test_no_dpg_train_step_matches_jax():
    batch, variables, out = jax_train_step(_cfg(jconfigs), 2,
                                           batch_seed=BATCH_SEED,
                                           weight_seed=WEIGHT_SEED)
    tcfg = _cfg(tconfigs)
    port = SRFDet(tcfg, device="cpu")
    load_jax_params(port, variables)
    assert not hasattr(port.bbox_head, "dpg_fc1")
    assert port.bbox_head.init_proposal_boxes.shape[0] == \
        tcfg.head.num_proposals
    opt = make_optimizer(port, tcfg, 100)
    metrics = train_step(port, opt, {k: T(v) for k, v in batch.items()},
                         torch.Generator().manual_seed(0))
    compare_train_step(tcfg, port_step_result(port, metrics), variables,
                       out)


def test_encoder_with_dpg_predict_matches_jax():
    """The encoded levels feed the DPG too (JAX head.py:519-525):
    check_predict's tolerances."""
    opts = dict(with_lidar_encoder=True)
    jcfg, tcfg = jconfigs.tiny_test_config(), tconfigs.tiny_test_config()
    check_predict(jcfg.replace(head=dataclasses.replace(jcfg.head, **opts)),
                  tcfg.replace(head=dataclasses.replace(tcfg.head, **opts)))
