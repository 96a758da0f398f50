"""PyTorch port vs JAX package: one whole tiny train step with the
deformable BEV encoder (`with_lidar_encoder=True`, `with_dpg=False`) at
test_torch_port_train.py's tolerances (torch_port_common.
compare_train_step): the encoded levels feed the RoIs, the encoder's
BatchNorms update.  Dropout 0: the tiny config's head dropout is 0, and
the encoder's fixed 0.1 is set to 0 on both sides, on the JAX side by a
subclass of LidarBEVEncoder that the JAX head picks up by name while the
step is traced.

The seeds keep every leaf's grad within 2e-4 under a 1e-6 change of the
weights.  With the DPG on, the encoder's levels also feed the DPG's
staircase, whose grads at this width move by 5e-4 to 1e-1 of a leaf's
largest under that change at every one of 32 seeds tried (and JAX's and
the port's by 0.2% at the best): that path is held in predict
(test_torch_port_options_train.py).  This file takes ~60 s alone on a
cold JAX cache: the JAX step's compile (64 gathers and their grads)."""

import dataclasses

import torch

from srfdet3d_tpu import configs as jconfigs
from srfdet3d_tpu.models import deform_attn as j_deform_attn
from srfdet3d_torch import configs as tconfigs
from srfdet3d_torch.models.detector import SRFDet
from srfdet3d_torch.train.trainer import make_optimizer, train_step
from srfdet3d_torch.utils.jax_params import load_jax_params
from torch_port_common import (T, compare_train_step, jax_train_step,
                               port_step_result)

OPTS = dict(with_lidar_encoder=True, with_dpg=False)
WEIGHT_SEED, BATCH_SEED = 1, 5


class _EncoderNoDropout(j_deform_attn.LidarBEVEncoder):
    dropout: float = 0.0


def _cfg(mod):
    cfg = mod.tiny_test_config(points_cap=256, voxels_cap=256, gt_cap=4)
    return cfg.replace(head=dataclasses.replace(cfg.head, **OPTS))


def test_encoder_train_step_matches_jax(monkeypatch):
    monkeypatch.setattr(j_deform_attn, "LidarBEVEncoder", _EncoderNoDropout)
    batch, variables, out = jax_train_step(_cfg(jconfigs), 2,
                                           batch_seed=BATCH_SEED,
                                           weight_seed=WEIGHT_SEED)
    tcfg = _cfg(tconfigs)
    port = SRFDet(tcfg, device="cpu")
    load_jax_params(port, variables)
    port.bbox_head.lidar_encoder.dropout_rate = 0.0
    assert not hasattr(port.bbox_head, "dpg_fc1")
    assert port.bbox_head.init_proposal_boxes.shape[0] == \
        tcfg.head.num_proposals
    opt = make_optimizer(port, tcfg, 100)
    metrics = train_step(port, opt, {k: T(v) for k, v in batch.items()},
                         torch.Generator().manual_seed(0))
    compare_train_step(tcfg, port_step_result(port, metrics), variables,
                       out)

