"""PyTorch port vs JAX package: the options no shipped config turns on,
in the bfloat16 model (`compute_dtype="bfloat16"`).

One tiny LC predict with every one of them: the deformable BEV encoder
(`head.with_lidar_encoder`, JAX `models/deform_attn.py:63-206`, its
coordinate arithmetic in bf16 too), the head without its DPG, remat (a
no-op in predict) and the image RoIAlign's patch rule at fallback -1, on
`test_torch_port_bf16_lc.py`'s front camera.  The port's bf16 outputs must
sit closer to JAX's bf16 outputs (compiled without excess precision) than
those sit to the float32 model's, the rule of the bf16 LC model (measured
on these seeds: logits 0.44, centres 0.53).  The float32 outputs are the
port's: `test_torch_port_options.py` and `_options_roi.py` hold them to
JAX's at 1e-4, and the encoder's JAX compile is the slow one.  The encoder alone is exact:
its deformable attention, run as a JAX program on the port's inputs,
equals the port's bit for bit, but the whole JAX model compiles it to
other roundings (17% of its first layer's outputs differ by an ulp).
Boxes float32, outputs finite."""

import dataclasses

import numpy as np
import pytest
import torch

from srfdet3d_tpu import config as jconfig
from srfdet3d_tpu import configs as jconfigs
from srfdet3d_torch import config as tconfig
from srfdet3d_torch import configs as tconfigs
from test_torch_port_bf16_lc import _lc, front_camera
from torch_port_common import bf16_predict_ratios

OPTIONS = dict(with_lidar_encoder=True, with_dpg=False, remat=True,
               img_roi_patch=4, img_roi_patch_fallback=-1)


def _opts(config, configs, **model):
    cfg = _lc(config, configs, **model)
    return cfg.replace(head=dataclasses.replace(cfg.head, **OPTIONS))


@pytest.fixture(scope="module")
def options_bf16():
    rng = np.random.default_rng(1)
    extra = {"images": rng.normal(size=(2, 1, 32, 32, 3)).astype(np.float32),
             "lidar2img": np.ascontiguousarray(np.broadcast_to(
                 front_camera(32, 32), (2, 1, 4, 4)))}
    return bf16_predict_ratios(
        _opts(jconfig, jconfigs),
        [(_opts(jconfig, jconfigs, compute_dtype="bfloat16"),
          _opts(tconfig, tconfigs, compute_dtype="bfloat16"))],
        extra=extra, tcfg32=_opts(tconfig, tconfigs))[0]


def test_bf16_options_predict_closer_to_jax_bf16(options_bf16):
    ratios, port, (logits, boxes) = options_bf16
    assert port.bbox_head.lidar_encoder is not None
    assert port.bbox_head.lidar_encoder.dtype == torch.bfloat16
    assert not port.bbox_head.with_dpg and port.bbox_head.remat
    assert logits.dtype == torch.bfloat16 and boxes.dtype == torch.float32
    for key, r in ratios.items():
        assert r < 1.0, (key, r)
