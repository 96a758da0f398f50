"""PyTorch port vs JAX package: the image branch in bfloat16.

`tests/test_bf16.py:34-80`'s tiny LC model (VoVNet-19-slim, one camera of
32 x 32, a 32-channel image neck), on a camera that sees every box from
the front (`front_camera`): the image branch in
bf16 under a float32 model (`img.compute_dtype="bfloat16"`, JAX
`config.py:88-93`), and the bf16 model whose image branch inherits its
dtype (`img.compute_dtype=""`, JAX `detector.py:152-158`).  The branch
alone in bf16 feeds the float32 head through the cast back to the model's
dtype: the port's outputs must sit at most a third as far from JAX's bf16
outputs (compiled without excess precision) as those sit from JAX's
float32 ones, for the logits and the box centres of every layer
(measured on these seeds: logits 3.2e-4, centres 5.1e-4).  The bf16 model
is held to a weaker rule, closer than JAX bf16 is to float32 (measured: logits 0.58, centres 0.39): its head
rounds the float32 RoIAlign of the image and BEV levels to bf16 at the
fusion's Dense, and float32 noise in the RoIs (the corner projections,
the sample positions: the two packages' float32 ops differ in the last bit
on ~10% of the RoI coordinates) flips an ulp there, which the iterations
carry on.  The LiDAR-only bf16 model, which has no such cast, is held at a
third (`test_torch_port_bf16.py`)."""

import dataclasses

import numpy as np
import pytest
import torch

from srfdet3d_tpu import config as jconfig
from srfdet3d_tpu import configs as jconfigs
from srfdet3d_torch import config as tconfig
from srfdet3d_torch import configs as tconfigs
from torch_port_common import bf16_predict_ratios

BF = torch.bfloat16
# the largest ratio allowed: the branch alone, and the bf16 model
MAX_RATIO = (1 / 3, 1.0)


def _lc(config, configs, **model):
    base = configs.tiny_test_config(
        use_img=True, img=config.ImgBranchConfig(
            backbone="vovnet-19-slim", num_cams=1, neck_out_channels=32,
            img_shape=(32, 32)), **model)
    return base.replace(head=dataclasses.replace(base.head,
                                                 feat_channels_img=32))


def front_camera(h: int, w: int, f: float = 8.0) -> np.ndarray:
    """(4, 4) float32: a pinhole camera at x = -15 looking along +x, so
    every box within the tiny range (|x| <= 10) lies 3 m or more in front
    of it.  A box behind a camera projects through the depth clamp to a
    RoI of ~1e5 pixels, whose float32 sample positions cannot resolve a
    pixel: its pooled values are rounding noise, which swamps bf16's
    (JAX's own eager and jitted bf16 programs differ in 74% of the logits
    on the surround rig of lidar2img_rig)."""
    k = np.array([[f, 0, w / 2, 0], [0, f, h / 2, 0], [0, 0, 1, 0],
                  [0, 0, 0, 1]], np.float64)
    e = np.array([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 15.0],
                  [0, 0, 0, 1]], np.float64)
    return (k @ e).astype(np.float32)


def _img16(cfg):
    return cfg.replace(img=dataclasses.replace(cfg.img,
                                               compute_dtype="bfloat16"))


@pytest.fixture(scope="module")
def lc_bf16():
    rng = np.random.default_rng(0)
    extra = {"images": rng.normal(size=(2, 1, 32, 32, 3)).astype(np.float32),
             "lidar2img": np.ascontiguousarray(np.broadcast_to(
                 front_camera(32, 32), (2, 1, 4, 4)))}
    cases = [(_img16(_lc(jconfig, jconfigs)), _img16(_lc(tconfig, tconfigs))),
             (_lc(jconfig, jconfigs, compute_dtype="bfloat16"),
              _lc(tconfig, tconfigs, compute_dtype="bfloat16"))]
    return bf16_predict_ratios(_lc(jconfig, jconfigs), cases, extra=extra)


@pytest.mark.parametrize("mode", [0, 1], ids=["image_branch", "model"])
def test_bf16_lc_predict_rounds_where_jax_rounds(lc_bf16, mode):
    ratios, _, _ = lc_bf16[mode]
    for key, r in ratios.items():
        assert r < MAX_RATIO[mode] if mode else r <= MAX_RATIO[mode], (key, r)


def test_image_branch_dtypes(lc_bf16):
    """img.compute_dtype alone: the backbone and neck in bf16, the rest of
    the model (and its logits) float32; the bf16 model's branch inherits
    bf16; every parameter float32 in both."""
    (_, img_only, (logits, _)), (_, model16, (logits16, _)) = lc_bf16
    assert img_only.dtype == torch.float32 and img_only.img_dtype == BF
    assert img_only.img_backbone.stem1.conv.dtype == BF
    assert img_only.img_neck.lateral[0].conv.dtype == BF
    assert img_only.bbox_head.heads[0].ffn1.dtype == torch.float32
    assert logits.dtype == torch.float32
    assert model16.img_dtype == BF and logits16.dtype == BF
    for m in (img_only, model16):
        assert all(p.dtype == torch.float32 for p in m.parameters())
