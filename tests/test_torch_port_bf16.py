"""PyTorch port vs JAX package: the bfloat16 compute mode of the whole
LiDAR model (`compute_dtype="bfloat16"`, JAX `config.py:250-253`,
`models/detector.py:68-71`).

A tiny predict on the port and in JAX, in bf16 and in float32, from the
same weights: the port's bf16 outputs must sit at most a third as far
from JAX's bf16 outputs as those sit from JAX's float32 ones, for the
logits and the box centres of every layer (mean absolute distances),
which holds only where the port rounds where the JAX package rounds.  The
JAX bf16 program compiles without XLA's excess precision
(`torch_port_common.EXACT_BF16`).  Measured on these seeds: logits 0.0
(bit for bit), centres 1.1e-5 (the RoIAlign's float32 sums in another
order).  Boxes stay float32, the parameters float32, the outputs finite
(`tests/test_bf16.py:13-28`).  The refusal tests that stood here turned
into runs of both modes (`test_torch_port_options.py`,
`test_torch_port_lc_detector.py`)."""

import dataclasses

import numpy as np
import pytest
import torch

from srfdet3d_tpu import configs as jconfigs
from srfdet3d_torch import configs as tconfigs
from srfdet3d_torch.config import ImgBranchConfig
from srfdet3d_torch.models.detector import SRFDet, compute_dtypes
from torch_port_common import bf16_predict_ratios

BF = torch.bfloat16
# the largest ratio each check allows
MAX_RATIO = 1 / 3


@pytest.fixture(scope="module")
def lidar_bf16():
    return bf16_predict_ratios(
        jconfigs.tiny_test_config(),
        [(jconfigs.tiny_test_config(compute_dtype="bfloat16"),
          tconfigs.tiny_test_config(compute_dtype="bfloat16"))])[0]


def test_bf16_predict_rounds_where_jax_rounds(lidar_bf16):
    ratios, _, _ = lidar_bf16
    for key, r in ratios.items():
        assert r <= MAX_RATIO, (key, r)


def test_bf16_predict_dtypes(lidar_bf16):
    """bf16 logits, float32 boxes, float32 parameters and statistics; the
    decode takes float32 boxes and scores (JAX `head.py:685-686`)."""
    _, port, (logits, boxes) = lidar_bf16
    assert logits.dtype == BF and boxes.dtype == torch.float32
    assert port.dtype == BF and port.img_dtype == BF
    assert all(p.dtype == torch.float32 for p in port.parameters())
    assert all(b.dtype in (torch.float32, torch.int64)
               for b in port.buffers())
    assert port.pts_middle_encoder.conv_input.dtype == BF
    import chip_smoke
    out = port.predict(chip_smoke.synthetic_batch(port.cfg, 1))
    assert out["boxes"].dtype == torch.float32
    assert out["scores"].dtype == torch.float32
    assert np.isfinite(out["boxes"].numpy()).all()


@pytest.mark.parametrize("model,img,expect", [
    ("float32", "", (torch.float32, torch.float32)),
    ("bfloat16", "", (BF, BF)),
    ("float32", "bfloat16", (torch.float32, BF)),
    ("bfloat16", "float32", (BF, torch.float32)),
    ("bfloat16", "bfloat16", (BF, BF)),
    ("float16", "", (torch.float32, torch.float32)),
])
def test_compute_dtypes(model, img, expect):
    """Any string but "bfloat16" means float32, in both fields; an empty
    image dtype inherits the model's (JAX `detector.py:152-158`)."""
    cfg = tconfigs.tiny_test_config(compute_dtype=model, use_img=True,
                                    img=ImgBranchConfig(compute_dtype=img))
    assert compute_dtypes(cfg) == expect


def test_both_modes_build_and_run():
    """compute_dtype and img.compute_dtype together on a tiny LC model:
    the LiDAR branch and head in bf16, the image branch in bf16, every
    parameter float32, a predict's outputs finite."""
    import chip_smoke
    cfg = tconfigs.tiny_lc_test_config("vovnet", img_shape=(64, 128))
    cfg = cfg.replace(compute_dtype="bfloat16", img=dataclasses.replace(
        cfg.img, compute_dtype="bfloat16"))
    model = SRFDet(cfg, device="cpu", seed=0)
    assert model.img_backbone.stem1.conv.dtype == BF
    assert model.bbox_head.heads[0].ffn1.dtype == BF
    assert all(p.dtype == torch.float32 for p in model.parameters())
    batch = chip_smoke.train_batch(cfg, 1, seed=0)
    with torch.no_grad():
        logits, boxes = model(batch)
    assert logits.dtype == BF and boxes.dtype == torch.float32
    assert torch.isfinite(logits.float()).all()
    assert torch.isfinite(boxes).all()


@pytest.mark.parametrize("option", ["compute_dtype=bfloat16",
                                    "img.compute_dtype=bfloat16"])
def test_cli_bf16_modes(tmp_path, monkeypatch, option):
    """Each mode through the train and test CLIs' --cfg-options, tiny on
    the CPU: one epoch of two steps, then the test CLI on its checkpoint;
    the image branch's option on a tiny LC config (registered for the
    run; the synthetic scenes carry no images, so the LiDAR branch runs
    alone, as an LC model given no images does)."""
    from srfdet3d_torch.tools import test as test_cli
    from srfdet3d_torch.tools import train as train_cli
    name = "tiny"
    if option.startswith("img."):
        name = "tiny_lc_bf16_cli"
        monkeypatch.setitem(tconfigs.CONFIGS, name,
                            lambda: tconfigs.tiny_lc_test_config("vovnet"))
    wd = str(tmp_path)
    rec = train_cli.main([
        name, "--synthetic", "--synthetic-length", "4", "--batch-size", "2",
        "--epochs", "1", "--device", "cpu", "--work-dir", wd,
        "--cfg-options", option])
    model = rec["model"]
    want = BF if option.startswith("compute") else torch.float32
    assert model.dtype == want and model.img_dtype == BF
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(np.isfinite(v) for v in rec["metrics"].values())
    metrics = test_cli.main([
        name, rec["checkpoint"], "--synthetic", "--synthetic-length",
        "2", "--device", "cpu", "--cfg-options", option])
    assert "mAP" in metrics
