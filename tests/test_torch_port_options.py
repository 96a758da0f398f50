"""PyTorch port vs JAX package: the head options no shipped config turns
on, through the detector.

A tiny predict with the deformable BEV encoder (`with_lidar_encoder`) and
the head without its DPG (`with_dpg=False`) against JAX, at
check_predict's tolerances (the encoder under the DPG:
test_torch_port_options_train.py); `head.remat` grads bit-equal to the plain
step's with dropout on (head and encoder) and the same generator, and the
generator left where the plain step leaves it; the bfloat16 compute modes,
refused until they were ported, each building and predicting; one CPU run
of the train CLI with `loss.assigner=hungarian
head.with_lidar_encoder=true`."""

import dataclasses

import numpy as np
import pytest
import torch

from srfdet3d_tpu import configs as jconfigs
from srfdet3d_torch import configs as tconfigs
from srfdet3d_torch.config import ImgBranchConfig
from srfdet3d_torch.models.detector import SRFDet
from srfdet3d_torch.tools import train as train_cli
from srfdet3d_torch.train.trainer import losses_of
from torch_port_common import check_predict


def _tiny(mod, **head):
    cfg = mod.tiny_test_config()
    return cfg.replace(head=dataclasses.replace(cfg.head, **head))


def test_encoder_without_dpg_predict_matches_jax():
    """Both options at once: the encoded levels feed the RoIs, and the
    proposals are the learned set itself."""
    opts = dict(with_lidar_encoder=True, with_dpg=False)
    out = check_predict(_tiny(jconfigs, **opts), _tiny(tconfigs, **opts))
    assert out["valid"].any()


def _grads(cfg, batch, seed):
    model = SRFDet(cfg, device="cpu", seed=1)
    model.train()
    gen = torch.Generator().manual_seed(seed)
    losses = losses_of(model, batch, gen)
    sum(losses.values()).backward()
    return ({k: v.detach() for k, v in losses.items()},
            {n: p.grad for n, p in model.named_parameters()},
            gen.get_state())


def test_remat_grads_bit_equal():
    """remat recomputes every head iteration in the backward pass with the
    dropout masks its forward drew: the losses and every grad equal the
    plain step's bit for bit, and the generator ends where the plain
    step's does."""
    import chip_smoke
    base = tconfigs.tiny_test_config(points_cap=256, voxels_cap=256,
                                     gt_cap=4)
    base = base.replace(head=dataclasses.replace(
        base.head, dropout=0.1, with_lidar_encoder=True))
    batch = chip_smoke.synthetic_batch(base, 2, seed=5, with_gt=True)
    plain = _grads(base, batch, 7)
    remat = _grads(base.replace(head=dataclasses.replace(
        base.head, remat=True)), batch, 7)
    for k, v in plain[0].items():
        assert torch.equal(remat[0][k], v), k
    for n, g in plain[1].items():
        assert g is not None and torch.equal(remat[1][n], g), n
    assert torch.equal(remat[2], plain[2])
    # the masks matter: another seed gives other grads
    other = _grads(base, batch, 8)
    assert not torch.equal(other[1]["bbox_head.heads.0.ffn1.weight"],
                           plain[1]["bbox_head.heads.0.ffn1.weight"])


@pytest.mark.parametrize("where", ["model", "image branch"])
def test_bfloat16_is_refused(where):
    """The bfloat16 compute modes were the last refusal; now each builds
    and runs a tiny predict: the model's whole forward in bf16, or a tiny
    LC model's image branch in bf16 under a float32 model (its features
    cast back before the head); boxes float32, outputs finite
    (`test_torch_port_bf16*.py` hold them against JAX)."""
    import chip_smoke
    if where == "model":
        cfg = tconfigs.tiny_test_config(compute_dtype="bfloat16")
        expect = (torch.bfloat16, torch.bfloat16)
    else:
        cfg = tconfigs.tiny_lc_test_config("vovnet", compute_dtype="bfloat16")
        expect = (torch.float32, torch.bfloat16)
    model = SRFDet(cfg, device="cpu", seed=0)
    assert (model.dtype, model.img_dtype) == expect
    batch = (chip_smoke.synthetic_batch(cfg, 1) if where == "model"
             else chip_smoke.train_batch(cfg, 1, seed=0))
    out = model.predict(batch)
    assert out["boxes"].dtype == torch.float32
    assert torch.isfinite(out["boxes"]).all()
    assert torch.isfinite(out["scores"]).all()


def test_train_cli_with_hungarian_and_encoder(tmp_path):
    rec = train_cli.main([
        "tiny", "--synthetic", "--synthetic-length", "4", "--batch-size",
        "2", "--epochs", "1", "--device", "cpu", "--work-dir",
        str(tmp_path), "--cfg-options", "loss.assigner=hungarian",
        "head.with_lidar_encoder=true"])
    model = rec["model"]
    assert model.cfg.loss.assigner == "hungarian"
    assert model.bbox_head.lidar_encoder is not None
    assert rec["last_step"] == 2
    assert all(np.isfinite(v) for v in rec["metrics"].values())
