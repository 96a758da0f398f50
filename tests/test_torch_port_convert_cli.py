"""A reference checkpoint through the port's CLIs on the CPU, at the tiny
configs: `srfdet3d_torch.tools.convert_checkpoint` writes the port's
checkpoint from a seeded mm-stack `.pth` (the `{"state_dict", "meta"}`
wrapper with mmdet's `module.` prefix, or a bare state dict; spconv KIO or
OKI), `tools.test` evaluates it and `tools.train --load-from` fine-tunes
from it, and its weights and predictions equal those of the JAX route
(the JAX package's convert_reference_state_dict, then load_jax_params),
exactly.  Also: the meta file, a partial checkpoint, the zero-match
refusal, `tools.eval_results_from_pkl` and the train CLI's --debug-nans."""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from srfdet3d_tpu import configs as jconfigs
from srfdet3d_tpu.utils.torch_convert import (
    convert_reference_state_dict as j_convert)
from srfdet3d_torch import configs as tconfigs
from srfdet3d_torch.data import SyntheticDataset, data_loader
from srfdet3d_torch.models.detector import SRFDet
from srfdet3d_torch.tools import convert_checkpoint, eval_results_from_pkl
from srfdet3d_torch.tools import test as test_cli
from srfdet3d_torch.tools import train as train_cli
from srfdet3d_torch.train import trainer
from srfdet3d_torch.utils.checkpoint import load_for_eval
from srfdet3d_torch.utils.jax_params import load_jax_params
from torch_port_common import reference_state, spconv_to_oki, uniform_points

CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the tiny models gain nothing from more, and
    the suite runs several test processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_pth(path, state, wrapped):
    """torch.save a reference state dict as mmdet writes it (wrapped:
    {"state_dict": module.-prefixed tensors, "meta": ...}) or bare."""
    tensors = {k: torch.as_tensor(np.asarray(v)) for k, v in state.items()}
    if wrapped:
        tensors = {"state_dict": {f"module.{k}": v
                                  for k, v in tensors.items()},
                   "meta": {"epoch": 20, "mmdet_version": "2.x"}}
    torch.save(tensors, path)
    return str(path)


def jax_route_model(name, state, layout="KIO"):
    tcfg = tconfigs.get_config(name)
    model = SRFDet(tcfg, device="cpu", seed=7)
    load_jax_params(model, j_convert(state, jconfigs.get_config(name),
                                     spconv_layout=layout))
    return model


@pytest.mark.parametrize("name,wrapped,layout", [
    ("tiny", True, "KIO"), ("tiny_kitti", False, "OKI"),
    ("tiny_pillar", True, "KIO")])
def test_converted_checkpoint_through_the_clis(tmp_path, name, wrapped,
                                               layout):
    tcfg = tconfigs.get_config(name)
    state = reference_state(tcfg, seed=5)
    src = spconv_to_oki(state) if layout == "OKI" else state
    pth = write_pth(tmp_path / "ref.pth", src, wrapped)
    out = str(tmp_path / "conv" / "port.pt")
    meta = convert_checkpoint.main([name, pth, out, "--spconv-layout",
                                    layout])
    with open(out + ".meta.json") as f:
        assert json.load(f) == meta
    ref = jax_route_model(name, src, layout)
    want = {k: v for k, v in ref.state_dict().items()
            if not k.endswith("num_batches_tracked")}
    assert meta["tensors"] == len(want) and meta["unset_port_tensors"] == 0
    assert meta["unused_reference_keys"] == sum(
        k.endswith("num_batches_tracked") or k == "bbox_head.code_weights"
        for k in state)

    # the test CLI's load path: every tensor the JAX route's, bit for bit
    model = SRFDet(tcfg, device="cpu", seed=8)
    assert load_for_eval(out, model) == 0
    got = model.state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    pts, mask = uniform_points(tcfg, 2, seed=1)
    batch = {"points": torch.from_numpy(pts),
             "points_mask": torch.from_numpy(mask)}
    a, b = model.predict(batch), ref.predict(batch)
    assert a["valid"].sum() > 0
    for k in ("boxes", "scores", "labels", "valid"):
        assert torch.equal(a[k], b[k]), k

    # tools.test on synthetic frames: its dump is the JAX route model's
    # predictions; eval_results_from_pkl gives its metrics again
    dump = str(tmp_path / "res.pkl")
    res = test_cli.main([name, out, "--synthetic", "--synthetic-length", "2",
                         "--batch-size", "2", "--out", dump, *CPU])
    with open(dump, "rb") as f:
        frames = pickle.load(f)["preds"]
    ds = SyntheticDataset(tcfg, length=2, test_mode=False, augment=False)
    batch = next(data_loader(ds, 2, shuffle=False, num_workers=0))
    pred = {k: v.numpy() for k, v in ref.predict(
        {k: torch.from_numpy(v) for k, v in batch.items()
         if k not in test_cli.GT_KEYS}).items()}
    _, preds = test_cli.frames_from_outputs(tcfg, pred, batch, 2)
    for p, d in zip(preds, frames):
        np.testing.assert_array_equal(p["boxes"], d["boxes"])
        np.testing.assert_array_equal(p["scores"], d["scores"])
        assert list(p["labels_name"]) == list(d["labels_name"])
    again = eval_results_from_pkl.main([name, dump, *CPU])
    scalars = {k: v for k, v in res.items() if isinstance(v, float)}
    assert scalars and {k: again[k] for k in scalars} == scalars

    # tools.train --load-from: a step at lr 0 keeps the loaded weights
    rec = train_cli.main([name, "--synthetic", "--synthetic-length", "2",
                          "--batch-size", "2", "--epochs", "1", "--load-from",
                          out, "--work-dir", str(tmp_path / "wd"), *CPU,
                          "--cfg-options", "optim.lr=0.0"])
    assert rec["last_step"] == 1
    for k, p in rec["model"].named_parameters():
        assert torch.equal(p.detach(), want[k]), k


def test_partial_checkpoint_and_zero_match(tmp_path):
    """A checkpoint without the head converts the rest, the meta file
    counts the head's tensors as unset, and the test CLI's load keeps the
    head's initialisation; a checkpoint that matches nothing writes no
    file."""
    name = "tiny"
    state = reference_state(tconfigs.get_config(name), seed=6)
    headless = {k: v for k, v in state.items()
                if not k.startswith("bbox_head.")}
    out = str(tmp_path / "headless.pt")
    meta = convert_checkpoint.main(
        [name, write_pth(tmp_path / "h.pth", headless, True), out])
    model = SRFDet(tconfigs.get_config(name), device="cpu", seed=3)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    head = [k for k in init if k.startswith("bbox_head.")
            and not k.endswith("num_batches_tracked")]
    assert meta["unset_port_tensors"] == len(head) > 0
    load_for_eval(out, model)
    ref = jax_route_model(name, state).state_dict()
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        assert torch.equal(v, init[k] if k in head else ref[k]), k

    stray = write_pth(tmp_path / "other.pth",
                      {"backbone.conv.weight": np.ones((2, 2), np.float32)},
                      True)
    bad = str(tmp_path / "none.pt")
    with pytest.raises(SystemExit, match="ZERO"):
        convert_checkpoint.main([name, stray, bad])
    assert not os.path.exists(bad) and not os.path.exists(bad + ".meta.json")


def test_debug_nans_raises_at_a_non_finite_loss(tmp_path, monkeypatch):
    """--debug-nans: the steps run under autograd's anomaly detection,
    a non-finite loss raises FloatingPointError, and the mode is off again
    after the run; without the flag the same run ends normally."""
    real = trainer.train_step
    anomaly = []

    def nan_step(*args, **kw):
        anomaly.append(torch.is_anomaly_enabled())
        metrics = real(*args, **kw)
        metrics["loss"] = metrics["loss"] * float("nan")
        return metrics

    monkeypatch.setattr(trainer, "train_step", nan_step)
    argv = ["tiny", "--synthetic", "--synthetic-length", "2", "--batch-size",
            "2", "--epochs", "1", "--work-dir", str(tmp_path), *CPU]
    with pytest.raises(FloatingPointError, match="step 0"):
        train_cli.main(argv + ["--debug-nans"])
    assert anomaly == [True] and not torch.is_anomaly_enabled()
    rec = train_cli.main(argv)
    assert anomaly == [True, False] and rec["last_step"] == 1
