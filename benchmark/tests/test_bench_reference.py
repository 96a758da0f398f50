"""The plain reference (benchmark/reference) against the system
(srfdet3d_torch, whose CPU path runs its kernels' plain versions) at the
tiny configs: a predict, and one train step's losses, grads and update."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import compare, port, scene
from benchmark.cells import INPUT_KEYS, TRAIN_KEYS, to_device

from .bench_common import tiny_tweak

SEED = 2026


def _setup(lc: bool, mode: str, batch: int):
    """A config file (L or LC) under a traffic file of the mode, cut to the
    tiny config on the CPU."""
    from benchmark.registry import Registry
    reg = Registry()
    doc = reg.config(reg.cell("nusc_LC.predict.stream" if lc
                              else "nusc_L.predict.stream"))
    traffic = json.loads(reg.traffic_path(
        "lidar_stream" if mode == "predict" else "lidar_train_b6")
        .read_text())
    tiny_tweak(lc)(doc, traffic)
    traffic["batch"] = batch
    dev = torch.device("cpu")
    pool = scene.make_pool(traffic, doc, SEED, dev)
    return doc, pool, dev


@pytest.mark.parametrize("lc", [False, True])
def test_predict_matches_the_system(lc):
    doc, pool, dev = _setup(lc, "predict", 1)
    net = port.model(port.config(doc), SEED, dev)
    ref_cfg, ref = compare.reference(doc, SEED, dev)
    batch = to_device(pool[0], INPUT_KEYS, dev)
    with torch.no_grad():
        got, want = net(batch), ref(batch)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
        ans = net.predict(batch)
        dec = compare.decode(ref_cfg, want[0][-1], want[1][-1])
    assert compare.same_answer(ans, dec)


@pytest.mark.parametrize("lc", [False, True])
def test_train_step_matches_the_system(lc):
    doc, pool, dev = _setup(lc, "train", 1 if lc else 2)
    cfg = port.config(doc)
    net = port.model(cfg, SEED, dev)
    opt = port.optimizer(net, cfg, 1000)
    before = torch.cat([p.detach().reshape(-1) for p in opt.params])
    out = port.train_step(net, opt, to_device(pool[0], TRAIN_KEYS, dev),
                          port.step_generator(net, SEED, 0))
    after = torch.cat([p.detach().reshape(-1) for p in opt.params])
    ref = compare.reference_steps(doc, SEED, pool, dev, 1, None)
    assert float(out["loss"]) == pytest.approx(ref["losses"][0]["loss"],
                                               rel=1e-5)
    torch.testing.assert_close(opt.mu.cpu(), ref["mu_after"][0],
                               rtol=1e-4, atol=1e-7)
    torch.testing.assert_close(before, ref["theta0"])
    # Adam's first update is +-lr on a leaf whose gradient is round-off
    # alone (its sign then decides), so the parameters agree within 2 lr
    torch.testing.assert_close(after, ref["params_after"][0], rtol=0,
                               atol=2 * cfg.optim.lr)


def test_the_reference_follows_the_systems_steps():
    """The reference, following the system's checked steps (their states
    and decisions, decisions.py), reads each step's losses and gradients
    to rounding, and plays back every decision the system took."""
    from benchmark import cells
    doc, pool, dev = _setup(False, "train", 2)
    cfg = port.config(doc)
    cell = cells.TrainCell(cfg, port.model(cfg, SEED, dev), pool, dev, SEED)
    cell.warm()
    rec = cell.record
    assert [len(d["relu"]) for d in rec["decisions"]][0] > 10
    assert all(len(d[k]) for d in rec["decisions"]
               for k in ("level", "corners", "ota", "extreme", "clip"))
    ref = compare.reference_steps(doc, SEED, pool, dev, cells.CHECKED_STEPS,
                                  rec)
    assert ref["followed"]
    got = compare.train_readings(rec, ref)
    assert got["loss_gap"] < 1e-5 and got["grad_gap"] < 1e-4, got
    assert got["change_gap"] < 1e-4 and got["theta0_gap"] == 0.0, got
    assert got["assign_wrong"] == 0.0
    # every sparse conv's weight gradient probed, and held to rounding
    assert len(rec["conv_probes"]) == len(ref["conv_gaps"]) > 5
    assert got["k3_dw_gap"] < 1e-5 and got["k4_dw_gap"] < 1e-5, got
