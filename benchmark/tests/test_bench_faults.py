"""The check sees a broken timed path: a run of the cell (tiny, on the
CPU, past the look for a card) with a fault planted underneath, and
`correct` comes out false.  Faults: an answer altered where it is
produced (predict); a step that returns its state unchanged, half of
the batch left out with the mean over the rest, and K3 or K4 returning
half its weight gradient (train).  One chip only,
so no exchange between chips exists to leave out."""

from __future__ import annotations

import pytest
import torch

from benchmark import calibrate, cells, port, run

from .bench_common import tiny_tweak


def _run(workload):
    return run.run(workload, 7, 0.5, False, device="cpu",
                   tweak=tiny_tweak("LC" in workload))


@pytest.mark.parametrize("workload", ["nusc_L.predict.stream",
                                      "nusc_L.train.b6"])
def test_sound_run_is_correct(workload):
    assert _run(workload)["correct"]


def test_altered_answer_fails(monkeypatch):
    serve = cells.PredictCell.serve

    def altered(self, i):
        ans = serve(self, i)
        ans["boxes"] = ans["boxes"] + 0.05
        return ans
    monkeypatch.setattr(cells.PredictCell, "serve", altered)
    res = _run("nusc_L.predict.stream")
    assert not res["correct"]
    assert res["failed"] > 0


def test_unchanged_state_fails(monkeypatch):
    step = port.train_step

    def frozen(net, opt, batch, gen):
        keep = [p.detach().clone() for p in opt.params]
        out = step(net, opt, batch, gen)
        with torch.no_grad():
            for p, k in zip(opt.params, keep):
                p.copy_(k)
        return out
    monkeypatch.setattr(port, "train_step", frozen)
    res = _run("nusc_L.train.b6")
    assert not res["correct"]
    assert res["check"]["change_median_gap"]["value"] > 0.5


def test_half_the_batch_fails(monkeypatch):
    step = port.train_step

    def half(net, opt, batch, gen):
        b = batch["points"].shape[0]
        return step(net, opt, {k: v[: b // 2] for k, v in batch.items()},
                    gen)
    monkeypatch.setattr(port, "train_step", half)
    assert not _run("nusc_L.train.b6")["correct"]


@pytest.mark.parametrize("fault", ["k3_dw", "k4_dw"])
def test_conv_weight_gradient_fault_fails(fault):
    undo = calibrate.FAULTS[fault]()
    try:
        res = _run("nusc_L.train.b6")
    finally:
        undo()
    assert not res["correct"]
    assert res["check"][f"{fault}_gap"]["value"] > 0.4
