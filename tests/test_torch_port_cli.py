"""The port's train and test entry points on the CPU, at the tiny config:
`python -m srfdet3d_torch.tools.train` and `python -m
srfdet3d_torch.tools.test` in subprocesses (synthetic scenes, a
checkpoint, the results dump and --eval-from-pkl); a run from a
nuScenes-format root on disk (info pickles, sweeps, the GT database, CBGS,
gradient accumulation, the eval hook); and a SIGTERM mid-epoch whose
preemption checkpoint resumes to the same weights, bit for bit, as an
uninterrupted run."""

import os
import pickle
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from srfdet3d_torch.data import synthetic_root
from srfdet3d_torch.tools import test as test_cli
from srfdet3d_torch.tools import train as train_cli
from srfdet3d_torch.train import trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the tiny models gain nothing from more, and
    the suite runs several test processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(module, *args):
    out = subprocess.run(
        [sys.executable, "-m", f"srfdet3d_torch.tools.{module}", *args],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_train_then_test_in_subprocesses(tmp_path):
    wd = str(tmp_path / "wd")
    log = run("train", "tiny", "--synthetic", "--synthetic-length", "4",
              "--batch-size", "2", "--epochs", "1", "--device", "cpu",
              "--work-dir", wd, "--log-interval", "1")
    assert "iter 2" in log and "training done" in log
    ckpt = os.path.join(wd, "tiny", "epoch_1.pt")
    for f in ("epoch_1.pt", "epoch_1.pt.meta.json", "config.json",
              "env.json"):
        assert os.path.exists(os.path.join(wd, "tiny", f)), f
    out = str(tmp_path / "res.pkl")
    log = run("test", "tiny", ckpt, "--synthetic", "--synthetic-length", "3",
              "--batch-size", "2", "--device", "cpu", "--out", out)
    assert "loaded" in log and "@ step 2" in log and "'mAP'" in log
    with open(out, "rb") as f:
        dump = pickle.load(f)
    assert len(dump["gts"]) == len(dump["preds"]) == 3   # tail padded
    again = run("test", "tiny", "--eval-from-pkl", out, "--device", "cpu")
    assert again.strip().splitlines()[-1].startswith("{'mAP'")


def test_train_and_test_from_a_data_root(tmp_path):
    r = synthetic_root.write_nuscenes_root(
        str(tmp_path / "nus"), n_train=3, n_val=3, points=1500, sweeps=2,
        boxes=12, db_per_class=2, seed=4)
    wd = str(tmp_path / "wd")
    common = ["--data-root", r["root"], "--device", "cpu"]
    nus = ["--cfg-options", 'class_names=["car","truck","pedestrian"]']
    rec = train_cli.main(["tiny", "--epochs", "1", "--batch-size", "4",
                          "--db-info", r["db"], "--work-dir", wd,
                          "--eval-interval", "1",
                          *common, *nus, "optim.accum_steps=2"])
    # CBGS over the three frames and classes, two microbatches a step
    assert rec["batch_size"] == 4 and rec["steps_per_epoch"] >= 2
    assert len(rec["step_ms"]) == rec["last_step"] == rec["steps_per_epoch"]
    assert all(np.isfinite(v) for v in rec["metrics"].values())
    res = test_cli.main(["tiny", rec["checkpoint"], "--batch-size", "2",
                         "--out", str(tmp_path / "res.pkl"), *common, *nus])
    assert np.isfinite(res["mAP"]) and np.isfinite(res["NDS"])
    with open(tmp_path / "res.pkl", "rb") as f:
        dump = pickle.load(f)
    assert len(dump["preds"]) == 3
    assert set(np.concatenate([g["labels_name"] for g in dump["gts"]])) <= \
        {"car", "truck", "pedestrian"}


def test_preemption_resumes_like_an_uninterrupted_run(tmp_path,
                                                      monkeypatch):
    args = ["tiny", "--synthetic", "--synthetic-length", "8",
            "--batch-size", "2", "--epochs", "1", "--device", "cpu",
            "--cfg-options", "head.dropout=0.1"]
    straight = train_cli.main(args + ["--work-dir", str(tmp_path / "a")])
    assert straight["last_step"] == 4 and not straight["preempted"]

    real = trainer.train_step
    calls = []

    def preempting_step(*a, **kw):
        out = real(*a, **kw)
        calls.append(1)
        if len(calls) == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    monkeypatch.setattr(trainer, "train_step", preempting_step)
    handler = signal.getsignal(signal.SIGTERM)
    cut = train_cli.main(args + ["--work-dir", str(tmp_path / "b")])
    monkeypatch.setattr(trainer, "train_step", real)
    assert cut["preempted"] and cut["last_step"] == 2
    assert cut["checkpoint"].endswith("preempt_2.pt")
    assert signal.getsignal(signal.SIGTERM) == handler     # restored
    resumed = train_cli.main(args + ["--work-dir", str(tmp_path / "b"),
                                     "--resume-from", cut["checkpoint"]])
    assert resumed["first_step"] == 2 and resumed["last_step"] == 4
    assert len(resumed["step_ms"]) == 2             # the epoch's rest only
    a = torch.load(straight["checkpoint"], weights_only=True)
    b = torch.load(resumed["checkpoint"], weights_only=True)
    assert a["step"] == b["step"] == 4
    for k in a["model"]:
        torch.testing.assert_close(b["model"][k], a["model"][k], rtol=0,
                                   atol=0, msg=k)
    for k in ("mu", "nu"):
        torch.testing.assert_close(b["opt"][k], a["opt"][k], rtol=0, atol=0)


def test_cfg_options():
    from srfdet3d_torch.configs import get_config
    cfg = train_cli.apply_cfg_options(
        get_config("tiny"), ["optim.lr=1e-4", "head.num_proposals=12",
                             "name=x", 'class_names=["a","b"]'])
    assert cfg.optim.lr == 1e-4 and cfg.head.num_proposals == 12
    assert cfg.name == "x" and list(cfg.class_names) == ["a", "b"]
