"""The train CLI on two gloo ranks (`tiny`, generated scenes, the CPU):
the global batch, the rank-0-only files, --eval-interval's skip, and
preemption when the signal reaches one rank only.

Rank 1 sends itself SIGTERM after its second step.  Both ranks agree on
the flag after that step, save `preempt_2.pt` once (rank 0 writes it),
and return preempted at step 2 of the epoch's 4, bit for bit equal; a
second 2-rank run resumes from the file on both ranks, at step 2, and
ends at step 4 with the ranks still equal.
"""

import os
import pickle
import signal
import sys

import numpy as np
import torch


def _argv(work, extra=()):
    return ["tiny", "--synthetic", "--synthetic-length", "48",
            "--device", "cpu", "--epochs", "1", "--log-interval", "1",
            "--work-dir", work, *extra]


def worker(mode, work):
    torch.set_num_threads(1)
    from torch_port_dist import worker_finish
    from srfdet3d_torch.tools import train as train_cli
    from srfdet3d_torch.train import trainer
    rank = int(os.environ["RANK"])
    if mode == "preempt":
        plain, calls = trainer.train_step, []

        def step(*args, **kwargs):
            out = plain(*args, **kwargs)
            calls.append(1)
            if rank == 1 and len(calls) == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return out
        trainer.train_step = step
        rec = train_cli.main(_argv(work, ["--eval-interval", "1"]))
    else:
        ckpt = os.path.join(work, "tiny", "preempt_2.pt")
        rec = train_cli.main(_argv(os.path.join(work, "resumed"),
                                   ["--resume-from", ckpt]))
    out = {k: rec[k] for k in ("preempted", "first_step", "last_step",
                               "batch_size", "steps_per_epoch",
                               "checkpoint", "metrics")}
    out["state"] = {k: v.numpy() for k, v in
                    rec["model"].state_dict().items()}
    with open(os.path.join(work, f"{mode}_rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    worker_finish()


def test_preempt_on_one_rank_stops_both_and_resumes(tmp_path):
    from torch_port_dist import check_ranks, run_ranks
    work = str(tmp_path)
    runs = {}
    for mode in ("preempt", "resume"):
        runs[mode] = run_ranks(__file__, [mode, work], world=2, timeout=120)
        check_ranks(runs[mode])
    outs = {mode: [pickle.load(open(os.path.join(
        work, f"{mode}_rank{r}.pkl"), "rb")) for r in (0, 1)]
        for mode in runs}
    for r, rec in enumerate(outs["preempt"]):
        # tiny: batch_size_per_device 6 x 2 ranks; 48 frames -> 4 steps
        assert rec["batch_size"] == 12 and rec["steps_per_epoch"] == 4
        assert rec["preempted"] and rec["last_step"] == 2, (r, rec)
        assert rec["checkpoint"].endswith("preempt_2.pt")
    for rec in outs["resume"]:
        assert not rec["preempted"]
        assert (rec["first_step"], rec["last_step"]) == (2, 4)
    for mode in runs:
        a, b = outs[mode]
        assert a["metrics"] == b["metrics"]
        for k, v in a["state"].items():
            np.testing.assert_array_equal(v, b["state"][k], err_msg=k)
    files = sorted(os.listdir(os.path.join(work, "tiny")))
    assert files == ["config.json", "env.json", "preempt_2.pt",
                     "preempt_2.pt.meta.json"], files
    log0, log1 = (text for _, text in runs["preempt"])
    assert "ranks=2 batch=12" in log0 and "saved" in log0
    assert "preemption signal on another rank: saved" in log0
    assert "eval-interval: skipped with more than one rank" in log0
    assert "iter 1" in log0 and "iter 1" not in log1      # rank 0 logs


if __name__ == "__main__":
    worker(*sys.argv[1:])
