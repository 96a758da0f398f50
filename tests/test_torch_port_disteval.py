"""Multi-process evaluation of the port (dist_test.sh, the JAX package's
tests/test_disteval.py): two gloo ranks each predict a strided shard of
5 synthetic frames of `tiny` with seeded weights, all-gather the frames'
fixed-shape rows and evaluate them all.

- Through the test CLI at batch 1 (each rank joins the group from the
  environment): both ranks report the one-process CLI's metrics exactly,
  and rank 0's dump equals the one-process dump exactly, frame for frame
  in dataset order (the reference's collect_results order).
- `run_inference_eval` at batch 2, where rank 0's second batch is its one
  frame padded: both ranks' metrics equal; against one process at batch 2
  the frames sit in other batches (rank 1 predicts frames 1 and 3
  together, one process frames 0 and 1), and the CPU's float sums differ
  with the batch's rows, so the dumps agree within 1e-5 and the metrics
  within 1e-6.
- Fewer frames than ranks: every rank aborts with the JAX package's
  message.
"""

import os
import pickle
import sys
import threading

import numpy as np
import pytest
import torch

FRAMES, OPTIONS = 5, ("test.score_thr=0.0",)


def _cfg():
    from srfdet3d_torch.configs import get_config
    from srfdet3d_torch.tools.train import apply_cfg_options
    return apply_cfg_options(get_config("tiny"), OPTIONS)


def _dataset(cfg, length=FRAMES):
    from srfdet3d_torch.data import SyntheticDataset
    return SyntheticDataset(cfg, length=length, test_mode=False,
                            augment=False)


def _cli_argv(ckpt, out, length=FRAMES):
    return ["tiny", ckpt, "--synthetic", "--synthetic-length", str(length),
            "--device", "cpu", "--batch-size", "1", "--out", out,
            "--cfg-options", *OPTIONS]


def worker(mode, work):
    torch.set_num_threads(1)
    from torch_port_dist import worker_finish
    from srfdet3d_torch.tools import test as test_cli
    ckpt = os.path.join(work, "model.pt")
    rank = int(os.environ["RANK"])
    if mode == "cli":
        res = test_cli.main(_cli_argv(ckpt, os.path.join(work, "dist1.pkl")))
    elif mode == "abort":
        test_cli.main(_cli_argv(ckpt, os.path.join(work, "none.pkl"), 1))
        raise AssertionError("one frame on two ranks did not abort")
    else:
        from torch_port_dist import worker_setup
        from srfdet3d_torch.models.detector import SRFDet
        from srfdet3d_torch.utils.checkpoint import load_for_eval
        worker_setup()
        cfg = _cfg()
        model = SRFDet(cfg, device="cpu")
        load_for_eval(ckpt, model)
        res = test_cli.run_inference_eval(
            cfg, _dataset(cfg), model, batch_size=2,
            out=os.path.join(work, "dist2.pkl"), device="cpu")
    with open(os.path.join(work, f"{mode}_rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)
    worker_finish()


def _scalars(res):
    return {k: v for k, v in res.items() if not isinstance(v, dict)}


@pytest.fixture(scope="module")
def disteval(tmp_path_factory):
    from torch_port_dist import run_ranks
    from srfdet3d_torch.models.detector import SRFDet
    from srfdet3d_torch.utils.checkpoint import save_checkpoint
    torch.set_num_threads(1)
    work = str(tmp_path_factory.mktemp("disteval"))
    save_checkpoint(os.path.join(work, "model.pt"),
                    SRFDet(_cfg(), device="cpu", seed=3))
    runs = {}

    def launch(mode):
        runs[mode] = run_ranks(__file__, [mode, work], world=2, timeout=120)
    threads = [threading.Thread(target=launch, args=(m,))
               for m in ("cli", "batch2", "abort")]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return work, runs


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _frames_equal(a, b, tol=0.0):
    assert len(a["preds"]) == len(b["preds"]) == FRAMES
    for part in ("gts", "preds"):
        for x, y in zip(a[part], b[part]):
            assert list(x["labels_name"]) == list(y["labels_name"])
            for k in ("boxes", "scores"):
                if k in x:
                    np.testing.assert_allclose(x[k], y[k], rtol=0, atol=tol)


def test_cli_two_ranks_equal_one_process(disteval):
    from torch_port_dist import check_ranks
    from srfdet3d_torch.tools import test as test_cli
    work, runs = disteval
    check_ranks(runs["cli"])
    ranks = [_load(os.path.join(work, f"cli_rank{r}.pkl")) for r in (0, 1)]
    single = test_cli.main(_cli_argv(os.path.join(work, "model.pt"),
                                     os.path.join(work, "single1.pkl")))
    assert _scalars(ranks[0]) == _scalars(ranks[1]) == _scalars(single)
    assert pickle.dumps(ranks[0]) == pickle.dumps(ranks[1])   # per class too
    dist, one = (_load(os.path.join(work, f"{n}.pkl"))
                 for n in ("dist1", "single1"))
    _frames_equal(dist, one)
    assert sum(len(p["boxes"]) for p in one["preds"]) > 0
    assert single["mAP"] > 0.0


def test_padded_tail_two_ranks(disteval):
    from torch_port_dist import check_ranks
    from srfdet3d_torch.models.detector import SRFDet
    from srfdet3d_torch.tools import test as test_cli
    from srfdet3d_torch.utils.checkpoint import load_for_eval
    work, runs = disteval
    check_ranks(runs["batch2"])
    ranks = [_load(os.path.join(work, f"batch2_rank{r}.pkl"))
             for r in (0, 1)]
    assert _scalars(ranks[0]) == _scalars(ranks[1])
    cfg = _cfg()
    model = SRFDet(cfg, device="cpu")
    load_for_eval(os.path.join(work, "model.pt"), model)
    out = os.path.join(work, "single2.pkl")
    single = test_cli.run_inference_eval(cfg, _dataset(cfg), model, 2,
                                         out=out, device="cpu")
    for k, v in _scalars(single).items():
        np.testing.assert_allclose(ranks[0][k], v, rtol=0, atol=1e-6,
                                   err_msg=k)
    _frames_equal(_load(os.path.join(work, "dist2.pkl")), _load(out), 1e-5)


def test_fewer_frames_than_ranks_aborts(disteval):
    work, runs = disteval
    for code, text in runs["abort"]:
        assert code == 1, text[-3000:]
        assert "dataset has 1 frames < 2 processes" in text, text[-3000:]


if __name__ == "__main__":
    worker(*sys.argv[1:])
