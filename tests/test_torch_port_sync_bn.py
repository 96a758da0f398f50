"""The port's synced BatchNorms: two gloo ranks, each on its rows of a
batch, against one process on the whole batch.

`MaskedBatchNorm` (with a mask, with a mask under which rank 1 holds no
valid row, and without a mask) and `BatchNorm2d`, in train mode, forward
and backward of sum(y * g) for a seeded cotangent g: the output rows, the
input's gradient rows, the scale and bias gradients (summed over the
ranks, as the train step's all_reduce_grads sums them) and the running
statistics, all within rtol 1e-5 (atol 1e-6).  MaskedBatchNorm sums the
count and the sums, then the centred squares; BatchNorm2d averages the
ranks' means and means of squares (flax's fast variance), against
torch's two-pass statistics in one process.  Without a group neither
issues a collective.
"""

import os
import sys

import numpy as np
import pytest
import torch

from srfdet3d_torch.models.layers import BatchNorm2d, MaskedBatchNorm

B, V, C, HW = 4, 24, 6, 5
CASES = ("masked", "masked_empty_rank", "unmasked", "bn2d")
RTOL, ATOL = 1e-5, 1e-6


def _inputs(case):
    rng = np.random.default_rng(CASES.index(case))
    if case == "bn2d":
        x = rng.normal(1.5, 2.0, (B, C, HW, HW)).astype(np.float32)
        return dict(x=x, g=rng.normal(0, 1, x.shape).astype(np.float32))
    x = rng.normal(-0.5, 1.5, (B, V, C)).astype(np.float32)
    out = dict(x=x, g=rng.normal(0, 1, x.shape).astype(np.float32))
    if case != "unmasked":
        mask = rng.random((B, V)) < 0.6
        if case == "masked_empty_rank":
            mask[B // 2:] = False          # rank 1's rows: none valid
        out["mask"] = mask
    return out


def _layer(case):
    if case == "bn2d":
        return BatchNorm2d(C, eps=1e-5, momentum=0.1).train()
    return MaskedBatchNorm(C).train()


def _run(case, inputs, rows=slice(None)):
    """Forward and backward of one BN on `rows` of the inputs; the scale
    and bias grads summed over the ranks."""
    from srfdet3d_torch.parallel import mesh
    torch.manual_seed(0)
    bn = _layer(case)
    with torch.no_grad():                  # non-trivial affine
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.uniform_(-0.5, 0.5)
    x = torch.from_numpy(inputs["x"][rows]).requires_grad_(True)
    g = torch.from_numpy(inputs["g"][rows])
    if case == "bn2d":
        y = bn(x)
    else:
        mask = inputs.get("mask")
        y = bn(x, None if mask is None else torch.from_numpy(mask[rows]))
    (y * g).sum().backward()
    mesh.all_reduce_grads([bn.weight, bn.bias])
    return dict(y=y.detach().numpy(), dx=x.grad.numpy(),
                dw=bn.weight.grad.numpy(), db=bn.bias.grad.numpy(),
                mean=bn.running_mean.numpy(), var=bn.running_var.numpy())


def worker(out_dir):
    from torch_port_dist import worker_finish, worker_setup
    from srfdet3d_torch.parallel import shard_rows
    rank, world = worker_setup()
    for case in CASES:
        inputs = _inputs(case)
        n = B // world
        assert np.array_equal(shard_rows(inputs["x"], rank, world),
                              inputs["x"][rank * n:(rank + 1) * n])
        got = _run(case, inputs, slice(rank * n, (rank + 1) * n))
        np.savez(os.path.join(out_dir, f"{case}_{rank}.npz"), **got)
    worker_finish()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    from torch_port_dist import check_ranks, run_ranks
    out = str(tmp_path_factory.mktemp("sync_bn"))
    check_ranks(run_ranks(__file__, [out], world=2, timeout=120))
    return out


@pytest.mark.parametrize("case", CASES)
def test_two_ranks_equal_one_process(two_ranks, case):
    inputs = _inputs(case)
    ref = _run(case, inputs)
    ranks = [dict(np.load(os.path.join(two_ranks, f"{case}_{r}.npz")))
             for r in range(2)]
    for key in ("y", "dx"):
        got = np.concatenate([r[key] for r in ranks])
        np.testing.assert_allclose(got, ref[key], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{case} {key}")
    for r in ranks:
        for key in ("dw", "db", "mean", "var"):
            np.testing.assert_allclose(r[key], ref[key], rtol=RTOL,
                                       atol=ATOL, err_msg=f"{case} {key}")
    if case == "masked_empty_rank":
        assert not inputs["mask"][B // 2:].any()
        assert np.all(ranks[1]["y"] == ranks[1]["y"])      # finite, no NaN
    # the running statistics moved off their init
    assert not np.allclose(ref["mean"], 0.0)


def test_no_group_issues_no_collective(monkeypatch):
    """Without a process group, the BNs' train-mode forward and backward
    call no torch.distributed collective, and MaskedBatchNorm's output is
    the formula's: (x - mean) / sqrt(var + eps) over the valid rows."""
    import torch.distributed as dist
    calls = []
    for name in ("all_reduce", "all_gather", "broadcast", "barrier"):
        monkeypatch.setattr(dist, name,
                            lambda *a, _n=name, **k: calls.append(_n))
    for case in CASES:
        _run(case, _inputs(case))
    assert calls == []
    inputs = _inputs("masked")
    got = _run("masked", inputs)
    x, m = inputs["x"], inputs["mask"]
    torch.manual_seed(0)
    ref = _layer("masked")
    with torch.no_grad():
        ref.weight.uniform_(0.5, 1.5)
        ref.bias.uniform_(-0.5, 0.5)
    w, b = ref.weight.detach().numpy(), ref.bias.detach().numpy()
    sel = x[m].astype(np.float64)
    mean, var = sel.mean(0), sel.var(0)
    want = (x - mean) / np.sqrt(var + 1e-3) * w + b
    np.testing.assert_allclose(got["y"], want, rtol=1e-5, atol=1e-5)


if __name__ == "__main__":
    worker(sys.argv[1])
