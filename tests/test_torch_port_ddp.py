"""Data-parallel train steps of the port: two gloo ranks, each on its rows
of a global batch of 4 (`shard_rows`), against one process on the whole
batch that plays back the ranks' discrete decisions (chip_smoke.Decisions:
ReLU masks, RoI levels, sample corners, OTA matches, joined rank by
rank).  A rounding can flip one of them (a ReLU input within a rounding
of zero), and a single flip moves a leaf's grad by more than the rule
allows; played back, the one process takes the same branch at every
kink, and what remains is rounding.

- `tiny` (dropout 0, as the JAX package's own DP test runs it), batch 4,
  the JAX package's seeded weights through `load_jax_params`: the 2-rank
  step equals the port's one-process step (losses and grad_norm within
  rtol 1e-4, every grad within 2e-4 of its leaf's largest, the parameters
  after AdamW within 1e-6 where the grad is resolved and 2 lr elsewhere,
  the BN statistics within rtol 1e-4 + atol 1e-5: the port's own rule,
  `check_train_step`), and the JAX package's whole-batch step under
  `check_train_step`'s tolerances (losses 1e-5, grad_norm 1e-4; JAX plays
  nothing back);
- the same at `optim.accum_steps=2` against one process at accum 2;
- a tiny VoVNet LC step with the image backbone training (stem and
  stage 1 frozen, norm_eval off, GridMask off: its draws differ by
  rank), whose BatchNorm2d statistics are synced, against one process:
  the losses and every BN statistic under the same rule, the parameters
  within 2 lr, the frozen ones bit for bit;
- with dropout 0.1, the ranks' generators fold in the rank: the same
  rows give other logits on each rank;
- after the steps, the ranks' parameters, BN statistics and AdamW
  moments are bit-identical.

The seeds are test_torch_port_accum.py's, where tiny's float32 grads are
well conditioned (batch 4, batch seed 0, weight seed 12).  Neither the
tiny LC grads nor their norm are held: they are ill-conditioned without
a flip (the DPG convs' BN over maps of a few cells, and the image
stages).  Over model seeds 0-5 and batch seeds 0-3 the 2-rank step's
grad_norm moves by up to 11% without playback and misses rtol 1e-4 at
some pairs with it, and the grads miss the per-leaf rule at most pairs
either way, while the losses, the BN statistics and the parameters pass
the rule at every pair.  The synced BatchNorm2d's gradient is held at
rtol 1e-5 in test_torch_port_sync_bn.py.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from srfdet3d_torch import configs as tconfigs
from srfdet3d_torch.models.detector import SRFDet
from srfdet3d_torch.train.trainer import (make_lr_schedule, make_optimizer,
                                          step_generator, train_step)

B, TOTAL = 4, 100
BATCH_SEED, WEIGHT_SEED = 0, 12
LC_MODEL_SEED, LC_BATCH_SEED = 0, 0


def _cfgs():
    tiny = tconfigs.tiny_test_config()
    lc = tconfigs.tiny_lc_test_config("vovnet", frozen_stages=1,
                                      norm_eval=False, use_grid_mask=False)
    return {
        "step": tiny,
        "accum": tiny.replace(optim=dataclasses.replace(tiny.optim,
                                                        accum_steps=2)),
        "lc": lc,
        "dropout": tiny.replace(head=dataclasses.replace(tiny.head,
                                                         dropout=0.1)),
    }


def _model(cfg, state):
    model = SRFDet(cfg, device="cpu")
    model.load_state_dict(state)
    return model


def _result(model, opt, metrics):
    return dict(
        metrics={k: float(v) for k, v in metrics.items()},
        grads={n: p.grad.numpy().copy() for n, p in model.named_parameters()
               if p.grad is not None},
        state={k: v.numpy().copy() for k, v in model.state_dict().items()},
        mu=opt.mu.numpy().copy(), nu=opt.nu.numpy().copy())


def _steps(cfg, state, batch, steps=2, first=0, moments=None, replay=None):
    """`steps` train steps from `state` on `batch` (this rank's rows under a
    group), generators from step_generator(seed 0), starting at step
    `first` with the AdamW moments `moments` (mu, nu): each step's
    result, with the step's discrete decisions (chip_smoke.Decisions);
    `replay`: the decisions to play back, one set a step."""
    from chip_smoke import Decisions
    model = _model(cfg, state)
    opt = make_optimizer(model, cfg, TOTAL)
    if moments is not None:
        opt.mu.copy_(torch.from_numpy(moments[0]))
        opt.nu.copy_(torch.from_numpy(moments[1]))
        opt.count = first
    out = []
    for i in range(first, first + steps):
        dec = Decisions(None if replay is None else replay[i - first])
        try:
            metrics = train_step(model, opt, batch,
                                 step_generator(model, 0, i))
        finally:
            dec.close()
        out.append(dict(_result(model, opt, metrics),
                        decisions=dec.take()))
    return out


def worker(work):
    from torch_port_dist import worker_finish, worker_setup
    from srfdet3d_torch.parallel import shard_rows
    rank, world = worker_setup()
    inputs = torch.load(os.path.join(work, "inputs.pt"), weights_only=True)
    cfgs = _cfgs()
    out = {}
    for name in ("step", "accum", "lc"):
        state, batch = inputs[name]
        out[name] = _steps(cfgs[name], state, shard_rows(batch, rank, world),
                           steps=1 if name == "lc" else 2)
    # dropout: the same rows on every rank, each rank's own generator
    state, batch = inputs["step"]
    model = _model(cfgs["dropout"], state).train()
    with torch.no_grad():
        logits, _ = model(shard_rows(batch, 0, world),
                          generator=step_generator(model, 0, 0))
    words = np.random.SeedSequence((0, 0, rank)).generate_state(
        2, np.uint32)
    want = torch.Generator().manual_seed(
        (int(words[0]) << 31) | (int(words[1]) >> 1))
    out["dropout"] = dict(
        logits=logits.numpy(),
        draws_equal=bool(torch.equal(
            torch.rand(8, generator=step_generator(model, 0, 0)),
            torch.rand(8, generator=want))))
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    worker_finish()


@pytest.fixture(scope="module")
def ddp(tmp_path_factory):
    """Inputs, the 2-rank results and the JAX package's step (traced and
    run while the ranks run)."""
    import threading

    import __graft_entry__ as graft
    import chip_smoke
    import jax
    from torch_port_common import (jax_train_step, model_shapes,
                                   random_variables)
    from torch_port_dist import check_ranks, run_ranks
    from srfdet3d_tpu import configs as jconfigs
    from srfdet3d_torch.utils.jax_params import load_jax_params
    torch.set_num_threads(1)
    cfgs = _cfgs()
    jcfg = jconfigs.tiny_test_config()
    variables = random_variables(model_shapes(jcfg), WEIGHT_SEED)
    model = SRFDet(cfgs["step"], device="cpu")
    load_jax_params(model, variables)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in
             graft._synthetic_batch(jcfg, B, with_gt=True,
                                    seed=BATCH_SEED).items()}
    lc = SRFDet(cfgs["lc"], device="cpu", seed=LC_MODEL_SEED)
    lc_batch = {k: torch.from_numpy(np.asarray(v)) for k, v in
                chip_smoke.train_batch(cfgs["lc"], B,
                                         seed=LC_BATCH_SEED).items()}
    inputs = {"step": (model.state_dict(), batch),
              "accum": (model.state_dict(), batch),
              "lc": (lc.state_dict(), lc_batch)}
    work = str(tmp_path_factory.mktemp("ddp"))
    torch.save(inputs, os.path.join(work, "inputs.pt"))
    done = {}
    ranks_thread = threading.Thread(target=lambda: done.update(
        out=run_ranks(__file__, [work], world=2, timeout=120)))
    ranks_thread.start()
    try:
        jbatch, jvars, jout = jax_train_step(jcfg, B, BATCH_SEED,
                                             WEIGHT_SEED, TOTAL)
    finally:
        ranks_thread.join()
    check_ranks(done["out"])
    # the JAX step ran on the ranks' weights and batch
    for a, b in zip(jax.tree_util.tree_leaves(jvars),
                    jax.tree_util.tree_leaves(variables)):
        np.testing.assert_array_equal(a, b)
    for k, v in jbatch.items():
        np.testing.assert_array_equal(v, batch[k].numpy())
    ranks = [torch.load(os.path.join(work, f"rank{r}.pt"),
                        weights_only=False) for r in range(2)]
    return dict(cfgs=cfgs, inputs=inputs, ranks=ranks, variables=variables,
                jout=jout)


def _compare(got, ref, lr0, name, what, grads=True):
    """The port's rule (check_train_step) between two port steps: losses
    and grad_norm within rtol 1e-4, grads within 2e-4 of the leaf's
    largest (the attention key biases, zero up to rounding, within 1e-9 of
    the tree's largest grad), parameters within 1e-6 where the grad is
    resolved and 2 lr elsewhere, BN statistics within rtol 1e-4 + atol
    1e-5.  With grads=False neither the grads nor grad_norm are compared,
    and every trained parameter is held within 2 lr."""
    assert set(got["metrics"]) == set(ref["metrics"])
    for k, v in ref["metrics"].items():
        if k == "grad_norm" and not grads:
            continue
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-4,
                                   atol=1e-6, err_msg=f"{what} {k}")
    assert set(got["grads"]) == set(ref["grads"])
    tree_max = max(float(np.abs(g).max()) for g in ref["grads"].values())
    tols = {}
    for leaf, g in ref["grads"].items():
        if not grads:
            tols[leaf] = np.inf
            continue
        if leaf.endswith("k_proj.bias"):
            for x in (got["grads"][leaf], g):
                assert float(np.abs(x).max()) <= 1e-9 * tree_max, leaf
            tols[leaf] = np.inf
            continue
        tols[leaf] = 2e-4 * max(float(np.abs(g).max()), 1e-6 * tree_max)
        np.testing.assert_allclose(got["grads"][leaf], g, rtol=0,
                                   atol=tols[leaf], err_msg=f"{what} {leaf}")
    params = {n for n, _ in _probe(name).named_parameters()}
    for leaf, v in ref["state"].items():
        x = got["state"][leaf]
        if leaf in tols:
            resolved = np.abs(ref["grads"][leaf]) > tols[leaf]
            np.testing.assert_allclose(x[resolved], v[resolved], rtol=0,
                                       atol=1e-6, err_msg=f"{what} {leaf}")
            np.testing.assert_allclose(x, v, rtol=0, atol=2 * lr0 + 1e-6,
                                       err_msg=f"{what} {leaf}")
        elif leaf in params:                   # frozen: bit for bit
            np.testing.assert_array_equal(x, v, err_msg=f"{what} {leaf}")
        elif not leaf.endswith("num_batches_tracked"):  # BN statistics
            np.testing.assert_allclose(x, v, rtol=1e-4, atol=1e-5,
                                       err_msg=f"{what} {leaf}")


_PROBES = {}


def _probe(what):
    """A model of the scenario's config (parameter names)."""
    if what not in _PROBES:
        _PROBES[what] = SRFDet(_cfgs()[what], device="cpu")
    return _PROBES[what]


@pytest.mark.parametrize("name", ["step", "accum", "lc"])
def test_two_ranks_equal_one_process(ddp, name):
    """The 2-rank run's steps against one process on the whole batch that
    plays back the ranks' discrete decisions (their ReLU masks, RoI
    levels, sample corners and OTA matches, joined rank by rank: a
    rounding can flip one, and one flip moves a leaf's grad by more than
    the rule allows): the first from the common weights; for tiny, the
    second from the 2-rank run's state and AdamW moments after its first
    step (after one step the two runs' parameters already differ by up to
    2 lr where a grad is unresolved, which the next grads would
    amplify).  The LC run takes one
    step, its grads not held leaf by leaf (the module docstring)."""
    from chip_smoke import joined_decisions
    cfg = ddp["cfgs"][name]
    state, batch = ddp["inputs"][name]
    got = ddp["ranks"][0][name]

    def played(i):
        return [joined_decisions([r[name][i]["decisions"]
                                  for r in ddp["ranks"]])]
    lr = make_lr_schedule(cfg.optim, TOTAL)
    want = _steps(cfg, state, batch, steps=1, replay=played(0))[0]
    _compare(got[0], want, lr(0), name, f"{name}[0]", grads=name != "lc")
    if name != "lc":
        after = {k: torch.from_numpy(v) for k, v in got[0]["state"].items()}
        second = _steps(cfg, after, batch, steps=1, first=1,
                        moments=(got[0]["mu"], got[0]["nu"]),
                        replay=played(1))[0]
        _compare(got[1], second, lr(1), name, f"{name}[1]")
    if name == "lc":
        # the image backbone trained in train mode: its BN statistics moved
        stats = [k for k in want["state"]
                 if k.startswith("img_backbone.") and
                 k.endswith("running_mean")]
        assert stats and all(not np.array_equal(want["state"][k],
                                                state[k].numpy())
                             for k in stats)
        assert any(k.startswith("img_backbone.") for k in want["grads"])


def test_two_ranks_equal_the_jax_step(ddp):
    """The 2-rank tiny step against the JAX package's whole-batch step
    (check_train_step's tolerances and per-leaf grad rule)."""
    from torch_port_common import compare_train_step
    got = ddp["ranks"][0]["step"][0]
    no_grad = {n for n, p in _probe("step").named_parameters()
               if not p.requires_grad}
    grads = {n: got["grads"].get(n) for n, _ in
             _probe("step").named_parameters()}
    state = {k: v for k, v in got["state"].items()
             if not k.endswith("num_batches_tracked")}
    compare_train_step(ddp["cfgs"]["step"],
                       (got["metrics"], grads, state, no_grad),
                       ddp["variables"], ddp["jout"], TOTAL)


@pytest.mark.parametrize("name", ["step", "accum", "lc"])
def test_ranks_stay_bit_identical(ddp, name):
    a, b = (r[name] for r in ddp["ranks"])
    for i in range(len(a)):
        assert a[i]["metrics"] == b[i]["metrics"]
        for k, v in a[i]["state"].items():
            np.testing.assert_array_equal(v, b[i]["state"][k], err_msg=k)
        np.testing.assert_array_equal(a[i]["mu"], b[i]["mu"])
        np.testing.assert_array_equal(a[i]["nu"], b[i]["nu"])
        assert a[i]["grads"].keys() == b[i]["grads"].keys()
        for k, v in a[i]["grads"].items():
            np.testing.assert_array_equal(v, b[i]["grads"][k], err_msg=k)


def test_dropout_masks_differ_by_rank(ddp):
    a, b = (r["dropout"] for r in ddp["ranks"])
    assert a["draws_equal"] and b["draws_equal"]
    assert not np.array_equal(a["logits"], b["logits"])
    # without a group the generator is seeded from (seed, step) alone
    model = _probe("step")
    words = np.random.SeedSequence((0, 0)).generate_state(2, np.uint32)
    want = torch.Generator().manual_seed(
        (int(words[0]) << 31) | (int(words[1]) >> 1))
    assert torch.equal(torch.rand(8, generator=step_generator(model, 0, 0)),
                       torch.rand(8, generator=want))


def test_no_group_step_issues_no_collective(ddp, monkeypatch):
    """Without a process group the train step calls no torch.distributed
    collective, and its result is the same bit for bit with every
    collective entry point replaced by one that records its call."""
    import torch.distributed as dist
    cfg = ddp["cfgs"]["step"]
    state, batch = ddp["inputs"]["step"]
    plain = _steps(cfg, state, batch, steps=1)[0]
    calls = []
    for name in ("all_reduce", "all_gather", "broadcast", "barrier",
                 "reduce_scatter", "all_to_all"):
        monkeypatch.setattr(dist, name,
                            lambda *a, _n=name, **k: calls.append(_n))
    watched = _steps(cfg, state, batch, steps=1)[0]
    assert calls == []
    assert watched["metrics"] == plain["metrics"]
    for k, v in plain["state"].items():
        np.testing.assert_array_equal(watched["state"][k], v, err_msg=k)


if __name__ == "__main__":
    worker(sys.argv[1])
