"""The model mesh axis of the port: the head's proposals sharded over a
(data x model) grid of gloo ranks (`parallel.make_mesh_2d`,
`proposal_sharding`), against one process and against the JAX package.

The ranks are launched once for the file, two groups side by side (each
worker a rank of this file run as a script, killed at its timeout), while
the JAX steps are traced here:

- case A, 2 x 2 ranks: `tiny` at dropout 0, batch 4 (batch seed 0),
  weights seed 12 through `load_jax_params` (test_torch_port_ddp.py's
  seeds), one train step under proposal_sharding.  Held against the
  port's one-process step that plays back the ranks' discrete decisions
  (chip_smoke.Decisions, the model ranks joined along the proposals:
  `joined_decisions(..., n_model=2)`) under check_train_step's rule
  (test_torch_port_ddp._compare); against the JAX whole-batch step under
  `compare_train_step`'s tolerances; and against the JAX step traced
  inside `proposal_sharding(make_mesh_2d(2, 2))` on four of the forced
  CPU devices at tests/test_parallel_model.py's own tolerances (metrics
  rtol 1e-3 / atol 1e-5, BN statistics rtol 1e-4 / atol 1e-6).  The
  four ranks' parameters, buffers and AdamW moments are bit-identical
  after the step;
- on 1 x 2 ranks, port against one process on the same rows with the
  same generator: (B) `roi_patch` 3 with 4 fallback slots a sample,
  misfits past the slots on both sides of the rank boundary, dropout 0.1
  and head.remat, decisions played back; (C) 25 proposals, which the
  model axis does not divide: both ranks run the whole head, no model
  collective is issued and the grads are summed over the data group
  alone; (D) a tiny VoVNet LC predict with `img_roi_cap` 8 on 2 cameras
  (the compaction overflows the cap across the boundary), whose gathered
  outputs equal one process's within 1e-5; (E) a `tiny` predict at
  `roi_patch` 2 with fallback -1 (every misfit kept), whose misfits
  behind rank 0's run past rank 1's own block, against one process
  within 1e-5.
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
                                          train_step)

B, TOTAL = 4, 100
BATCH_SEED, WEIGHT_SEED = 0, 12
STEP_SEED = 7                  # the explicit generator of every train step
PAIR_B = 2
PRED_TOL = 1e-5


def _cfgs():
    tiny = tconfigs.tiny_test_config()
    lc = tconfigs.tiny_lc_test_config("vovnet")
    return {
        "A": tiny,
        "B": tiny.replace(head=dataclasses.replace(
            tiny.head, roi_patch=3, roi_patch_fallback=4, dropout=0.1,
            remat=True)),
        "C": tiny.replace(head=dataclasses.replace(tiny.head,
                                                   num_proposals=25)),
        "D": lc.replace(head=dataclasses.replace(lc.head, img_roi_cap=8)),
        "E": tiny.replace(head=dataclasses.replace(
            tiny.head, roi_patch=2, roi_patch_fallback=-1)),
    }


def _result(model, opt, metrics):
    return dict(
        metrics={k: float(v) for k, v in metrics.items()},
        grads={n: p.grad.numpy().copy() for n, p in model.named_parameters()
               if p.grad is not None},
        state={k: v.numpy().copy() for k, v in model.state_dict().items()},
        mu=opt.mu.numpy().copy(), nu=opt.nu.numpy().copy())


def _train(cfg, state, batch, replay=None):
    """One train step from `state` on `batch` with the generator seeded
    STEP_SEED: its result and its decisions (replay: those to play
    back)."""
    from chip_smoke import Decisions
    model = SRFDet(cfg, device="cpu")
    model.load_state_dict(state)
    opt = make_optimizer(model, cfg, TOTAL)
    dec = Decisions(replay)
    try:
        metrics = train_step(model, opt, batch,
                             torch.Generator().manual_seed(STEP_SEED))
    finally:
        dec.close()
    return dict(_result(model, opt, metrics), decisions=dec.take())


def _predict(cfg, state, batch):
    model = SRFDet(cfg, device="cpu")
    model.load_state_dict(state)
    model.eval()
    with torch.no_grad():
        logits, boxes = model(batch)
    return dict(logits=logits.numpy(), boxes=boxes.numpy())


class _Watch:
    """Records each collective this rank issues by group (world, data,
    model) and each proposal_offsets call's counts and offsets."""

    def __init__(self, grid):
        import torch.distributed as dist
        from srfdet3d_torch.parallel import mesh
        self.dist, self.mesh, self.grid = dist, mesh, grid
        self.orig = (dist.all_reduce, dist.all_gather, mesh.proposal_offsets)
        self.calls, self.offsets = [], []
        dist.all_reduce = self._wrap(self.orig[0], "all_reduce")
        dist.all_gather = self._wrap(self.orig[1], "all_gather")
        mesh.proposal_offsets = self._offsets

    def _wrap(self, fn, name):
        def call(*args, group=None, **kwargs):
            who = ("world" if group is None else
                   "model" if group is self.grid.model_group else
                   "data" if group is self.grid.data_group else "other")
            self.calls.append((name, who))
            return fn(*args, group=group, **kwargs)
        return call

    def _offsets(self, counts, mesh=None):
        out = self.orig[2](counts, mesh)
        self.offsets.append((counts.tolist(), out.tolist()))
        return out

    def take(self):
        self.dist.all_reduce, self.dist.all_gather = self.orig[:2]
        self.mesh.proposal_offsets = self.orig[2]
        return dict(calls=self.calls, offsets=self.offsets)


def worker(work, group):
    from torch_port_dist import worker_finish, worker_setup
    from srfdet3d_torch.parallel import mesh
    rank, world = worker_setup()
    inputs = torch.load(os.path.join(work, "inputs.pt"), weights_only=True)
    cfgs = _cfgs()
    out = {}
    grid = mesh.make_mesh_2d(world // 2, 2)
    cases = ("A",) if group == "grid" else ("B", "C", "D", "E")
    for case in cases:
        state, batch = inputs[case]
        rows = mesh.shard_rows(batch)
        watch = _Watch(grid)
        try:
            with mesh.proposal_sharding(grid):
                if case in ("D", "E"):
                    out[case] = _predict(cfgs[case], state, rows)
                else:
                    out[case] = _train(cfgs[case], state, rows)
        finally:
            out[case].update(watch.take())
    torch.save(out, os.path.join(work, f"{group}{rank}.pt"))
    worker_finish()


def jax_grid_step(work):
    """The JAX step traced inside proposal_sharding(make_mesh_2d(2, 2)) on
    the forced CPU devices (tests/test_parallel_model.py's route), on
    case A's batch and weights, in a process of its own beside the
    fixture's JAX step: writes <work>/jax_grid.pkl with its metrics, new
    BN statistics, batch and weights, as numpy."""
    import pickle

    import conftest  # noqa: F401  (the forced devices, the JAX cache)
    import jax
    import jax.numpy as jnp

    import __graft_entry__ as graft
    from torch_port_common import model_shapes, random_variables
    from srfdet3d_tpu import configs as jconfigs
    from srfdet3d_tpu.models.detector import SRFDet as JSRFDet
    from srfdet3d_tpu.parallel import (make_mesh_2d, proposal_sharding,
                                       replicate, shard_batch)
    from srfdet3d_tpu.train.trainer import (TrainState, make_optimizer,
                                            make_train_step)
    jcfg = jconfigs.tiny_test_config()
    variables = random_variables(model_shapes(jcfg), WEIGHT_SEED)
    batch = {k: np.array(v) for k, v in graft._synthetic_batch(
        jcfg, B, with_gt=True, seed=BATCH_SEED).items()}
    model = JSRFDet(jcfg)
    tx = make_optimizer(jcfg, TOTAL)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=jax.tree_util.tree_map(
                           jnp.asarray, variables["batch_stats"]),
                       opt_state=tx.init(params))
    grid = make_mesh_2d(n_data=2, n_model=2)
    step = make_train_step(model, tx, jcfg)
    with proposal_sharding(grid):
        new, metrics = step(replicate(state, grid),
                            shard_batch({k: jnp.asarray(v)
                                         for k, v in batch.items()}, grid),
                            jax.random.PRNGKey(STEP_SEED))
    with open(os.path.join(work, "jax_grid.pkl"), "wb") as f:
        pickle.dump(jax.device_get(dict(
            metrics=metrics, stats=new.batch_stats, batch=batch,
            leaves=jax.tree_util.tree_leaves(variables))), f)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Inputs, both groups' results and the JAX steps (traced and run while
    the ranks run: the whole-batch step here, the grid step in a process
    of its own)."""
    import pickle
    import subprocess
    import threading

    import __graft_entry__ as graft
    import chip_smoke
    import jax
    from torch_port_common import (jax_train_step, model_shapes,
                                   random_variables)
    from torch_port_dist import REPO, check_ranks, run_ranks
    from srfdet3d_tpu import configs as jconfigs
    from srfdet3d_torch.utils.jax_params import load_jax_params
    torch.set_num_threads(1)
    cfgs = _cfgs()
    jcfg = jconfigs.tiny_test_config()
    variables = random_variables(model_shapes(jcfg), WEIGHT_SEED)
    model = SRFDet(cfgs["A"], device="cpu")
    load_jax_params(model, variables)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in
             graft._synthetic_batch(jcfg, B, with_gt=True,
                                    seed=BATCH_SEED).items()}
    # B and E on A's weights and rows; C's weights drawn for its 25
    # proposals
    inputs = {case: (model.state_dict(), batch) for case in "ABE"}
    c_model = SRFDet(cfgs["C"], device="cpu")
    load_jax_params(c_model, random_variables(model_shapes(
        jcfg.replace(head=dataclasses.replace(jcfg.head, num_proposals=25))),
        WEIGHT_SEED))
    inputs["C"] = (c_model.state_dict(), batch)
    lc = SRFDet(cfgs["D"], device="cpu", seed=1)
    inputs["D"] = (lc.state_dict(), {
        k: torch.from_numpy(np.asarray(v)) for k, v in
        chip_smoke.train_batch(cfgs["D"], PAIR_B, seed=1).items()})
    work = str(tmp_path_factory.mktemp("model_axis"))
    torch.save(inputs, os.path.join(work, "inputs.pt"))
    done = {}
    threads = [threading.Thread(target=lambda g=g, w=w: done.update(
        {g: run_ranks(__file__, [work, g], world=w, timeout=150)}))
        for g, w in (("grid", 4), ("pair", 2))]
    for t in threads:
        t.start()
    with open(os.path.join(work, "jax_grid.log"), "w+") as log:
        proc = subprocess.Popen(
            [sys.executable, __file__, work, "jax"], cwd=REPO,
            env=dict(os.environ, PYTHONPATH=os.pathsep.join(
                [REPO] + [p for p in os.environ.get("PYTHONPATH", "")
                          .split(os.pathsep) if p])),
            stdout=log, stderr=subprocess.STDOUT)
        try:
            jbatch, jvars, jout = jax_train_step(jcfg, B, BATCH_SEED,
                                                 WEIGHT_SEED, TOTAL)
            proc.wait(timeout=150)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            for t in threads:
                t.join()
        log.seek(0)
        assert proc.returncode == 0, log.read()[-4000:]
    check_ranks(done["grid"])
    check_ranks(done["pair"])
    with open(os.path.join(work, "jax_grid.pkl"), "rb") as f:
        jgrid = pickle.load(f)
    # both JAX steps ran on the ranks' weights and batch
    for leaves in (jax.tree_util.tree_leaves(jvars), jgrid["leaves"]):
        for a, b in zip(leaves, jax.tree_util.tree_leaves(variables),
                        strict=True):
            np.testing.assert_array_equal(a, b)
    for got in (jbatch, jgrid["batch"]):
        assert set(got) == set(batch)
        for k, v in got.items():
            np.testing.assert_array_equal(v, batch[k].numpy())
    load = [torch.load(os.path.join(work, f"{g}{r}.pt"), weights_only=False)
            for g, w in (("grid", 4), ("pair", 2)) for r in range(w)]
    return dict(cfgs=cfgs, inputs=inputs, grid=load[:4], pair=load[4:],
                variables=variables, jout=jout, jgrid=jgrid)


def _played(results, n_model=2):
    from chip_smoke import joined_decisions
    return joined_decisions([r["decisions"] for r in results], n_model)


def test_grid_equals_one_process(ranks):
    """2 x 2 ranks against one process on the whole batch that plays back
    the grid's decisions, under the port's rule (check_train_step's)."""
    from test_torch_port_ddp import _compare
    cfg = ranks["cfgs"]["A"]
    state, batch = ranks["inputs"]["A"]
    want = _train(cfg, state, batch,
                  replay=_played([r["A"] for r in ranks["grid"]]))
    lr = make_lr_schedule(cfg.optim, TOTAL)
    _compare(ranks["grid"][0]["A"], want, lr(0), "step", "A")


def test_grid_equals_the_jax_step(ranks):
    """The grid's step against the JAX package's whole-batch step
    (compare_train_step's tolerances and per-leaf grad rule)."""
    from torch_port_common import compare_train_step
    got = ranks["grid"][0]["A"]
    probe = SRFDet(ranks["cfgs"]["A"], device="cpu")
    grads = {n: got["grads"].get(n) for n, _ in probe.named_parameters()}
    state = {k: v for k, v in got["state"].items()
             if not k.endswith("num_batches_tracked")}
    compare_train_step(ranks["cfgs"]["A"],
                       (got["metrics"], grads, state, set()),
                       ranks["variables"], ranks["jout"], TOTAL)


def test_grid_equals_the_jax_proposal_sharding_step(ranks):
    """The grid's step against the JAX step traced inside
    proposal_sharding(make_mesh_2d(2, 2)), at test_parallel_model.py's
    tolerances: every metric rtol 1e-3 / atol 1e-5, every BN statistic
    rtol 1e-4 / atol 1e-6."""
    from srfdet3d_torch.utils.jax_params import jax_state_dict
    metrics, stats = ranks["jgrid"]["metrics"], ranks["jgrid"]["stats"]
    got = ranks["grid"][0]["A"]
    assert set(metrics) <= set(got["metrics"])
    for k, v in metrics.items():
        np.testing.assert_allclose(got["metrics"][k], float(v), rtol=1e-3,
                                   atol=1e-5, err_msg=k)
    hc = ranks["cfgs"]["A"].head
    want = jax_state_dict({"batch_stats": stats}, hc.num_heads,
                          hc.num_cls_convs)
    assert want
    for name, v in want.items():
        np.testing.assert_allclose(got["state"][name], v, rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def test_grid_ranks_stay_bit_identical(ranks):
    first = ranks["grid"][0]["A"]
    for other in ranks["grid"][1:]:
        got = other["A"]
        assert got["metrics"] == first["metrics"]
        for k, v in first["state"].items():
            np.testing.assert_array_equal(got["state"][k], v, err_msg=k)
        np.testing.assert_array_equal(got["mu"], first["mu"])
        np.testing.assert_array_equal(got["nu"], first["nu"])


def test_grid_collectives(ranks):
    """Each rank gathers K and V over its model group once an iteration,
    and the outputs twice; the BatchNorms, the normalizer and the metrics
    sum over its data group; the grads over the whole world, once."""
    heads = ranks["cfgs"]["A"].head.num_heads
    for r in ranks["grid"]:
        calls = r["A"]["calls"]
        assert calls.count(("all_gather", "model")) == heads + 2
        assert calls.count(("all_reduce", "model")) == heads
        assert calls.count(("all_reduce", "world")) == 1
        assert ("all_reduce", "data") in calls
        assert {who for _, who in calls} == {"model", "data", "world"}


@pytest.mark.parametrize("case", ["B", "C"])
def test_pair_equals_one_process(ranks, case):
    """1 x 2 ranks against one process on the same rows with the same
    generator, the pair's decisions played back, under the port's rule:
    (B) patch fallback slots overflowing across the boundary, dropout
    0.1, remat; (C) an indivisible proposal count, run whole on both
    ranks."""
    from test_torch_port_ddp import _compare
    cfg = ranks["cfgs"][case]
    state, batch = ranks["inputs"][case]
    results = [r[case] for r in ranks["pair"]]
    # C's ranks run the whole head: rank 0's decisions are the step's
    want = _train(cfg, state, batch, replay=_played(
        results if case == "B" else results[:1], 2 if case == "B" else 1))
    lr = make_lr_schedule(cfg.optim, TOTAL)
    _compare(results[0], want, lr(0), "step", case)
    for r in results[1:]:
        for k, v in results[0]["state"].items():
            np.testing.assert_array_equal(r["state"][k], v, err_msg=k)


def test_pair_patch_slots_straddle_the_boundary(ranks):
    """Case B's fallback rule ran on the blocks with offsets, and some
    sample's misfits ran past the 4 slots on both ranks' sides: rank 1's
    offset below the slots and its misfits beyond them."""
    fallback = ranks["cfgs"]["B"].head.roi_patch_fallback
    rank1 = ranks["pair"][1]["B"]["offsets"]
    assert rank1 and all(len(c) == B for c, _ in rank1)
    assert any(o < fallback < o + c for counts, offs in rank1
               for c, o in zip(counts, offs))
    rank0 = ranks["pair"][0]["B"]["offsets"]
    assert all(o == 0 for _, offs in rank0 for o in offs)


def test_pair_indivisible_runs_whole(ranks):
    """Case C: no model collective, no offset, the grads summed over the
    data group (a sum over both ranks would double them)."""
    for r in ranks["pair"]:
        calls = r["C"]["calls"]
        assert not [c for c in calls if c[1] == "model"]
        assert ("all_reduce", "world") not in calls
        assert r["C"]["offsets"] == []


def test_pair_lc_predict_equals_one_process(ranks):
    """Case D: the gathered logits and boxes of every iteration equal one
    process's within 1e-5, and the image pair compaction overflowed its
    8 slots across the rank boundary."""
    cfg = ranks["cfgs"]["D"]
    state, batch = ranks["inputs"]["D"]
    want = _predict(cfg, state, batch)
    for r in ranks["pair"]:
        for k in ("logits", "boxes"):
            np.testing.assert_allclose(r["D"][k], want[k], rtol=PRED_TOL,
                                       atol=PRED_TOL, err_msg=k)
    cap = cfg.head.img_roi_cap
    rank1 = ranks["pair"][1]["D"]["offsets"]
    assert any(o < cap < o + c for counts, offs in rank1
               for c, o in zip(counts, offs))


def test_pair_patch_keeps_every_misfit(ranks, monkeypatch):
    """Case E: with fallback -1 no rank drops a misfit, though some
    sample's misfits run past rank 1's own 12 proposals once rank 0's are
    ahead of them; the gathered logits and boxes equal one process's
    within 1e-5."""
    from srfdet3d_torch.ops import roi_align
    cfg = ranks["cfgs"]["E"]
    state, batch = ranks["inputs"]["E"]
    fits, orig = [], roi_align.patch_fits
    monkeypatch.setattr(roi_align, "patch_fits",
                        lambda *a, **k: fits.append(orig(*a, **k)) or
                        fits[-1])
    want = _predict(cfg, state, batch)
    n = cfg.head.num_proposals
    assert fits and any(bool(((~f).reshape(-1, n).sum(1) > n // 2).any())
                        for f in fits)
    for r in ranks["pair"]:
        for k in ("logits", "boxes"):
            np.testing.assert_allclose(r["E"][k], want[k], rtol=PRED_TOL,
                                       atol=PRED_TOL, err_msg=k)
        assert r["E"]["offsets"] == []      # no slot to count


if __name__ == "__main__":
    if sys.argv[2] == "jax":
        jax_grid_step(sys.argv[1])
    else:
        worker(sys.argv[1], sys.argv[2])
