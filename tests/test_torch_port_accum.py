"""Gradient accumulation (`optim.accum_steps` = 2) of the port's train step
against the JAX package's `make_train_step` (`_grads_accum`: strided
microbatches, BN statistics chained through them, grads summed then
divided, losses averaged) on `tiny`, dropout off, batch 4 and seeded
weights: the losses within 1e-5, and every grad, the parameters after the
AdamW update and the BN statistics at check_train_step's tolerances
(test_torch_port_train.py).

Tiny float32 grads are badly conditioned at most seeds (ReLU kinks): the
seeds here are the ones, of four tried, where JAX's own grads move least
when the weights take 1e-6 relative noise (worst leaf 2.2e-3 of its
largest; 1e-2 to 0.15 at the other three).  Within the port, the
accumulated step is also held exactly against its definition: the two
microbatches' grads summed and halved, the BN statistics of two forwards
in turn.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from srfdet3d_tpu import configs as jconfigs
from srfdet3d_tpu.models.detector import SRFDet as JSRFDet
from srfdet3d_tpu.train.trainer import TrainState
from srfdet3d_tpu.train.trainer import make_optimizer as j_optimizer
from srfdet3d_tpu.train.trainer import make_train_step as j_train_step
from srfdet3d_torch import configs as tconfigs
from srfdet3d_torch.models.detector import SRFDet
from srfdet3d_torch.train.trainer import (_microbatches, losses_of,
                                          make_optimizer, train_step)
from torch_port_common import check_train_step, random_variables

ACCUM = 2


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the tiny models gain nothing from more, and
    the suite runs several test processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _accum(cfg):
    return cfg.replace(optim=dataclasses.replace(cfg.optim,
                                                 accum_steps=ACCUM))


def jax_accum_step(jcfg, batch_size, batch_seed, weight_seed, total=100):
    """One JAX make_train_step step (rng key 0) through its grad and apply
    programs: (batch, weights, (loss, losses, grads, new params, new BN
    statistics, grad norm))."""
    batch = {k: np.array(v) for k, v in graft._synthetic_batch(
        jcfg, batch_size, with_gt=True, seed=batch_seed).items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    model = JSRFDet(jcfg)
    shapes = jax.eval_shape(lambda r, b: model.init(r, b, train=False),
                            jax.random.PRNGKey(0), jb)
    variables = random_variables(shapes, weight_seed)
    tx = j_optimizer(jcfg, total)
    params = jax.tree_util.tree_map(jnp.array, variables["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=jax.tree_util.tree_map(
                           jnp.array, variables["batch_stats"]),
                       opt_state=tx.init(params))
    step = j_train_step(model, tx, jcfg)
    total_loss, losses, new_bs, grads = step.grad_prog(
        state, jb, jax.random.PRNGKey(0))
    # copies: the apply program donates its inputs
    host = jax.tree_util.tree_map(lambda a: np.array(a, copy=True),
                                  (total_loss, losses, grads, new_bs))
    new_state, gnorm = step.apply_prog(state, new_bs, grads)
    new_params = jax.tree_util.tree_map(lambda a: np.array(a, copy=True),
                                        new_state.params)
    total_loss, losses, grads, new_bs = host
    return batch, variables, (total_loss, losses, grads, new_params,
                              new_bs, float(gnorm))


def test_accum_step_matches_jax():
    jcfg = _accum(jconfigs.tiny_test_config())
    tcfg = _accum(tconfigs.tiny_test_config())
    assert jcfg.head.dropout == tcfg.head.dropout == 0.0
    batch, variables, out = jax_accum_step(jcfg, 4, batch_seed=0,
                                           weight_seed=12)
    assert batch["gt_mask"][0::2].sum() > 0
    assert batch["gt_mask"][1::2].sum() > 0
    check_train_step(tcfg, batch, variables, out)


def test_microbatches_are_strided():
    batch = {"a": torch.arange(12).reshape(6, 2), "b": np.arange(6)}
    parts = _microbatches(batch, 3)
    assert [p["b"].tolist() for p in parts] == [[0, 3], [1, 4], [2, 5]]
    assert parts[1]["a"].tolist() == [[2, 3], [8, 9]]
    with pytest.raises(ValueError, match="divisible"):
        _microbatches({"a": torch.zeros(5)}, 2)


def test_accum_step_is_its_definition():
    cfg = _accum(tconfigs.tiny_test_config())
    batch = {k: torch.from_numpy(np.array(v)) for k, v in
             graft._synthetic_batch(cfg, 4, with_gt=True, seed=2).items()}
    ref = SRFDet(cfg, device="cpu", seed=3)
    ref.train()
    grads = []
    for mb in _microbatches(batch, ACCUM):
        for p in ref.parameters():
            p.grad = None
        sum(losses_of(ref, mb).values()).backward()
        grads.append({n: p.grad.clone() for n, p in ref.named_parameters()
                      if p.grad is not None})
    model = SRFDet(cfg, device="cpu", seed=3)
    opt = make_optimizer(model, cfg, 10)
    train_step(model, opt, batch)
    for n, p in model.named_parameters():
        if n in grads[0]:
            torch.testing.assert_close(p.grad, (grads[0][n] + grads[1][n])
                                       / ACCUM, rtol=0, atol=0)
    bufs = dict(ref.named_buffers())
    for n, b in model.named_buffers():
        torch.testing.assert_close(b, bufs[n], rtol=0, atol=0)
