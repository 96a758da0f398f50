"""The port's checkpoints (`srfdet3d_torch/utils/checkpoint.py`): a bit-exact
save / restore round trip of the model, FlatAdamW and the step; the
partial loads' errors beside the JAX package's (orbax) on the same
situations; the tiny L checkpoint loaded into a tiny LC model restores the
tensors JAX's load_pretrained restores (its leaves through the weight
bridge's name map); and a run of three steps equals two steps, a save, a
restore into fresh objects and one step, bit for bit on the CPU."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from srfdet3d_tpu.models.detector import SRFDet as JSRFDet
from srfdet3d_tpu.train.trainer import TrainState
from srfdet3d_tpu.utils import checkpoint as jckpt
from srfdet3d_torch import configs as tconfigs
from srfdet3d_torch.models.detector import SRFDet
from srfdet3d_torch.train.trainer import (make_optimizer, step_generator,
                                          train_step)
from srfdet3d_torch.utils import checkpoint as tckpt
from srfdet3d_torch.utils.jax_params import jax_state_dict
from torch_port_common import jax_tiny_lc, lc_input_shapes, model_shapes


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the tiny models gain nothing from more, and
    the suite runs several test processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny(dropout=0.1):
    cfg = tconfigs.tiny_test_config()
    return cfg.replace(head=dataclasses.replace(cfg.head, dropout=dropout))


def batch_of(cfg, seed):
    return {k: torch.from_numpy(np.array(v)) for k, v in
            graft._synthetic_batch(cfg, 2, with_gt=True, seed=seed).items()}


def assert_same_state(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        torch.testing.assert_close(sa[k], sb[k], rtol=0, atol=0, msg=k)


def test_round_trip_is_bit_exact(tmp_path):
    cfg = tiny()
    model = SRFDet(cfg, device="cpu", seed=1)
    opt = make_optimizer(model, cfg, 20)
    for step in range(2):
        train_step(model, opt, batch_of(cfg, step),
                   step_generator(model, 0, step))
    path = str(tmp_path / "epoch_1.pt")
    tckpt.save_checkpoint(path, model, opt, step=2,
                          meta={"config": cfg.name, "step": 2})
    assert json.load(open(path + ".meta.json"))["step"] == 2
    fresh = SRFDet(cfg, device="cpu", seed=2)
    fopt = make_optimizer(fresh, cfg, 20)
    assert tckpt.restore_checkpoint(path, fresh, fopt) == 2
    assert_same_state(model, fresh)
    for k in ("mu", "nu"):
        torch.testing.assert_close(getattr(fopt, k), getattr(opt, k),
                                   rtol=0, atol=0)
    assert fopt.count == opt.count == 2
    # a training checkpoint restores whole for eval
    other = SRFDet(cfg, device="cpu", seed=3)
    assert tckpt.load_for_eval(path, other) == 2
    assert_same_state(model, other)


def test_resume_equals_uninterrupted_run(tmp_path):
    cfg = tiny()
    batches = [batch_of(cfg, 10 + s) for s in range(3)]
    straight = SRFDet(cfg, device="cpu", seed=4)
    sopt = make_optimizer(straight, cfg, 30)
    for s in range(3):
        train_step(straight, sopt, batches[s], step_generator(straight, 7, s))
    first = SRFDet(cfg, device="cpu", seed=4)
    fopt = make_optimizer(first, cfg, 30)
    for s in range(2):
        train_step(first, fopt, batches[s], step_generator(first, 7, s))
    path = str(tmp_path / "preempt_2.pt")
    tckpt.save_checkpoint(path, first, fopt, step=2)
    resumed = SRFDet(cfg, device="cpu", seed=5)
    ropt = make_optimizer(resumed, cfg, 30)
    step = tckpt.restore_checkpoint(path, resumed, ropt)
    train_step(resumed, ropt, batches[2], step_generator(resumed, 7, step))
    assert_same_state(straight, resumed)
    torch.testing.assert_close(ropt.mu, sopt.mu, rtol=0, atol=0)
    torch.testing.assert_close(ropt.nu, sopt.nu, rtol=0, atol=0)
    # the step's generator depends on (seed, step) alone
    a, b = step_generator(straight, 7, 2), step_generator(resumed, 7, 2)
    assert torch.equal(torch.rand(5, generator=a), torch.rand(5, generator=b))
    assert not torch.equal(torch.rand(5, generator=step_generator(
        straight, 7, 3)), torch.rand(5, generator=step_generator(
            straight, 7, 2)))


def _jax_params(cfg_shapes, seed=0):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), cfg_shapes)


def test_partial_load_errors_as_jax(tmp_path):
    from srfdet3d_tpu import configs as jconfigs
    jvars = _jax_params(model_shapes(jconfigs.tiny_test_config()))
    params = jvars["params"]
    cfg = tiny()
    model = SRFDet(cfg, device="cpu")
    ckpt = str(tmp_path / "tiny.pt")
    tckpt.save_checkpoint(ckpt, model)
    jdir = str(tmp_path / "jtiny")
    jckpt._checkpointer().save(jdir, {"params": params}, force=True)

    # a prefix the checkpoint does not hold: KeyError on both sides
    lc = SRFDet(tconfigs.tiny_lc_test_config("vovnet"), device="cpu")
    with pytest.raises(KeyError):
        tckpt.load_partial(lc, ckpt, prefix="img_backbone")
    with pytest.raises(KeyError):
        jckpt.load_partial(dict(params, img_backbone={"w": np.zeros(2)}),
                           jdir, prefix="img_backbone")

    # a shape mismatch: ValueError on both sides
    bad = torch.load(ckpt, weights_only=True)
    name = "pts_backbone.blocks.0.conv.weight"
    assert name in bad["model"]
    bad["model"][name] = torch.zeros(3, 3)
    torch.save(bad, str(tmp_path / "bad.pt"))
    jbad = jax.tree_util.tree_map(lambda a: a, params)
    path = next(_leaf_paths(jbad["pts_backbone"]))
    node = jbad["pts_backbone"]
    for k in path[:-1]:
        node = node[k]
    node[path[-1]] = np.zeros((3, 3), np.float32)
    jckpt._checkpointer().save(str(tmp_path / "jbad"), {"params": jbad},
                               force=True)
    for load in (tckpt.load_pretrained,
                 lambda m, p: tckpt.load_partial(m, p, "pts_backbone")):
        with pytest.raises(ValueError, match="shape mismatch"):
            load(SRFDet(cfg, device="cpu"), str(tmp_path / "bad.pt"))
    with pytest.raises(ValueError, match="shape mismatch"):
        jckpt.load_partial(params, str(tmp_path / "jbad"),
                           prefix="pts_backbone")

    # no parameter matched: KeyError on both sides
    torch.save({"model": {"nothing.weight": torch.zeros(2)}, "step": 0},
               str(tmp_path / "none.pt"))
    jckpt._checkpointer().save(str(tmp_path / "jnone"),
                               {"params": {"nothing": np.zeros(2)}},
                               force=True)
    for load in (tckpt.load_pretrained, tckpt.load_partial):
        with pytest.raises(KeyError, match="ZERO"):
            load(SRFDet(cfg, device="cpu"), str(tmp_path / "none.pt"))
    state = TrainState(step=0, params=params,
                       batch_stats=jvars["batch_stats"], opt_state=None)
    with pytest.raises(KeyError, match="ZERO"):
        jckpt.load_pretrained(state, str(tmp_path / "jnone"))
    with pytest.raises(KeyError, match="ZERO"):
        jckpt.load_partial(params, str(tmp_path / "jnone"))
    # a weights-only checkpoint has no optimizer state to resume from
    with pytest.raises(KeyError, match="optimizer"):
        tckpt.restore_checkpoint(ckpt, model, make_optimizer(model, cfg, 1))


def _leaf_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_paths(v, prefix + (k,))
        else:
            yield prefix + (k,)


def _subtree(tree, paths):
    out = {}
    for path in paths:
        src, dst = tree, out
        for k in path[:-1]:
            src = src[k]
            dst = dst.setdefault(k, {})
        dst[path[-1]] = np.zeros(src[path[-1]].shape, np.float32)
    return out


def test_lidar_checkpoint_into_lc_model(tmp_path):
    from srfdet3d_tpu import configs as jconfigs
    jl = model_shapes(jconfigs.tiny_test_config())
    jlc_cfg = jax_tiny_lc("vovnet")
    jlc = jax.eval_shape(lambda r, b: JSRFDet(jlc_cfg).init(r, b,
                                                          train=False),
                         jax.random.PRNGKey(0), lc_input_shapes(jlc_cfg, 1))
    # JAX: the leaves load_pretrained merges (and their count)
    want = set()
    for coll in ("params", "batch_stats"):
        _, n_hit = jckpt._merge_into(dict(jlc[coll]), dict(jl[coll]))
        hit = [p for p in _leaf_paths(jl[coll])
               if p in set(_leaf_paths(jlc[coll]))]
        assert len(hit) == n_hit > 0
        hc = jlc_cfg.head
        want |= set(jax_state_dict({coll: _subtree(jlc[coll], hit)},
                                   hc.num_heads, hc.num_cls_convs))

    lidar = SRFDet(tconfigs.tiny_test_config(), device="cpu", seed=1)
    path = str(tmp_path / "epoch_1.pt")
    tckpt.save_checkpoint(path, lidar, step=5)
    lc = SRFDet(tconfigs.tiny_lc_test_config("vovnet"), device="cpu",
                seed=2)
    before = {k: v.clone() for k, v in lc.state_dict().items()}
    got = tckpt.load_pretrained(lc, path)
    assert set(got) == want
    src = lidar.state_dict()
    for k, v in lc.state_dict().items():
        if k in want:
            torch.testing.assert_close(v, src[k], rtol=0, atol=0, msg=k)
        else:
            torch.testing.assert_close(v, before[k], rtol=0, atol=0, msg=k)
    assert any(k.startswith("img_backbone.") for k in before) and \
        not any(k.startswith("img_") for k in got)
    # a weights-only checkpoint loads for eval through load_pretrained
    other = SRFDet(tconfigs.tiny_test_config(), device="cpu", seed=3)
    assert tckpt.load_for_eval(path, other) == 5
    assert_same_state(lidar, other)
