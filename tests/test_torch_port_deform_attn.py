"""PyTorch port vs JAX package: multi-scale deformable attention and the
deformable BEV encoder (`with_lidar_encoder`).

Seeded weights for every leaf (offsets and attention logits of order one,
so taps spread over the maps and some fall off them) go through the
weight bridge's map.  MSDeformAttention and LidarBEVEncoder forwards, in
eval mode and in train mode with dropout 0, within atol 1e-5 of JAX's
(float32 op order: the port samples with grid_sample, JAX gathers); the
grads of every parameter and of the inputs against jax.grad within 1e-5
of each leaf's largest; the BatchNorms' running statistics after one
train-mode call within rtol 1e-5 + atol 1e-6.  Dropout draws from the
explicit generator in train mode and is off in eval mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srfdet3d_tpu.models.deform_attn import LidarBEVEncoder as JEncoder
from srfdet3d_tpu.models.deform_attn import MSDeformAttention as JAttn
from srfdet3d_torch.models.deform_attn import (LidarBEVEncoder,
                                               MSDeformAttention)
from srfdet3d_torch.utils.jax_params import jax_state_dict
from torch_port_common import random_variables

T = torch.from_numpy
C = 32
SHAPES = ((9, 11), (5, 6), (3, 3))
PRE = "bbox_head.lidar_encoder."


def _levels(seed, b=2):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (b, h, w, C)).astype(np.float32)
            for h, w in SHAPES]


def _load(module, variables, prefix):
    """Seeded JAX leaves under bbox_head/lidar_encoder onto `module`,
    through the weight bridge (every port tensor set, none left over)."""
    tree = {coll: {"bbox_head": {"lidar_encoder": v}}
            for coll, v in variables.items()}
    state = {k[len(prefix):]: T(np.array(v)) for k, v in
             jax_state_dict(tree, 1, 2).items()}
    target = {k for k in module.state_dict()
              if not k.endswith("num_batches_tracked")}
    assert set(state) == target
    module.load_state_dict(state, strict=False)


def _grads_close(port_grads, jax_grads, zero=()):
    """Each grad within 1e-5 of its leaf's largest; the leaves in `zero`,
    whose grad is zero up to rounding, each side within 1e-6 of the
    largest grad of all."""
    tree_max = max(float(np.abs(g).max()) for g in jax_grads.values())
    for name, ref in jax_grads.items():
        got = port_grads[name]
        assert got is not None, name
        if name in zero:
            for g in (got, ref):
                assert float(np.abs(g).max()) <= 1e-6 * tree_max, name
            continue
        scale = max(float(np.abs(ref).max()), 1e-6)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * scale,
                                   err_msg=name)


@pytest.fixture(scope="module")
def attn_case():
    levels = _levels(0)
    rng = np.random.default_rng(1)
    q = sum(h * w for h, w in SHAPES)
    query = rng.normal(0, 1, (2, q, C)).astype(np.float32)
    ref = rng.uniform(0, 1, (2, q, 2)).astype(np.float32)
    cot = rng.normal(0, 1, (2, q, C)).astype(np.float32)
    mod = JAttn(C)
    shapes = jax.eval_shape(mod.init, jax.random.PRNGKey(0), query, levels,
                            ref)
    variables = random_variables(shapes, 2)
    variables["params"]["sampling_offsets"]["bias"] *= 10.0

    def loss(params, query, levels, ref):
        out = mod.apply({"params": params}, query, levels, ref)
        return jnp.sum(out * cot), out
    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3), has_aux=True))(
        variables["params"], query, levels, ref)
    return (query, levels, ref, cot, variables,
            jax.device_get(out), jax.device_get(grads))


def test_ms_deform_attention_matches_jax(attn_case):
    query, levels, ref, cot, variables, out, grads = attn_case
    port = MSDeformAttention(C, num_levels=len(SHAPES))
    _load(port, {"params": {"attn_0": variables["params"]}},
          PRE + "layers.0.attn.")
    tq = T(query).requires_grad_()
    tl = [T(v).requires_grad_() for v in levels]
    tr = T(ref).requires_grad_()
    got = port(tq, tl, tr)
    np.testing.assert_allclose(got.detach().numpy(), out, rtol=0, atol=1e-5)
    (got * T(cot)).sum().backward()
    pgrads = {PRE + "layers.0.attn." + n: p.grad.numpy()
              for n, p in port.named_parameters()}
    jgrads = jax_state_dict({"params": {"bbox_head": {"lidar_encoder": {
        "attn_0": grads[0]}}}}, 1, 2)
    _grads_close(pgrads, jgrads)
    _grads_close({"query": tq.grad.numpy(), "ref": tr.grad.numpy(),
                  **{f"level{i}": t.grad.numpy() for i, t in enumerate(tl)}},
                 {"query": grads[1], "ref": grads[3],
                  **{f"level{i}": g for i, g in enumerate(grads[2])}})


@pytest.fixture(scope="module")
def encoder_case():
    levels = _levels(3)
    cots = _levels(4)
    mod = JEncoder(C, dropout=0.0)
    shapes = jax.eval_shape(mod.init, jax.random.PRNGKey(0), levels)
    variables = random_variables(shapes, 5)
    for j in range(2):
        variables["params"][f"attn_{j}"]["sampling_offsets"]["bias"] *= 10.0

    def run(params, levels, train):
        v = {"params": params, "batch_stats": variables["batch_stats"]}
        if train:
            outs, upd = mod.apply(v, levels, train=True,
                                  mutable=["batch_stats"])
        else:
            outs, upd = mod.apply(v, levels, train=False), {}
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots)), (outs, upd)
    res = {}
    for train in (False, True):
        (_, (outs, upd)), grads = jax.jit(jax.value_and_grad(
            lambda p, l: run(p, l, train), argnums=(0, 1), has_aux=True))(
            variables["params"], levels)
        res[train] = jax.device_get((outs, upd, grads))
    return levels, cots, variables, res


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_lidar_encoder_matches_jax(encoder_case, train):
    levels, cots, variables, res = encoder_case
    outs, upd, grads = res[train]
    port = LidarBEVEncoder(C, num_levels=len(SHAPES))
    _load(port, variables, PRE)
    port.dropout_rate = 0.0
    port.train(train)
    tl = [T(v).requires_grad_() for v in levels]
    got = port(tl)
    for g, o in zip(got, outs):
        np.testing.assert_allclose(g.detach().numpy(), o, rtol=0, atol=1e-5)
    sum((g * T(c)).sum() for g, c in zip(got, cots)).backward()
    pgrads = {PRE + n: p.grad.numpy() for n, p in port.named_parameters()}
    jgrads = jax_state_dict({"params": {"bbox_head": {"lidar_encoder":
                                                      grads[0]}}}, 1, 2)
    assert set(pgrads) == set(jgrads)
    # in train mode the BatchNorm takes out the shift of the Dense before
    # it: that bias's grad is zero but for rounding
    zero = {PRE + f"pos.{i}.fc1.bias" for i in range(len(SHAPES))
            } if train else ()
    _grads_close(pgrads, jgrads, zero)
    _grads_close({f"level{i}": t.grad.numpy() for i, t in enumerate(tl)},
                 {f"level{i}": g for i, g in enumerate(grads[1])})
    stats = {k[len(PRE):]: v for k, v in jax_state_dict(
        {"batch_stats": {"bbox_head": {"lidar_encoder": (
            upd["batch_stats"] if train else variables["batch_stats"])}}},
        1, 2).items()}
    for name, buf in port.named_buffers():
        if name.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(buf.numpy(), stats[name], rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    if train:
        # the statistics moved: the call's BN ran on its batch
        before = jax_state_dict({"batch_stats": {"bbox_head": {
            "lidar_encoder": variables["batch_stats"]}}}, 1, 2)
        assert any(not np.allclose(stats[k[len(PRE):]], v)
                   for k, v in before.items())


def test_lidar_encoder_dropout_uses_the_generator():
    """Train mode at the fixed rate 0.1 draws its masks from the explicit
    generator (same seed, same outputs; another seed, others), needs one,
    and eval mode ignores the rate."""
    levels = [T(v) for v in _levels(6, b=1)]
    port = LidarBEVEncoder(C, num_levels=len(SHAPES))
    port.init_weights(torch.Generator().manual_seed(0))
    assert port.dropout_rate == 0.1
    port.train()
    with torch.no_grad():
        a = port(levels, torch.Generator().manual_seed(1))
        b = port(levels, torch.Generator().manual_seed(1))
        c = port(levels, torch.Generator().manual_seed(2))
        with pytest.raises(ValueError, match="Generator"):
            port(levels)
        port.eval()
        d = port(levels)
        e = port(levels)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))
    assert all(torch.equal(x, y) for x, y in zip(d, e))
