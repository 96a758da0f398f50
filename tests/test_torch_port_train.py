"""PyTorch port vs JAX package: the train step.

Focal loss, 3D IoU and the box codec within 1e-5; OTA assignments exactly
(seeded inputs whose costs have no near-ties); `srfdet_losses` within 1e-5;
the lr schedule and the flat AdamW against the JAX optimizer.  Then one
whole tiny train step (`tiny_test_config(points_cap=256, voxels_cap=256,
gt_cap=4)` with the patch RoIAlign and its capacity rule scaled down,
roi_patch=8, roi_patch_fallback=2) on the same weights and the same batch:
losses within 1e-5 relative, every parameter's grad against `jax.grad`
within 2e-4 of that leaf's largest grad (float32 op order through train-mode
BN and five sparse conv stages; the worst leaf measured 2.7e-5).  A leaf
whose grad is zero up to rounding (the attention key bias: the softmax
ignores a shift along the keys) is held at 2e-10 of the tree's largest
grad instead.  After one flat-AdamW step every
parameter and BN statistic against JAX's through `jax_state_dict`.  Adam's
first step moves a parameter by about lr * sign(grad), so an element whose
grad is inside the grad tolerance may move the other way: those are held
within 2 lr, all others within 1e-6.

Also one test for each fault the train step needed in the predict slice's
modules: the head's returned boxes keep their graph, dropout in train mode,
and ConvBNReLU's running variance (flax stores the biased one)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as graft
from srfdet3d_tpu import configs as jconfigs
from srfdet3d_tpu.assign.ota import ota_assign_batch as j_ota
from srfdet3d_tpu.geometry import boxes as jboxes
from srfdet3d_tpu.geometry import iou as jiou
from srfdet3d_tpu.models.detector import SRFDet as JSRFDet
from srfdet3d_tpu.models.layers import ConvBNReLU as JConvBNReLU
from srfdet3d_tpu.models.losses import srfdet_losses as j_losses
from srfdet3d_tpu.ops import focal_loss as jfocal
from srfdet3d_tpu.train.trainer import make_lr_schedule as j_schedule
from srfdet3d_tpu.train.trainer import make_optimizer as j_optimizer
from srfdet3d_torch import configs as tconfigs
from srfdet3d_torch.assign.ota import ota_assign, ota_assign_batch
from srfdet3d_torch.geometry import boxes as tboxes
from srfdet3d_torch.geometry import iou as tiou
from srfdet3d_torch.models.detector import SRFDet
from srfdet3d_torch.models.head import SRFDetHead
from srfdet3d_torch.models.layers import ConvBNReLU
from srfdet3d_torch.models.losses import srfdet_losses
from srfdet3d_torch.ops import focal_loss as tfocal
from srfdet3d_torch.train.trainer import (losses_of, make_lr_schedule,
                                          make_optimizer, train_step)
from srfdet3d_torch.utils.jax_params import jax_state_dict, load_jax_params

T = torch.from_numpy
B = 2


def _close(t, j, tol=1e-5):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=tol,
                               atol=tol)


def _raw_boxes(rng, shape, spread=8.0):
    """Raw [cx, cy, cz, w, l, h, yaw, vx, vy] boxes."""
    return np.concatenate([
        rng.uniform(-spread, spread, shape + (2,)),
        rng.uniform(-2, 1, shape + (1,)), rng.uniform(0.5, 4.0, shape + (3,)),
        rng.uniform(-np.pi, np.pi, shape + (1,)),
        rng.normal(0, 1, shape + (2,))], -1).astype(np.float32)


def _preds_near(rng, gt, n_p):
    """(B, n_p, 10) predicted codes scattered around the GTs, so the
    assignment gates pass and costs spread."""
    b, g, _ = gt.shape
    src = gt[:, rng.integers(0, g, n_p)]
    raw = src + np.concatenate([
        rng.normal(0, 0.8, (b, n_p, 3)), rng.normal(0, 0.3, (b, n_p, 3)),
        rng.normal(0, 0.5, (b, n_p, 1)), rng.normal(0, 0.3, (b, n_p, 2))],
        -1).astype(np.float32)
    raw[..., 3:6] = np.abs(raw[..., 3:6]) + 0.3
    return np.asarray(jboxes.normalize_bbox(jnp.asarray(raw)))


def _assign_case(seed, g=6, n_p=40, valid=4):
    rng = np.random.default_rng(seed)
    gt = _raw_boxes(rng, (B, g))
    pred = _preds_near(rng, gt, n_p)
    logits = rng.normal(0, 2, (B, n_p, 10)).astype(np.float32)
    labels = rng.integers(0, 10, (B, g)).astype(np.int32)
    mask = np.zeros((B, g), bool)
    mask[:, :valid] = True
    return pred, logits, gt, labels, mask


def test_focal_loss_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 3, (4, 30, 10)).astype(np.float32)
    labels = rng.integers(0, 11, (4, 30))            # 10 = background
    _close(tfocal.sigmoid_focal_loss(T(logits), T(labels)),
           jfocal.sigmoid_focal_loss(jnp.asarray(logits),
                                     jnp.asarray(labels)))
    gl = rng.integers(0, 10, (7,))
    _close(tfocal.focal_loss_cost(T(logits[0]), T(gl), weight=2.0),
           jfocal.focal_loss_cost(jnp.asarray(logits[0]), jnp.asarray(gl),
                                  weight=2.0))


def test_iou_3d_and_normalize_match_jax():
    rng = np.random.default_rng(1)
    a = _raw_boxes(rng, (25,), spread=3.0)
    b = _raw_boxes(rng, (17,), spread=3.0)
    got = tiou.iou_3d(T(a[:, :7]), T(b[:, :7]))
    ref = jiou.iou_3d(jnp.asarray(a[:, :7]), jnp.asarray(b[:, :7]))
    assert float(np.asarray(ref).max()) > 0.1
    _close(got, ref)
    _close(tboxes.normalize_bbox(T(a)), jboxes.normalize_bbox(jnp.asarray(a)))
    _close(tboxes.normalize_bbox(T(a[:, :7])),
           jboxes.normalize_bbox(jnp.asarray(a[:, :7])))


_j_ota = jax.jit(j_ota, static_argnums=(6,))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ota_assign_exact(seed):
    """matched_gt equal to the JAX assignment, at every head index, batched
    over layers and per sample."""
    pred, logits, gt, labels, mask = _assign_case(seed)
    ocfg = jconfigs.srfdet_voxel_nusc_L().ota
    tcfg = tconfigs.srfdet_voxel_nusc_L().ota
    heads = [1, 3, 5]
    ref = np.stack([np.asarray(_j_ota(
        jnp.asarray(pred), jnp.asarray(logits), jnp.asarray(gt),
        jnp.asarray(labels), jnp.asarray(mask), jnp.float32(h), ocfg))
        for h in heads])
    lead = (len(heads), B)
    got = ota_assign_batch(
        T(np.broadcast_to(pred, lead + pred.shape[1:]).copy()),
        T(np.broadcast_to(logits, lead + logits.shape[1:]).copy()),
        T(np.broadcast_to(gt, lead + gt.shape[1:]).copy()),
        T(np.broadcast_to(labels, lead + labels.shape[1:]).copy()),
        T(np.broadcast_to(mask, lead + mask.shape[1:]).copy()),
        torch.tensor(heads, dtype=torch.float32), tcfg)
    np.testing.assert_array_equal(got.numpy(), ref)
    # every valid GT is matched, and some preds stay unmatched
    for layer in range(len(heads)):
        for i in range(B):
            assert set(range(4)) <= set(ref[layer, i].tolist())
    assert (ref == -1).any()
    one = ota_assign(T(pred[0].copy()), T(logits[0]), T(gt[0]),
                     T(labels[0]), T(mask[0]), 5, tcfg)
    np.testing.assert_array_equal(one.numpy(), ref[2, 0])


def test_srfdet_losses_match_jax():
    pred, logits, gt, labels, mask = _assign_case(5)
    rng = np.random.default_rng(5)
    layers = 3
    pb = np.stack([pred + rng.normal(0, 0.05, pred.shape).astype(np.float32)
                   for _ in range(layers)])
    pl = np.stack([logits + rng.normal(0, 0.3, logits.shape)
                   .astype(np.float32) for _ in range(layers)])
    gt[1, 5, 3] = 0.0                  # a degenerate padded GT: log(0)
    jcfg = jconfigs.srfdet_voxel_nusc_L()
    tcfg = tconfigs.srfdet_voxel_nusc_L()
    ref = jax.jit(j_losses, static_argnums=(5, 6, 7))(
        jnp.asarray(pb), jnp.asarray(pl), jnp.asarray(gt),
        jnp.asarray(labels), jnp.asarray(mask), jcfg.loss, jcfg.ota, 5)
    got = srfdet_losses(T(pb), T(pl), T(gt), T(labels), T(mask), tcfg.loss,
                        tcfg.ota, decoder_num_heads=5)
    assert sorted(got) == sorted(ref)
    for k in ref:
        _close(got[k], ref[k])
    with pytest.raises(NotImplementedError):
        srfdet_losses(T(pb), T(pl), T(gt), T(labels), T(mask),
                      dataclasses.replace(tcfg.loss, assigner="hungarian"),
                      tcfg.ota)


def test_lr_schedule_matches_jax():
    jcfg = jconfigs.tiny_test_config()
    tcfg = tconfigs.tiny_test_config()
    total = 5000
    js = j_schedule(jcfg.optim, total)
    ts = make_lr_schedule(tcfg.optim, total)
    # JAX evaluates in float32, the port in float64
    for count in (0, 1, 777, 1999, 2000, 2001, 4000, 4999, 6000):
        np.testing.assert_allclose(ts(count), float(js(count)), rtol=1e-5)


class _Tree(torch.nn.Module):
    """Parameters named like the detector's top-level modules."""

    def __init__(self, leaves):
        super().__init__()
        for top, sub in leaves.items():
            mod = torch.nn.Module()
            for name, a in sub.items():
                mod.register_parameter(name, torch.nn.Parameter(T(a.copy())))
            self.add_module(top, mod)


@pytest.mark.parametrize("freeze,gscale", [(False, 1e-3), (False, 1e3),
                                           (True, 1e3)])
def test_flat_adamw_matches_jax(freeze, gscale):
    """Four steps through the warmup, the clip untriggered and triggered,
    frozen leaves unchanged."""
    jcfg = jconfigs.tiny_test_config()
    tcfg = tconfigs.tiny_test_config()
    jcfg = jcfg.replace(optim=dataclasses.replace(jcfg.optim,
                                                  freeze_lidar=freeze))
    tcfg = tcfg.replace(optim=dataclasses.replace(tcfg.optim,
                                                  freeze_lidar=freeze))
    rng = np.random.default_rng(0)
    leaves = {"pts_backbone": {"w": rng.normal(size=(4, 3))},
              "bbox_head": {"b": rng.normal(size=(7,)),
                            "k": rng.normal(size=(2, 2, 2))}}
    leaves = jax.tree_util.tree_map(lambda a: a.astype(np.float32), leaves)
    tx = j_optimizer(jcfg, 50)
    params = jax.tree_util.tree_map(jnp.asarray, leaves)
    state = tx.init(params)
    model = _Tree(leaves)
    opt = make_optimizer(model, tcfg, 50)
    for _ in range(4):
        grads = jax.tree_util.tree_map(
            lambda x: (rng.normal(size=x.shape) * gscale).astype(np.float32),
            leaves)
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads),
                               state, params)
        params = optax.apply_updates(params, upd)
        for name, p in model.named_parameters():
            top, leaf = name.split(".")
            p.grad = T(grads[top][leaf].copy())
        opt.step()
        for name, p in model.named_parameters():
            top, leaf = name.split(".")
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(params[top][leaf]),
                                       rtol=2e-5, atol=1e-7)
    if freeze:
        np.testing.assert_array_equal(model.pts_backbone.w.detach().numpy(),
                                      leaves["pts_backbone"]["w"])


# ---------------------------------------------------------------------------
# the whole tiny step


def _tiny_cfgs():
    over = dict(points_cap=256, voxels_cap=256, gt_cap=4)
    out = []
    for mod in (jconfigs, tconfigs):
        cfg = mod.tiny_test_config(**over)
        out.append(cfg.replace(head=dataclasses.replace(
            cfg.head, roi_patch=8, roi_patch_fallback=2)))
    return out


def _random_variables(shapes, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        keys = [k.key for k in path]
        name = keys[-1]
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape)
        if name in ("mean", "bias"):
            return rng.normal(0, 0.1, s.shape)
        if name == "scale":
            return rng.uniform(0.8, 1.2, s.shape)
        if name.startswith("init_proposal"):
            return rng.normal(0, 1, s.shape)
        lead = 1 if "head_series" in keys else 0
        fan_in = np.prod(s.shape[lead:-1])
        return rng.normal(0, 1 / np.sqrt(fan_in), s.shape)
    return jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(leaf(p, s), np.float32), shapes)


@pytest.fixture(scope="module")
def tiny_step():
    """JAX side of one tiny train step: losses, grads, and the state after
    one flat-AdamW update, plus the inputs."""
    jcfg, tcfg = _tiny_cfgs()
    batch = {k: np.array(v) for k, v in
             graft._synthetic_batch(jcfg, B, with_gt=True, seed=4).items()}
    model = JSRFDet(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    shapes = jax.eval_shape(lambda r, b: model.init(r, b, train=False),
                            jax.random.PRNGKey(0), jb)
    variables = _random_variables(shapes, 21)
    tx = j_optimizer(jcfg, 100)

    def loss_fn(params, batch_stats):
        (logits, boxes), upd = model.apply(
            {"params": params, "batch_stats": batch_stats}, jb, train=True,
            mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(0)})
        losses = j_losses(logits, boxes, jb["gt_boxes"], jb["gt_labels"],
                          jb["gt_mask"], jcfg.loss, jcfg.ota,
                          decoder_num_heads=jcfg.head.num_heads)
        return sum(losses.values()), (losses, upd["batch_stats"])

    @jax.jit
    def step(params, batch_stats):
        (total, (losses, new_bs)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params, batch_stats)
        upd, _ = tx.update(grads, tx.init(params), params)
        return (total, losses, grads, optax.apply_updates(params, upd),
                new_bs, optax.global_norm(grads))

    out = jax.device_get(step(variables["params"], variables["batch_stats"]))
    return tcfg, batch, variables, out


def test_tiny_train_step_matches_jax(tiny_step):
    tcfg, batch, variables, (total, losses, grads, new_params, new_bs,
                             gnorm) = tiny_step
    hc = tcfg.head
    port = SRFDet(tcfg, device="cpu")
    load_jax_params(port, variables)
    opt = make_optimizer(port, tcfg, 100)
    metrics = train_step(port, opt, {k: T(v) for k, v in batch.items()},
                         torch.Generator().manual_seed(0))
    for k, v in losses.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(metrics["loss"]), float(total),
                               rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(gnorm),
                               rtol=1e-4)
    assert float(gnorm) > tcfg.optim.grad_clip         # the clip is taken

    # every parameter's grad, including the DPG and proposal embeddings,
    # whose grads reach them through the RoIs
    jgrad = jax_state_dict({"params": grads}, hc.num_heads, hc.num_cls_convs)
    params = dict(port.named_parameters())
    assert set(jgrad) == set(params)
    tols = {}
    tree_max = max(float(np.abs(g).max()) for g in jgrad.values())
    for name, ref in jgrad.items():
        got = params[name].grad
        assert got is not None, name
        tols[name] = 2e-4 * max(float(np.abs(ref).max()), 1e-6 * tree_max)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=tols[name], err_msg=name)

    lr0 = make_lr_schedule(tcfg.optim, 100)(0)
    after = jax_state_dict({"params": new_params, "batch_stats": new_bs},
                           hc.num_heads, hc.num_cls_convs)
    state = {k: v for k, v in port.state_dict().items()
             if not k.endswith("num_batches_tracked")}
    assert set(after) == set(state)
    for name, ref in after.items():
        got = state[name].numpy()
        if name in jgrad:
            resolved = np.abs(jgrad[name]) > tols[name]
            np.testing.assert_allclose(got[resolved], ref[resolved],
                                       rtol=0, atol=1e-6, err_msg=name)
            np.testing.assert_allclose(got, ref, rtol=0, atol=2 * lr0 + 1e-6,
                                       err_msg=name)
        else:                                          # BN statistics
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5,
                                       err_msg=name)


def _grad_sensitivity(over, model_seed, batch_seed, steps):
    """Worst leaf's grad change, over `steps` tiny train steps, when every
    weight is scaled by (1 + 1e-6 noise): max |dg| / max |g| per leaf
    (the attention key biases, zero up to rounding, left out)."""
    import copy
    import chip_smoke
    cfg = tconfigs.tiny_test_config(**over)
    cfg = cfg.replace(head=dataclasses.replace(cfg.head, roi_patch=8,
                                               roi_patch_fallback=2))
    batch = chip_smoke.synthetic_batch(cfg, 2, seed=batch_seed,
                                       with_gt=True)
    model = SRFDet(cfg, device="cpu", seed=model_seed)
    opt = make_optimizer(model, cfg, 100)

    def grads(m, eps):
        m = copy.deepcopy(m)
        g = torch.Generator().manual_seed(5)
        with torch.no_grad():
            for p in m.parameters():
                p.mul_(1 + eps * torch.randn(p.shape, generator=g))
        m.train()
        losses = losses_of(m, batch, torch.Generator().manual_seed(0))
        sum(losses.values()).backward()
        return {n: p.grad for n, p in m.named_parameters()
                if not n.endswith("k_proj.bias")}

    worst = 0.0
    for _ in range(steps):
        a, b = grads(model, 0.0), grads(model, 1e-6)
        worst = max(worst, max(float((a[n] - b[n]).abs().max() /
                                     a[n].abs().max()) for n in a))
        train_step(model, opt, batch, torch.Generator().manual_seed(0))
    return worst


def test_tiny_train_seeds_are_well_conditioned():
    """A float32 step's grads jump where an activation sits on a ReLU's
    kink.  chip_smoke's tiny card-vs-CPU train phase holds grads at 2e-3
    of a leaf's largest, so its seeds must keep every leaf's grad within
    1e-3 under a 1e-6 change of the weights (for two steps), where other
    seeds move a leaf's grad by more than 1e-2."""
    small = dict(points_cap=256, voxels_cap=256, gt_cap=4)
    assert _grad_sensitivity(small, 2, 5, steps=2) < 1e-3
    assert _grad_sensitivity({}, 3, 4, steps=1) > 1e-2


def test_freeze_lidar_keeps_the_lidar_branch():
    """freeze_lidar: the pts_* modules stay in eval mode, out of the
    optimizer, and bit-identical (weights and BN statistics) over a train
    step, while the head trains (JAX trainer.py:208-216, 310-327)."""
    import chip_smoke
    cfg = tconfigs.tiny_test_config(points_cap=256, voxels_cap=256,
                                    gt_cap=4)
    cfg = cfg.replace(optim=dataclasses.replace(cfg.optim,
                                                freeze_lidar=True))
    model = SRFDet(cfg, device="cpu", seed=0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = make_optimizer(model, cfg, 100)
    train_step(model, opt, chip_smoke.synthetic_batch(cfg, 2, seed=0,
                                                      with_gt=True),
               torch.Generator().manual_seed(0))
    assert not model.pts_middle_encoder.training and model.bbox_head.training
    trainable = {id(p) for p in opt.params}
    for name, p in model.named_parameters():
        assert (id(p) in trainable) == (not name.startswith("pts_")), name
    for k, v in model.state_dict().items():
        if k.startswith("pts_"):
            assert torch.equal(v, before[k]), k
    assert not torch.equal(model.bbox_head.dpg_fc1.weight,
                           before["bbox_head.dpg_fc1.weight"])


# ---------------------------------------------------------------------------
# the faults of the predict slice's modules that training exposed


def _tiny_head(dropout=0.0):
    torch.manual_seed(0)
    head = SRFDetHead(3, 16, 2, 25, num_proposals=6, num_heads=3,
                      num_dpg_exp=2, pc_range=(-10, -10, -5, 10, 10, 3),
                      voxel_size=(0.25, 0.25, 0.2), lidar_strides=(8, 16),
                      dim_feedforward=32, num_attn_heads=4, dynamic_dim=4,
                      dropout=dropout)
    with torch.no_grad():
        for p in head.parameters():
            p.normal_(0, 0.3)
    feats = [torch.randn(2, 16, 10, 10), torch.randn(2, 16, 5, 5)]
    return head, feats


def test_head_returned_boxes_keep_their_graph():
    """Every iteration's returned boxes carry gradient to its own box
    regressor; only the carry into the next iteration is detached."""
    head, feats = _tiny_head()
    head.train()
    _, boxes = head(feats)
    assert boxes.requires_grad
    for i, single in enumerate(head.heads):
        g = torch.autograd.grad(boxes[i].sum(), single.bboxes_delta.weight,
                                allow_unused=True, retain_graph=True)[0]
        assert g is not None and float(g.abs().max()) > 0, i
        if i + 1 < len(head.heads):
            later = torch.autograd.grad(
                boxes[i + 1].sum(), single.bboxes_delta.weight,
                allow_unused=True, retain_graph=True)[0]
            assert later is None or float(later.abs().max()) == 0


def test_head_dropout_in_train_mode():
    """Train mode drops out with the caller's generator (and raises without
    one); eval mode does not; the attention mask is shared by the batch."""
    head, feats = _tiny_head(dropout=0.3)
    head.eval()
    with torch.no_grad():
        ref = head(feats)[0]
        head.train()
        with pytest.raises(ValueError, match="Generator"):
            head(feats)
        a = head(feats, torch.Generator().manual_seed(1))[0]
        b = head(feats, torch.Generator().manual_seed(1))[0]
        c = head(feats, torch.Generator().manual_seed(2))[0]
    assert torch.equal(a, b)
    assert not torch.allclose(a, ref) and not torch.allclose(a, c)
    attn = head.heads[0].self_attn
    x = torch.randn(1, 6, 16).expand(2, 6, 16)
    with torch.no_grad():
        y = attn(x, 0.5, torch.Generator().manual_seed(3))
        y0 = attn(x)
    assert torch.equal(y[0], y[1]) and not torch.allclose(y, y0)


def test_convbnrelu_running_var_matches_flax():
    """Train-mode ConvBNReLU: output and the running statistics of one
    update against flax's BatchNorm, which stores the biased variance."""
    rng = np.random.default_rng(3)
    x = rng.normal(0.5, 2.0, (2, 4, 4, 6)).astype(np.float32)     # NHWC
    mod = JConvBNReLU(8, kernel=3, stride=1, padding=1)
    v = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = jax.tree_util.tree_map(np.asarray, v)
    v["batch_stats"]["BatchNorm_0"]["var"] = rng.uniform(
        0.5, 1.5, 8).astype(np.float32)
    ref, upd = mod.apply(v, jnp.asarray(x), train=True,
                         mutable=["batch_stats"])
    port = ConvBNReLU(6, 8)
    port.conv.weight.data = T(np.asarray(
        v["params"]["Conv_0"]["kernel"]).transpose(3, 2, 0, 1).copy())
    port.bn.running_var.data = T(v["batch_stats"]["BatchNorm_0"]["var"])
    port.train()
    got = port(T(x.transpose(0, 3, 1, 2).copy()))
    _close(got.permute(0, 2, 3, 1), ref, tol=1e-4)
    for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(
            getattr(port.bn, ours).numpy(),
            np.asarray(upd["batch_stats"]["BatchNorm_0"][theirs]),
            rtol=1e-5, atol=1e-6)
