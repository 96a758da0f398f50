"""Shared helpers of the port's parity tests (JAX package vs PyTorch port):
seeded numpy weight trees for a JAX model's variables, one whole train
step on both sides on the same weights and batch, and the tiny LC configs'
train step through JAX make_train_step."""

import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as graft
from srfdet3d_tpu import config as jconfig
from srfdet3d_tpu import configs as jconfigs
from srfdet3d_tpu.models.detector import SRFDet as JSRFDet
from srfdet3d_tpu.models.head import decode_boxes as j_decode_boxes
from srfdet3d_tpu.models.losses import srfdet_losses as j_losses
from srfdet3d_tpu.train.trainer import TrainState
from srfdet3d_tpu.train.trainer import freeze_mask as j_freeze_mask
from srfdet3d_tpu.train.trainer import make_optimizer as j_optimizer
from srfdet3d_tpu.train.trainer import make_train_step as j_train_step
from srfdet3d_torch import configs as tconfigs
from srfdet3d_torch.models.detector import SRFDet
from srfdet3d_torch.train.trainer import (freeze_mask, make_lr_schedule,
                                          make_optimizer, train_step)
from srfdet3d_torch.utils.jax_params import (jax_param_names, jax_state_dict,
                                             load_jax_params)

T = torch.from_numpy

# One intra-op thread for torch in every test process that imports this
# module (under pytest-xdist every worker collects, and so imports, every
# test module): the suite runs six processes on the same cores, where
# torch's OpenMP threads spin against each other and the JAX compiles
# (six port files on an 8-core host: 459 s under -n 6 with the default
# threads, 100 s with one); the tiny models gain nothing from more.
torch.set_num_threads(1)


def random_variables(shapes, seed):
    """Seeded numpy weights for every leaf of a JAX variable tree."""
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


def model_shapes(jcfg, batch_size=1):
    """The JAX SRFDet's variable shapes (jax.eval_shape, no init)."""
    p = jcfg.points_cap
    batch = {"points": jax.ShapeDtypeStruct((batch_size, p, jcfg.points_dim),
                                            jnp.float32),
             "points_mask": jax.ShapeDtypeStruct((batch_size, p), jnp.bool_)}
    return jax.eval_shape(
        lambda r, b: JSRFDet(jcfg).init(r, b, train=False),
        jax.random.PRNGKey(0), batch)


def param_count(tree) -> int:
    return sum(int(np.prod(s.shape))
               for s in jax.tree_util.tree_leaves(tree["params"]))


def jax_step_program(jcfg, batch, weight_seed, total=100):
    """One JAX train step on numpy `batch` (dropout as configured, rng key
    0), lowered and not compiled: (weights, the lowered step, its args).
    Compiled and run it returns the losses' sum, the losses, the grads,
    the parameters after one AdamW update, the new BN statistics and the
    grads' global norm."""
    model = JSRFDet(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    shapes = jax.eval_shape(lambda r, b: model.init(r, b, train=False),
                            jax.random.PRNGKey(0), jb)
    variables = random_variables(shapes, weight_seed)
    tx = j_optimizer(jcfg, total)

    def loss_fn(params, batch_stats):
        (logits, boxes), upd = model.apply(
            {"params": params, "batch_stats": batch_stats}, jb, train=True,
            mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(0)})
        losses = j_losses(logits, boxes, jb["gt_boxes"], jb["gt_labels"],
                          jb["gt_mask"], jcfg.loss, jcfg.ota,
                          decoder_num_heads=jcfg.head.num_heads)
        return sum(losses.values()), (losses, upd["batch_stats"])

    def step(params, batch_stats):
        (total_loss, (losses, new_bs)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params, batch_stats)
        upd, _ = tx.update(grads, tx.init(params), params)
        return (total_loss, losses, grads, optax.apply_updates(params, upd),
                new_bs, optax.global_norm(grads))

    args = (variables["params"], variables["batch_stats"])
    return variables, jax.jit(step).lower(*args), args


def jax_train_step(jcfg, batch_size, batch_seed, weight_seed, total=100):
    """JAX side of one train step on the synthetic scene (seed
    batch_seed): the batch (numpy), the weights and jax_step_program's
    outputs."""
    batch = {k: np.array(v) for k, v in graft._synthetic_batch(
        jcfg, batch_size, with_gt=True, seed=batch_seed).items()}
    variables, lowered, args = jax_step_program(jcfg, batch, weight_seed,
                                                total)
    return batch, variables, jax.device_get(lowered.compile()(*args))


def jax_bf16_steps(jcfg16, jcfg32, batch, weight_seed):
    """The JAX step in a bf16 mode, compiled twice (EXACT_BF16, and with
    XLA's default excess precision), and in float32, on the same weights
    and batch: (weights, {"exact", "default", "f32": outputs})."""
    variables, lowered, args = jax_step_program(jcfg16, batch, weight_seed)
    outs = {"exact": lowered.compile(compiler_options=EXACT_BF16)(*args),
            "default": lowered.compile()(*args)}
    _, lowered32, _ = jax_step_program(jcfg32, batch, weight_seed)
    outs["f32"] = lowered32.compile()(*args)
    return variables, jax.device_get(outs)


def check_bf16_grads(port, tcfg, outs, ulp=2.0 ** -7):
    """The port's grads after a bf16 step (float32, bf16 values where the
    leaf computes in bf16) against jax_bf16_steps' outputs.  The JAX
    package's bf16 grads are defined only up to how XLA compiles them: its
    two bf16 programs differ from each other about as much as from float32
    (ill-conditioned tiny steps; bf16 reductions in the backward that one
    compile accumulates in bf16 and the other in float32).  So every leaf's
    mean |port - JAX exact| must stay within that spread, the larger of its
    mean |JAX exact - JAX f32| and |JAX exact - JAX default|, plus one bf16
    ulp of the leaf's mean |grad|; and over the tree, the port must sit
    closer to JAX's exact bf16 grads than those sit from float32 (the
    attention key biases, zero up to rounding, left out).  Frozen leaves
    get no grad.  Returns (the tree's ratio, the worst leaf's
    distance over its bound)."""
    hc = tcfg.head
    g = {k: jax_state_dict({"params": o[2]}, hc.num_heads, hc.num_cls_convs)
         for k, o in outs.items()}
    num = den = worst = 0.0
    for name, p in port.named_parameters():
        if not p.requires_grad:
            assert p.grad is None, name
            continue
        assert p.grad is not None and p.grad.dtype == torch.float32, name
        if name.endswith("k_proj.bias"):
            continue   # zero up to rounding: softmax ignores a key shift
        ref = g["exact"][name]
        d_port = np.abs(p.grad.numpy() - ref)
        d_f32 = np.abs(ref - g["f32"][name])
        num, den = num + float(d_port.sum()), den + float(d_f32.sum())
        spread = max(float(d_f32.mean()),
                     float(np.abs(ref - g["default"][name]).mean()))
        bound = spread + ulp * float(np.abs(ref).mean())
        assert float(d_port.mean()) <= bound, (name, float(d_port.mean()),
                                               bound)
        worst = max(worst, float(d_port.mean()) / bound)
    assert num < den, num / den
    return num / den, worst


def check_train_step(tcfg, batch, variables, out, total=100,
                     frozen=frozenset()):
    """The port's train step on the JAX step's weights and batch, held as
    test_torch_port_train.py holds the tiny flagship's: losses within 1e-5
    relative, every grad within 2e-4 of its leaf's largest (2e-10 of the
    tree's largest where that is more; the attention key biases and the
    deformable encoder's first positional biases (ahead of a train-mode
    BatchNorm), whose grad is zero up to rounding, each side within 1e-9
    of it), the
    parameters after AdamW within 1e-6 where the grad is resolved and
    within 2 lr elsewhere, the BN statistics within rtol 1e-4 + atol
    1e-5.  `frozen`: the port parameters the freeze rules hold, which get
    no grad and stay bit for bit (JAX's update of them is exactly zero).
    The port's grad norm is held against `out`'s.  Returns the worst grad
    error over its leaf's largest."""
    port = SRFDet(tcfg, device="cpu")
    load_jax_params(port, variables)
    opt = make_optimizer(port, tcfg, total)
    metrics = train_step(port, opt, {k: T(v) for k, v in batch.items()},
                         torch.Generator().manual_seed(0))
    return compare_train_step(tcfg, port_step_result(port, metrics),
                              variables, out, total, frozen)


def port_step_result(port, metrics):
    """A port train step's outcome as numpy: (metrics, grads by parameter
    name (None where a parameter got none), the state_dict after the
    update without torch's BN step counters, the names of the parameters
    that do not require a grad)."""
    return ({k: float(v) for k, v in metrics.items()},
            {n: None if p.grad is None else p.grad.detach().numpy().copy()
             for n, p in port.named_parameters()},
            {k: v.detach().numpy().copy()
             for k, v in port.state_dict().items()
             if not k.endswith("num_batches_tracked")},
            {n for n, p in port.named_parameters() if not p.requires_grad})


def compare_train_step(tcfg, result, variables, out, total=100,
                       frozen=frozenset()):
    """check_train_step's comparison of a port step's outcome
    (port_step_result) with the JAX step's `out` on `variables`."""
    total_loss, losses, grads, new_params, new_bs, gnorm = out
    metrics, port_grads, port_state, no_grad = result
    hc = tcfg.head
    assert sorted(k for k in metrics if k.startswith(("loss", "s."))) == \
        sorted(list(losses) + ["loss"])
    for k, v in losses.items():
        np.testing.assert_allclose(metrics[k], float(v), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(metrics["loss"], float(total_loss),
                               rtol=1e-5)
    np.testing.assert_allclose(metrics["grad_norm"], float(gnorm),
                               rtol=1e-4)
    jgrad = jax_state_dict({"params": grads}, hc.num_heads, hc.num_cls_convs)
    assert set(jgrad) == set(port_grads)
    assert no_grad == set(frozen)
    tols, worst = {}, 0.0
    tree_max = max(float(np.abs(g).max()) for g in jgrad.values())
    for name, ref in jgrad.items():
        got = port_grads[name]
        if name in frozen:
            assert got is None, name
            continue
        assert got is not None, name
        if name.endswith("k_proj.bias") or re.fullmatch(
                r"bbox_head\.lidar_encoder\.pos\.\d+\.fc1\.bias", name):
            # zero but for rounding on both sides: the softmax ignores a
            # shift along the keys, a train-mode BatchNorm one along the
            # rows (the encoder's positional MLP)
            for g in (got, ref):
                assert float(np.abs(g).max()) <= 1e-9 * tree_max, name
            tols[name] = np.inf       # its update: noise, within 2 lr
            continue
        scale = max(float(np.abs(ref).max()), 1e-6 * tree_max)
        tols[name] = 2e-4 * scale
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=tols[name], err_msg=name)
        worst = max(worst, float(np.abs(got - ref).max()) / scale)
    lr0 = make_lr_schedule(tcfg.optim, total)(0)
    after = jax_state_dict({"params": new_params, "batch_stats": new_bs},
                           hc.num_heads, hc.num_cls_convs)
    before = jax_state_dict(variables, hc.num_heads, hc.num_cls_convs)
    state = port_state
    assert set(after) == set(state)
    for name, ref in after.items():
        got = state[name]
        if name in frozen:
            np.testing.assert_array_equal(ref, before[name], err_msg=name)
            np.testing.assert_array_equal(got, before[name], err_msg=name)
        elif name in jgrad:
            resolved = np.abs(jgrad[name]) > tols[name]
            np.testing.assert_allclose(got[resolved], ref[resolved],
                                       rtol=0, atol=1e-6, err_msg=name)
            np.testing.assert_allclose(got, ref, rtol=0, atol=2 * lr0 + 1e-6,
                                       err_msg=name)
        else:                                          # BN statistics
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5,
                                       err_msg=name)
    return worst


def uniform_points(cfg, batch_size, seed):
    """Half of points_cap real points, uniform in the range."""
    rng = np.random.default_rng(seed)
    p = cfg.points_cap
    n = p // 2
    pts = np.zeros((batch_size, p, cfg.points_dim), np.float32)
    lo, hi = np.array(cfg.pc_range[:3]), np.array(cfg.pc_range[3:])
    pts[:, :n, :3] = rng.uniform(lo, hi, (batch_size, n, 3))
    pts[:, :n, 3:] = rng.uniform(0, 1, (batch_size, n, cfg.points_dim - 3))
    mask = np.zeros((batch_size, p), bool)
    mask[:, :n] = True
    return pts, mask


def lidar2img_rig(n_cam: int, h: int, w: int) -> np.ndarray:
    """(n_cam, 4, 4) float32 pinhole projections for (h, w) images:
    cameras at x = -3 (even cameras, looking along +x) and x = +3 (odd
    ones, looking along -x), so a box beyond a camera is behind it."""
    f, cx, cy = 40.0, w / 2.0, h / 2.0
    k = np.array([[f, 0, cx, 0], [0, f, cy, 0],
                  [0, 0, 1, 0], [0, 0, 0, 1]], np.float64)
    mats = []
    for cam in range(n_cam):
        sign = 1.0 if cam % 2 == 0 else -1.0
        # cam axes: x_cam = -sign*y, y_cam = -z, z_cam = sign*x + 3
        e = np.array([[0, -sign, 0, 0],
                      [0, 0, -1, 0],
                      [sign, 0, 0, 3.0],
                      [0, 0, 0, 1]], np.float64)
        mats.append(k @ e)
    return np.stack(mats).astype(np.float32)


@functools.lru_cache(maxsize=8)
def init_shapes(jcfg, signature):
    """The JAX SRFDet's variable shapes for a batch of `signature` ((name,
    shape, dtype) of each input), traced once a process and shared by the
    cases that build the same model."""
    batch = {k: jax.ShapeDtypeStruct(shape, dtype)
             for k, shape, dtype in signature}
    return jax.eval_shape(
        lambda r, b: JSRFDet(jcfg).init(r, b, train=False),
        jax.random.PRNGKey(0), batch)


def check_predict(jcfg, tcfg, batch_size=2, points_seed=0, weight_seed=12,
                  extra=None, variables_hook=None, init_extra=None):
    """JAX SRFDet.predict (its forward and decode_boxes in one jitted
    program) against the port's on the same points and the same seeded
    weights (class biases zeroed, so scores spread over (0, 1)
    and decoding has work): forward logits and boxes within 1e-4, decoded
    scores within 1e-5 and boxes within 1e-4 (float32 op order); labels and
    valid flags (the NMS keep sets) exactly.  `extra`: more numpy inputs
    for both batches (an LC model's images and lidar2img);
    `variables_hook(variables)` edits the seeded weights before both sides
    load them; `init_extra`: inputs that only size the weights (an LC
    model's images, for a predict run without them).  Returns the port's
    decode."""
    pts, mask = uniform_points(tcfg, batch_size, points_seed)
    extra = extra or {}
    model = JSRFDet(jcfg)
    jbatch = {"points": jnp.asarray(pts), "points_mask": jnp.asarray(mask),
              **{k: jnp.asarray(v) for k, v in extra.items()}}
    init_batch = {**jbatch, **{k: jnp.asarray(v)
                               for k, v in (init_extra or {}).items()}}
    shapes = init_shapes(jcfg, tuple(
        (k, v.shape, v.dtype.name) for k, v in sorted(init_batch.items())))
    variables = random_variables(shapes, weight_seed)
    head = variables["params"]["bbox_head"]["head_series"]["single_head"]
    head["class_logits"]["bias"][:] = 0.0
    if variables_hook is not None:
        variables_hook(variables)
    t = jcfg.test

    @jax.jit
    def run(v, b):
        # JSRFDet.predict's body (the forward, then decode_boxes with the
        # config's test settings) on one forward, shared with the raw
        # outputs: one trace and one compile of the model, not two
        logits, boxes = model.apply(v, b, train=False)
        return logits, boxes, j_decode_boxes(
            logits[-1], boxes[-1], use_nms=t.use_nms, nms_thr=t.nms_thr,
            score_thr=t.score_thr, max_per_img=t.max_per_img,
            post_center_range=t.post_center_range)

    j_logits, j_boxes, j_out = jax.device_get(run(variables, jbatch))
    port = SRFDet(tcfg, device="cpu")
    load_jax_params(port, variables)
    batch = {"points": T(pts), "points_mask": T(mask),
             **{k: T(v) for k, v in extra.items()}}
    with torch.no_grad():
        t_logits, t_boxes = port(batch)
    t_out = port.predict(batch)
    hc = tcfg.head
    assert t_boxes.shape == (hc.num_heads, batch_size, hc.num_proposals,
                             hc.code_size)
    np.testing.assert_allclose(t_logits.numpy(), j_logits, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(t_boxes.numpy(), j_boxes, rtol=1e-4,
                               atol=1e-4)
    for k in ("labels", "valid"):
        np.testing.assert_array_equal(t_out[k].numpy(), np.asarray(j_out[k]))
    np.testing.assert_allclose(t_out["scores"].numpy(), j_out["scores"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t_out["boxes"].numpy(), j_out["boxes"],
                               rtol=1e-4, atol=1e-4)
    assert t_out["valid"].sum() > 0
    return t_out


# XLA's default lets a fusion keep a bfloat16 intermediate in float32
# ("excess precision"), so a jitted bf16 program rounds at fewer places
# than its ops' dtypes say, and where depends on the fusion.  The bf16
# references compile with it off: every op's output is rounded to its dtype,
# the rounding points the JAX package's modules write down (flax's dtype=),
# which the port follows.  (On the tiny LiDAR predict the port's bf16
# logits equal this program's bit for bit; against the default-compiled one
# they sit 0.87 as far as that program sits from float32.)
EXACT_BF16 = {"xla_allow_excess_precision": False}


def bf16_predict_ratios(jcfg32, cases, batch_size=2, points_seed=0,
                        weight_seed=12, extra=None, tcfg32=None):
    """The port's forward in a bfloat16 mode against the JAX package's in
    the same mode and in float32, on the same points and seeded weights
    (class biases zeroed).  cases: (JAX config, port config) pairs of the
    bf16 modes, each against the one float32 JAX program of jcfg32.  For
    the logits and the box centres of every layer: the mean |port - JAX
    bf16| over the mean |JAX bf16 - JAX f32|.  A ratio well below 1 says
    the port rounds where the JAX package rounds.  With `tcfg32` the
    float32 reference is the port's float32 model instead of a JAX
    compile (one compile fewer, where another test holds that model to
    JAX's float32 at 1e-4, far inside bf16's distances).  Also asserts that both
    sides' boxes are float32 and the port's outputs finite.  Returns, a
    case, (ratios, the port model, its (logits, boxes))."""
    pts, mask = uniform_points(cases[0][1], batch_size, points_seed)
    jbatch = {"points": jnp.asarray(pts), "points_mask": jnp.asarray(mask),
              **{k: jnp.asarray(v) for k, v in (extra or {}).items()}}
    shapes = init_shapes(jcfg32, tuple(
        (k, v.shape, v.dtype.name) for k, v in sorted(jbatch.items())))
    variables = random_variables(shapes, weight_seed)
    head = variables["params"]["bbox_head"]["head_series"]["single_head"]
    head["class_logits"]["bias"][:] = 0.0
    batch = {"points": T(pts), "points_mask": T(mask),
             **{k: T(v) for k, v in (extra or {}).items()}}

    def jax_outputs(jcfg):
        model = JSRFDet(jcfg)
        logits, boxes = jax.device_get(jax.jit(
            lambda v, b: model.apply(v, b, train=False),
            compiler_options=EXACT_BF16)(variables, jbatch))
        assert boxes.dtype == np.float32
        return np.asarray(logits, np.float32), boxes[..., :3]

    if tcfg32 is None:
        ref32 = jax_outputs(jcfg32)
    else:
        port32 = SRFDet(tcfg32, device="cpu")
        load_jax_params(port32, variables)
        with torch.no_grad():
            logits, boxes = port32(batch)
        ref32 = (logits.numpy(), boxes[..., :3].numpy())
    results = []
    for jcfg16, tcfg16 in cases:
        ref16 = jax_outputs(jcfg16)
        port = SRFDet(tcfg16, device="cpu")
        load_jax_params(port, variables)
        with torch.no_grad():
            logits, boxes = port(batch)
        assert boxes.dtype == torch.float32
        got = (logits.float().numpy(), boxes[..., :3].numpy())
        assert all(np.isfinite(g).all() for g in got)
        ratios = {}
        for i, key in enumerate(("logits", "centres")):
            d_port = np.abs(got[i] - ref16[i]).mean()
            d_ref = np.abs(ref16[i] - ref32[i]).mean()
            assert d_ref > 0, key
            ratios[key] = float(d_port / d_ref)
        results.append((ratios, port, (logits, boxes)))
    return results


def check_bridge(tcfg, shapes, n_params=None, branch="pts_voxel_encoder"):
    """Zero weights of every JAX leaf through load_jax_params: each JAX
    leaf consumed once (the head's stacked leaves split per iteration),
    every port tensor set, the parameter counts equal (and equal to
    n_params where given); a stray JAX leaf and a missing one (both in
    the module `branch`) raise."""
    variables = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes)
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    hc = tcfg.head
    state = jax_state_dict(variables, hc.num_heads, hc.num_cls_convs)
    stacked = len(jax.tree_util.tree_leaves(
        variables["params"]["bbox_head"]["head_series"]))
    assert len(state) == n_leaves + stacked * (hc.num_heads - 1)
    port = SRFDet(tcfg, device="cpu")
    load_jax_params(port, variables)         # raises on unset port tensors
    for p in port.parameters():
        assert float(p.detach().abs().max()) == 0.0
    n_port = sum(p.numel() for p in port.parameters())
    assert n_port == param_count(shapes)
    if n_params is not None:
        assert n_port == n_params
    broken = jax.tree_util.tree_map(lambda a: a, variables)
    broken["params"][branch]["Dense_7"] = {
        "kernel": np.zeros((3, 4), np.float32)}
    with pytest.raises(KeyError):
        load_jax_params(port, broken)
    short = jax.tree_util.tree_map(lambda a: a, variables)
    del short["batch_stats"][branch]
    with pytest.raises(KeyError):
        load_jax_params(port, short)
    return port


# ---------------------------------------------------------------------------
# the LiDAR-camera (LC) train step


def jax_tiny_lc(backbone="vovnet", freeze_img=False, freeze_lidar=True,
                **img):
    """The JAX package's twin of the port's tiny_lc_test_config, from its
    own config classes."""
    base = jconfigs.tiny_test_config()
    if backbone == "vovnet":
        branch = dict(backbone="vovnet-19-slim", neck_out_channels=64)
        head = dict(feat_channels_img=64)
    else:
        branch = dict(backbone="resnet-50", neck_out_channels=32,
                      neck_norm=True, resnet_style="caffe",
                      stage_with_dcn=(False, False, True, True))
        head = dict(feat_channels_img=32, img_roi_cap=8)
    branch = {"num_cams": 2, "img_shape": (64, 128), **branch, **img}
    return base.replace(
        name=f"tiny_lc_{backbone}", use_img=True,
        img=jconfig.ImgBranchConfig(**branch),
        head=dataclasses.replace(base.head, **head),
        optim=dataclasses.replace(base.optim, freeze_img=freeze_img,
                                  freeze_lidar=freeze_lidar))


def lc_batch_np(jcfg, batch_size, batch_seed):
    """The synthetic scene and GT of __graft_entry__ with chip_smoke's
    seeded images and surround rig (camera_rig), numpy."""
    import chip_smoke
    batch = {k: np.array(v) for k, v in graft._synthetic_batch(
        jcfg, batch_size, with_gt=True, seed=batch_seed).items()}
    cams = chip_smoke.lc_batch(jcfg, batch_size, seed=batch_seed)
    batch["images"] = cams["images"].numpy()
    batch["lidar2img"] = cams["lidar2img"].numpy()
    return batch


def lc_frozen_names(jcfg, variables):
    """The port parameters that JAX freeze_mask freezes, through the
    weight bridge's name map."""
    hc = jcfg.head
    names = jax_param_names(variables, hc.num_heads, hc.num_cls_convs)
    mask = dict(jax.tree_util.tree_flatten_with_path(
        j_freeze_mask(variables["params"], jcfg))[0])
    return {n for path, t in mask.items() if not t
            for n in names[tuple(k.key for k in path)]}


def jax_lc_train_step(backbone, opts, batch_seed, weight_seed, batch_size=2,
                      total=100):
    """One step of JAX make_train_step (rng key 0) on seeded weights, for
    the tiny LC config (backbone, opts).  Returns (JAX config, port config,
    batch, weights, (loss, losses, grads, new params, new BN statistics,
    the reported grad norm))."""
    jcfg = jax_tiny_lc(backbone, **opts)
    batch = lc_batch_np(jcfg, batch_size, batch_seed)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    model = JSRFDet(jcfg)
    shapes = jax.eval_shape(lambda r, b: model.init(r, b, train=False),
                            jax.random.PRNGKey(0), jb)
    variables = random_variables(shapes, weight_seed)
    tx = j_optimizer(jcfg, total)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=jax.tree_util.tree_map(
                           jnp.asarray, variables["batch_stats"]),
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
    tcfg = tconfigs.tiny_lc_test_config(backbone, **opts)
    return jcfg, tcfg, batch, variables, (total_loss, losses, grads,
                                          new_params, new_bs, float(gnorm))


def _trainable_sq(grads, jcfg):
    """(sum of squares over the trainable leaves, over the frozen ones)."""
    mask = j_freeze_mask(grads, jcfg)
    pairs = zip(jax.tree_util.tree_leaves(grads),
                jax.tree_util.tree_leaves(mask))
    sq = [(float(np.sum(np.square(g))), t) for g, t in pairs]
    return (sum(v for v, t in sq if t), sum(v for v, t in sq if not t))


def check_lc_train_step(step_out):
    """check_train_step on jax_lc_train_step's output: every trainable
    leaf at its tolerances, the frozen ones (JAX freeze_mask's, through
    the name map) without a grad and bit for bit, the port's grad norm
    against the norm of JAX's grads over the trainable leaves; the image
    backbone has frozen and trainable leaves."""
    jcfg, tcfg, batch, variables, out = step_out
    frozen = lc_frozen_names(jcfg, variables)
    train_sq, _ = _trainable_sq(out[2], jcfg)
    check_train_step(tcfg, batch, variables, out[:5] + (np.sqrt(train_sq),),
                     frozen=frozen)
    hc = jcfg.head
    backbone = {n for ns in jax_param_names(variables, hc.num_heads,
                                            hc.num_cls_convs).values()
                for n in ns if n.startswith("img_backbone.")}
    assert backbone & frozen and backbone - frozen


def check_reported_grad_norm(step_out):
    """JAX's reported grad_norm (optax.global_norm of the unmasked grads,
    trainer.py:331) spans every grad it computes, the frozen stem's and
    stage's among them (its LiDAR grads are zero: stop_gradient), so it
    exceeds the norm over the trainable leaves that the clip uses and the
    port reports.  A difference of the reference's logged metric, not of
    the update (ROADMAP Queue 3, fault 7)."""
    jcfg, _, _, _, out = step_out
    train_sq, frozen_sq = _trainable_sq(out[2], jcfg)
    assert frozen_sq > 1e-6 * train_sq
    np.testing.assert_allclose(out[5], np.sqrt(frozen_sq + train_sq),
                               rtol=1e-5)
    assert out[5] > np.sqrt(train_sq) * (1 + 1e-7)


def lc_input_shapes(cfg, batch_size):
    """ShapeDtypeStructs of an LC batch, to size the JAX variables."""
    ic, p = cfg.img, cfg.points_cap
    return {
        "points": jax.ShapeDtypeStruct((batch_size, p, cfg.points_dim),
                                       jnp.float32),
        "points_mask": jax.ShapeDtypeStruct((batch_size, p), jnp.bool_),
        "images": jax.ShapeDtypeStruct(
            (batch_size, ic.num_cams) + tuple(ic.img_shape) + (3,),
            jnp.float32),
        "lidar2img": jax.ShapeDtypeStruct((batch_size, ic.num_cams, 4, 4),
                                          jnp.float32)}


def check_freeze_mask(jcfg, port, shapes):
    """The port's freeze_mask against JAX's, leaf for leaf through the
    name map: every port parameter named once; returns the frozen JAX
    paths' top two keys."""
    hc = jcfg.head
    names = jax_param_names(shapes, hc.num_heads, hc.num_cls_convs)
    want = dict(jax.tree_util.tree_flatten_with_path(
        j_freeze_mask(shapes["params"], jcfg))[0])
    got = freeze_mask(port, port.cfg)
    seen = []
    frozen = set()
    for path, trainable in want.items():
        keys = tuple(k.key for k in path)
        for name in names[keys]:
            assert got[name] == trainable, (keys, name)
            seen.append(name)
        if not trainable:
            frozen.add(keys[:2])
    assert sorted(seen) == sorted(got)
    return frozen


# ---------------------------------------------------------------------------
# reference (mm-stack) state dicts for the checkpoint converters


def _reference_resnet_state(cfg, rng, st):
    """The LC image entries of a ResNet config in the reference's naming
    (mmdet ResNet with DCNv2 stages, an FPN with BN and no conv bias or a
    plain one with bias, the head's image extras and fused projections),
    as test_torch_convert_full.py builds the VoVNet ones."""
    from srfdet3d_tpu.models.resnet import RESNET_DEPTHS

    def t(key, *shape):
        st[key] = rng.normal(size=shape).astype(np.float32) * 0.05

    def bn2(prefix, c):
        t(f"{prefix}.weight", c)
        t(f"{prefix}.bias", c)
        st[f"{prefix}.running_mean"] = np.zeros(c, np.float32)
        st[f"{prefix}.running_var"] = np.ones(c, np.float32)
        st[f"{prefix}.num_batches_tracked"] = np.asarray(1)

    ic = cfg.img
    depth = int(ic.backbone.split("-")[1])
    kind, layers = RESNET_DEPTHS[depth]
    assert kind == "bottleneck"
    t("img_backbone.conv1.weight", 64, 3, 7, 7)
    bn2("img_backbone.bn1", 64)
    planes, in_ch = 64, 64
    outs = []
    for l, n in enumerate(layers, start=1):
        for i in range(n):
            tm = f"img_backbone.layer{l}.{i}"
            t(f"{tm}.conv1.weight", planes, in_ch, 1, 1)
            bn2(f"{tm}.bn1", planes)
            t(f"{tm}.conv2.weight", planes, planes, 3, 3)
            bn2(f"{tm}.bn2", planes)
            if ic.stage_with_dcn[l - 1]:
                t(f"{tm}.conv2.conv_offset.weight", 27, planes, 3, 3)
                t(f"{tm}.conv2.conv_offset.bias", 27)
            t(f"{tm}.conv3.weight", planes * 4, planes, 1, 1)
            bn2(f"{tm}.bn3", planes * 4)
            if i == 0:
                t(f"{tm}.downsample.0.weight", planes * 4, in_ch, 1, 1)
                bn2(f"{tm}.downsample.1", planes * 4)
            in_ch = planes * 4
        outs.append(in_ch)
        planes *= 2
    noc = ic.neck_out_channels
    for i, cin in enumerate(outs):
        for conv, k, c_in in (("lateral_convs", 1, cin),
                              ("fpn_convs", 3, noc)):
            t(f"img_neck.{conv}.{i}.conv.weight", noc, c_in, k, k)
            if ic.neck_norm:
                bn2(f"img_neck.{conv}.{i}.bn", noc)
            else:
                t(f"img_neck.{conv}.{i}.conv.bias", noc)
    hc = cfg.head
    hid, c = hc.hidden_dim, hc.feat_channels_lidar
    if hid != hc.feat_channels_img:
        for i in range(hc.img_feat_lvls):
            t(f"bbox_head.img_convs.{i}.weight", hid, hc.feat_channels_img,
              3, 3)
            t(f"bbox_head.img_convs.{i}.bias", hid)
    for lvl in range(hc.img_feat_lvls - 1):
        ch = hid * (lvl + 1)
        t(f"bbox_head.dpg_dw_convs_img.{lvl}.conv.weight", ch, 1, 3, 3)
        bn2(f"bbox_head.dpg_dw_convs_img.{lvl}.bn", ch)
    t("bbox_head.dpg_fc1_img.weight", 1500, 30 * 30)
    t("bbox_head.dpg_fc1_img.bias", 1500)
    t("bbox_head.dpg_fc2_img.weight", hc.num_dpg_exp * hc.num_proposals,
      1500)
    t("bbox_head.dpg_fc2_img.bias", hc.num_dpg_exp * hc.num_proposals)
    for it in range(hc.num_heads):
        m = f"bbox_head.head_series_lidar.{it}"
        t(f"{m}.output_fused_proj.weight", c, hid + c)
        t(f"{m}.output_fused_proj.bias", c)


def reference_state(cfg, seed):
    """A seeded state dict with the reference's module names and torch
    layouts (spconv 'KIO') for any shipped or tiny port config: the
    generators of test_torch_convert_full.py for the LiDAR branch (the
    pillar one for a pillar config) and the VoVNet image branch,
    _reference_resnet_state for a ResNet one, and the DynamicVFE's
    centroid MLP (cen2point_pos_enc, whose width 32 widens the first
    layer's input).  The DPG's first Linears take their input width from
    the port model (the generators' grid arithmetic holds for the
    full-width LiDAR grids only, and their image DPG is 30 x 30, KITTI
    LC's 30 x 15)."""
    import test_torch_convert_full as full
    rng = np.random.default_rng(seed)
    if cfg.middle.kind == "pillar_scatter":
        st = full._synthetic_torch_state_pillar(cfg, rng)
    else:
        st = full._synthetic_torch_state(cfg, rng)
    if cfg.vfe.kind == "dynamic" and cfg.vfe.with_centroid_aware:
        tp = "pts_voxel_encoder.cen2point_pos_enc"
        for li, bi, cin in ((0, 1, 3), (3, 4, 32)):
            st[f"{tp}.{li}.weight"] = rng.normal(
                size=(32, cin)).astype(np.float32)
            for leaf, val in (("weight", rng.uniform(0.8, 1.2, 32)),
                              ("bias", rng.normal(0, 0.1, 32)),
                              ("running_mean", rng.normal(0, 0.1, 32)),
                              ("running_var", rng.uniform(0.5, 1.5, 32))):
                st[f"{tp}.{bi}.{leaf}"] = val.astype(np.float32)
    if cfg.use_img:
        if cfg.img.backbone.startswith("vovnet"):
            full._synthetic_torch_img_state(cfg, rng, st)
        else:
            _reference_resnet_state(cfg, rng, st)
    shapes = meta_state_shapes(cfg)
    for ref, port in (("dpg_fc1_lidar", "dpg_fc1"),
                      ("dpg_fc1_img", "dpg_fc1_img")):
        key = f"bbox_head.{ref}.weight"
        want = shapes.get(f"bbox_head.{port}.weight")
        if key in st and st[key].shape != want:
            st[key] = rng.normal(size=want).astype(np.float32) * 0.05
    return st


def spconv_to_oki(state):
    """The same state dict with every spconv weight (5-D, KIO) in spconv
    2.x's (out, kz, ky, kx, in) layout."""
    return {k: (np.transpose(v, (4, 0, 1, 2, 3))
                if k.startswith("pts_middle_encoder.") and np.ndim(v) == 5
                else v) for k, v in state.items()}


def jax_route_state(state, jcfg, layout="KIO"):
    """The port's state dict by the JAX route: the JAX package's
    convert_reference_state_dict, then the weight bridge's map onto the
    port's names (numpy)."""
    from srfdet3d_tpu.utils.torch_convert import (
        convert_reference_state_dict as j_convert)
    hc = jcfg.head
    return jax_state_dict(j_convert(state, jcfg, spconv_layout=layout),
                          hc.num_heads, hc.num_cls_convs)


def meta_state_shapes(tcfg):
    """The port model's state_dict shapes less the BN step counters,
    built on the meta device."""
    with torch.device("meta"):
        port = SRFDet(tcfg, device="meta")
    return {k: tuple(v.shape) for k, v in port.state_dict().items()
            if not k.endswith("num_batches_tracked")}
