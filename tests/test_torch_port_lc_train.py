"""The LiDAR-camera (LC) train step, JAX package against the port, on the
CPU: the tiny LC configs (`srfdet3d_torch.configs.tiny_lc_test_config`:
VoVNet-19-slim with img_conv here, a caffe ResNet-50 with DCNv2, a BN neck
and 8 image-RoI slots a camera in `test_torch_port_lc_train_r50.py`), with
the LiDAR branch frozen as in the shipped LC fine-tunes, held step for
step against JAX `make_train_step` (GridMask off: the two packages' draws
differ; dropout as configured, 0).  Losses, every trainable parameter's
grad and update and the BN statistics at
`torch_port_common.check_train_step`'s tolerances; frozen parameters get
no grad in the port and stay bit for bit on both sides.  Also: the freeze rules (`train.trainer.freeze_mask`)
leaf for leaf against JAX `freeze_mask` through the weight bridge's name
map (`utils.jax_params.jax_param_names`); DCNv2's grads against JAX's
autodiff; the reported grad norm, which JAX takes over every grad, frozen
stages' included (ROADMAP Queue 3, fault 7); and freeze_img's gradient cut
and BN statistics."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srfdet3d_tpu.models.deform_conv import (
    ModulatedDeformConv as JDeformConv)
from srfdet3d_tpu.models.deform_conv import \
    modulated_deform_conv as j_deform
from srfdet3d_tpu.models.detector import SRFDet as JSRFDet
from srfdet3d_torch import configs as tconfigs
from srfdet3d_torch.models.deform_conv import (ModulatedDeformConv,
                                               modulated_deform_conv)
from srfdet3d_torch.models.detector import SRFDet
from srfdet3d_torch.train.trainer import (freeze_mask, make_optimizer,
                                          train_step)
from torch_port_common import (check_freeze_mask, check_lc_train_step,
                               check_reported_grad_norm, jax_lc_train_step,
                               jax_tiny_lc, lc_input_shapes, random_variables)

T = torch.from_numpy


# (backbone, config options): the variants of the freeze rules
VARIANTS = {
    "vovnet_fs0": ("vovnet", dict(frozen_stages=0)),
    "vovnet_fs1": ("vovnet", dict(frozen_stages=1)),
    "vovnet_fs2": ("vovnet", dict(frozen_stages=2)),
    "vovnet_freeze_img": ("vovnet", dict(freeze_img=True)),
    "vovnet_lidar_trains": ("vovnet", dict(freeze_lidar=False)),
    "r50_fs0": ("r50_dcn", dict(frozen_stages=0)),
    "r50_fs1_norm_frozen": ("r50_dcn", dict(frozen_stages=1,
                                            norm_frozen=True)),
    "r50_fs2": ("r50_dcn", dict(frozen_stages=2)),
    "r50_norm_frozen_freeze_img": ("r50_dcn", dict(norm_frozen=True,
                                                   freeze_img=True)),
}


def test_tiny_lc_configs_match_jax():
    """The port's tiny LC configs equal the JAX twins field for field."""
    for backbone, opts in VARIANTS.values():
        assert (dataclasses.asdict(tconfigs.tiny_lc_test_config(
            backbone, **opts)) ==
            dataclasses.asdict(jax_tiny_lc(backbone, **opts)))
    with pytest.raises(KeyError, match="tiny LC"):
        tconfigs.tiny_lc_test_config("vovnet-99")


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_freeze_mask_matches_jax_tiny(variant):
    """Every rule on both backbones: frozen_stages 0-2 (the stem and the
    first N stages), norm_frozen (every backbone BN's scale and bias),
    freeze_img (the whole backbone, frozen_stages then ignored, the neck
    trained), freeze_lidar on and off."""
    backbone, opts = VARIANTS[variant]
    jcfg = jax_tiny_lc(backbone, **opts)
    shapes = jax.eval_shape(lambda r, b: JSRFDet(jcfg).init(r, b),
                            jax.random.PRNGKey(0), lc_input_shapes(jcfg, 1))
    port = SRFDet(tconfigs.tiny_lc_test_config(backbone, **opts),
                  device="cpu")
    frozen = check_freeze_mask(jcfg, port, shapes)
    tops = {k[0] for k in frozen}
    assert ("pts_backbone" in tops) == opts.get("freeze_lidar", True)
    assert "img_neck" not in tops and "bbox_head" not in tops
    fs = 0 if opts.get("freeze_img") else opts.get("frozen_stages", 2)
    mask = freeze_mask(port, port.cfg)
    backbone_mask = [t for n, t in mask.items()
                     if n.startswith("img_backbone.")]
    if opts.get("freeze_img"):
        assert not any(backbone_mask)
    else:
        assert any(backbone_mask)
    if backbone == "vovnet" and not opts.get("freeze_img"):
        stages = {k[1] for k in frozen if k[0] == "img_backbone"}
        assert stages == ({"stem1", "stem2", "stem3"} if fs else set()) | {
            f"stage{s + 2}_block0" for s in range(fs)}


def test_dcn_grads_match_jax():
    """DCNv2's backward (autograd through the plain gathers and the
    product) against jax.grad: the input, the offsets, the modulation
    and the kernel of the sample-and-contract, on offsets of up to 4
    pixels (taps outside the input included), stride 1 and 2; then the
    layer's grads for its input, offset conv and kernel.  Within 1e-5 of
    each grad's largest magnitude."""
    rng = np.random.default_rng(0)
    b, h, w, cin, cout, k = 2, 9, 11, 5, 6, 3
    for stride in (1, 2):
        ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
        args = [rng.normal(0, 1, (b, h, w, cin)),
                rng.normal(0, 0.3, (k * k * cin, cout)),
                rng.uniform(-4, 4, (b, ho, wo, k * k, 2)),
                rng.uniform(0, 1, (b, ho, wo, k * k))]
        args = [a.astype(np.float32) for a in args]
        cot = rng.normal(0, 1, (b, ho, wo, cout)).astype(np.float32)

        def jloss(x, wt, off, m):
            out = j_deform(x, wt, off, m, kernel=k, stride=stride,
                           padding=1)
            return jnp.sum(out * cot)
        want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
            *map(jnp.asarray, args))
        ts = [T(a).requires_grad_() for a in args]
        out = modulated_deform_conv(*ts, k, stride, 1)
        (out * T(cot)).sum().backward()
        for t, g in zip(ts, want):
            g = np.asarray(g)
            np.testing.assert_allclose(t.grad.numpy(), g, rtol=0,
                                       atol=1e-5 * float(np.abs(g).max()))

    x = rng.normal(0, 1, (2, 10, 12, 8)).astype(np.float32)
    jm = JDeformConv(6, 3, 2)
    shapes = jax.eval_shape(lambda r, a: jm.init(r, a),
                            jax.random.PRNGKey(0), jnp.asarray(x))
    params = random_variables(shapes, 5)["params"]
    params["conv_offset"]["kernel"] *= 8.0
    cot = rng.normal(0, 1, (2, 5, 6, 6)).astype(np.float32)

    def layer_loss(p, xx):
        return jnp.sum(jm.apply({"params": p}, xx) * cot)
    gp, gx = jax.grad(layer_loss, argnums=(0, 1))(params, jnp.asarray(x))
    tm = ModulatedDeformConv(8, 6, 3, 2, 1)
    tm.load_state_dict({
        "kernel": T(np.array(params["kernel"])),
        "conv_offset.weight": T(np.array(
            params["conv_offset"]["kernel"]).transpose(3, 2, 0, 1)),
        "conv_offset.bias": T(np.array(params["conv_offset"]["bias"]))})
    tx = T(x).permute(0, 3, 1, 2).contiguous().requires_grad_()
    (tm(tx).permute(0, 2, 3, 1) * T(cot)).sum().backward()
    for got, want in (
            (tx.grad.permute(0, 2, 3, 1), gx),
            (tm.kernel.grad, gp["kernel"]),
            (tm.conv_offset.weight.grad.permute(2, 3, 1, 0),
             gp["conv_offset"]["kernel"]),
            (tm.conv_offset.bias.grad, gp["conv_offset"]["bias"])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()))


# the tiny train step: (backbone, config options, batch seed, weight
# seed), the options as the shipped LC fine-tunes set them (stem and stage
# 1 frozen); the seeds where JAX's own grads move least under one-ulp
# image noise (checked below and in test_tiny_lc_seeds_are_well_conditioned)
STEP = ("vovnet", dict(frozen_stages=1, use_grid_mask=False), 4, 23)


@pytest.fixture(scope="module")
def lc_step():
    return jax_lc_train_step(*STEP)


def test_tiny_lc_train_step_matches_jax(lc_step):
    """VoVNet-19-slim with img_conv, every camera-proposal pair pooled:
    check_lc_train_step (check_train_step's tolerances on every trainable
    leaf, frozen leaves bit for bit, the grad norm over the trainable
    leaves)."""
    check_lc_train_step(lc_step)


def test_reported_grad_norm_differs_from_jax(lc_step):
    """JAX's reported grad_norm spans the frozen stem's and stage's grads
    too (check_reported_grad_norm)."""
    check_reported_grad_norm(lc_step)


def test_freeze_img_cuts_the_backbone_and_restores_its_stats():
    """freeze_img: the backbone gets no grad and no update, the neck and
    the head train; with norm_eval off the backbone's BN normalizes with
    the batch's statistics, and its running statistics are restored after
    the step (JAX trainer.py:311-329), while the neck's move."""
    import chip_smoke
    cfg = tconfigs.tiny_lc_test_config("r50_dcn", freeze_img=True,
                                       norm_eval=False)
    model = SRFDet(cfg, device="cpu", seed=2)
    opt = make_optimizer(model, cfg, 100)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    batch = chip_smoke.lc_batch(cfg, 2, seed=1)
    batch.update({k: v for k, v in chip_smoke.synthetic_batch(
        cfg, 2, seed=1, with_gt=True).items() if k.startswith("gt_")})
    metrics = train_step(model, opt, batch, torch.Generator().manual_seed(0))
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert model.img_backbone.training
    for k, v in model.state_dict().items():
        if k.startswith(("img_backbone.", "pts_")):
            assert torch.equal(v, before[k]), k
    for name, p in model.named_parameters():
        assert (p.grad is None) == name.startswith(("img_backbone.",
                                                     "pts_")), name
    for k in ("img_neck.lateral.0.conv.weight",
              "img_neck.lateral.0.bn.running_mean",
              "bbox_head.dpg_fc1_img.weight"):
        assert not torch.equal(model.state_dict()[k], before[k]), k
