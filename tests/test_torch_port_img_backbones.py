"""The port's image backbones and image neck against the JAX package's, on
the CPU: VoVNet (srfdet3d_torch/models/vovnet.py), ResNet in both styles
with DCNv2 (models/resnet.py), the modulated deformable conv
(models/deform_conv.py) and the image FPN (models/fpn.py).  Inputs and
weights are seeded numpy arrays; the weights reach the port through the
weight bridge (utils/jax_params.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from srfdet3d_tpu.models.deform_conv import (
    ModulatedDeformConv as JDeformConv)
from srfdet3d_tpu.models.deform_conv import \
    modulated_deform_conv as j_deform
from srfdet3d_tpu.models.fpn import FPN as JFPN
from srfdet3d_tpu.models.resnet import ResNet as JResNet
from srfdet3d_tpu.models.vovnet import VOVNET_SPECS as J_SPECS
from srfdet3d_tpu.models.vovnet import VoVNet as JVoVNet
from srfdet3d_torch.models.deform_conv import (ModulatedDeformConv,
                                               modulated_deform_conv)
from srfdet3d_torch.models.fpn import FPN, upsample_nearest
from srfdet3d_torch.models.resnet import ResNet
from srfdet3d_torch.models.vovnet import (VOVNET_SPECS, VoVNet,
                                          max_pool_pad_end)
from srfdet3d_torch.utils.jax_params import jax_state_dict
from torch_port_common import random_variables

T = torch.from_numpy


def _run_backbone(jmodel, tmodel, images, seed):
    """Both backbones on the same NHWC images and seeded weights (eval
    mode): the JAX stage outputs and the port's, NHWC numpy."""
    x = jnp.asarray(images)
    shapes = jax.eval_shape(lambda r, a: jmodel.init(r, a),
                            jax.random.PRNGKey(0), x)
    variables = random_variables(shapes, seed)
    j_out = jax.device_get(jax.jit(jmodel.apply)(variables, x))
    wrapped = {coll: {"img_backbone": tree}
               for coll, tree in variables.items()}
    state = {k[len("img_backbone."):]: T(np.array(v)) for k, v in
             jax_state_dict(wrapped, 1, 1).items()}
    tmodel.load_state_dict(state, strict=False)
    missing = {k for k in tmodel.state_dict()
               if not k.endswith("num_batches_tracked")} - set(state)
    assert not missing, sorted(missing)[:4]
    tmodel.eval()
    with torch.no_grad():
        t_out = tmodel(T(images).permute(0, 3, 1, 2).contiguous())
    return j_out, [o.permute(0, 2, 3, 1).numpy() for o in t_out]


def _close(got, want, rtol):
    """Within rtol of the output's largest magnitude (float32 sums in
    another order through a deep random-weight stack)."""
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


def test_vovnet_specs_match_jax():
    assert VOVNET_SPECS == J_SPECS


def test_max_pool_pads_bottom_and_right_only():
    """flax max_pool((3, 3), (2, 2), padding [(0, 1), (0, 1)]) on odd and
    even sizes, with negative inputs (a zero pad would show): equal."""
    rng = np.random.default_rng(0)
    for h, w in ((7, 9), (8, 10), (15, 31), (3, 4)):
        x = -np.abs(rng.normal(0, 1, (2, h, w, 3))).astype(np.float32) - 1
        want = fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                            padding=[(0, 1), (0, 1)])
        got = max_pool_pad_end(T(x).permute(0, 3, 1, 2))
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                      np.asarray(want))


def test_vovnet_19_slim_matches_jax_on_odd_levels():
    """VoVNet-19-slim's four stages on 60 x 124 images: levels 15 x 31,
    7 x 15, 3 x 7 and 1 x 3, every one odd, so each stage's (0, 1) -inf
    pool takes its padded column and row.  Within 1e-5 of each stage's
    largest magnitude."""
    images = np.random.default_rng(1).normal(
        0, 1, (2, 60, 124, 3)).astype(np.float32)
    j_out, t_out = _run_backbone(JVoVNet("vovnet-19-slim"),
                                 VoVNet("vovnet-19-slim"), images, seed=3)
    assert [o.shape[1:3] for o in t_out] == [(15, 31), (7, 15), (3, 7),
                                             (1, 3)]
    for got, want in zip(t_out, j_out):
        assert got.shape == want.shape
        _close(got, want, 1e-5)


@pytest.mark.parametrize("style,dcn", [
    ("pytorch", (False,) * 4),
    ("caffe", (False, False, True, True))])
def test_resnet50_matches_jax(style, dcn):
    """ResNet-50's four stages on 2 x 64 x 96 images: pytorch style (the
    stride on the 3x3 conv) and caffe style (on the first 1x1 conv) with
    DCNv2 in stages 3-4 under seeded non-zero offset convs.  Within 1e-5 of
    each stage's largest magnitude."""
    images = np.random.default_rng(2).normal(
        0, 1, (2, 64, 96, 3)).astype(np.float32)
    j_out, t_out = _run_backbone(
        JResNet(50, style=style, stage_with_dcn=dcn),
        ResNet(50, style=style, stage_with_dcn=dcn), images, seed=4)
    assert [o.shape[1:] for o in t_out] == [
        (16, 24, 256), (8, 12, 512), (4, 6, 1024), (2, 3, 2048)]
    for got, want in zip(t_out, j_out):
        _close(got, want, 1e-5)


@pytest.mark.parametrize("stride", [1, 2])
def test_modulated_deform_conv_matches_jax(stride):
    """The DCNv2 sample-and-contract on seeded offsets of up to 4 pixels
    (taps fractional and partly outside the 9 x 11 input, each corner
    reading zero on its own) and seeded modulation: within 1e-5."""
    rng = np.random.default_rng(stride)
    b, h, w, cin, cout, k = 2, 9, 11, 5, 6, 3
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    x = rng.normal(0, 1, (b, h, w, cin)).astype(np.float32)
    weight = rng.normal(0, 0.3, (k * k * cin, cout)).astype(np.float32)
    offset = rng.uniform(-4, 4, (b, ho, wo, k * k, 2)).astype(np.float32)
    mask = rng.uniform(0, 1, (b, ho, wo, k * k)).astype(np.float32)
    want = j_deform(jnp.asarray(x), jnp.asarray(weight), jnp.asarray(offset),
                    jnp.asarray(mask), kernel=k, stride=stride, padding=1)
    got = modulated_deform_conv(T(x), T(weight), T(offset), T(mask), k,
                                stride, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # some taps fall outside the input, some inside with fractional
    # positions
    py = (np.arange(ho)[None, :, None, None] * stride - 1 +
          np.repeat(np.arange(k), k) + offset[..., 0])
    assert (py < 0).any() and (py > h - 1).any()
    assert (np.abs(py - np.round(py)) > 0.1).any()


@pytest.mark.parametrize("stride", [1, 2])
def test_deform_conv_layer_matches_jax(stride):
    """The DCNv2 layer (offset conv at the layer's stride, (dy, dx)
    interleaved per tap, then the modulation logits) with a seeded
    non-zero offset conv: within 1e-5."""
    rng = np.random.default_rng(10 + stride)
    x = rng.normal(0, 1, (2, 10, 12, 8)).astype(np.float32)
    jm = JDeformConv(6, 3, stride)
    shapes = jax.eval_shape(lambda r, a: jm.init(r, a),
                            jax.random.PRNGKey(0), jnp.asarray(x))
    params = random_variables(shapes, 5)["params"]
    # offsets of a few pixels: a larger offset-conv init than fan-in's
    params["conv_offset"]["kernel"] *= 8.0
    want = jm.apply({"params": params}, jnp.asarray(x))
    tm = ModulatedDeformConv(8, 6, 3, stride, 1)
    tm.load_state_dict({
        "kernel": T(np.array(params["kernel"])),
        "conv_offset.weight": T(np.array(
            params["conv_offset"]["kernel"]).transpose(3, 2, 0, 1)),
        "conv_offset.bias": T(np.array(params["conv_offset"]["bias"]))})
    with torch.no_grad():
        off = tm.conv_offset(T(x).permute(0, 3, 1, 2))
        got = tm(T(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert float(off[:, :18].abs().max()) > 1.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("use_norm", [False, True])
def test_image_fpn_matches_jax(use_norm):
    """The image neck: plain convs with bias (use_norm False) or BN + ReLU
    (the Waymo LC neck), four inputs and two stride-2 extra convs with
    relu_before_extra_convs (a ReLU before the second only).  Every level
    within 1e-5 of its largest magnitude."""
    rng = np.random.default_rng(20)
    chans, sizes = (16, 24, 32, 40), ((32, 48), (16, 24), (8, 12), (4, 6))
    xs = [rng.normal(0, 1, (2, h, w, c)).astype(np.float32)
          for c, (h, w) in zip(chans, sizes)]
    jm = JFPN(out_channels=8, num_outs=6, use_norm=use_norm,
              use_act=use_norm, relu_before_extra_convs=True)
    jx = [jnp.asarray(x) for x in xs]
    shapes = jax.eval_shape(lambda r, a: jm.init(r, a),
                            jax.random.PRNGKey(0), jx)
    variables = random_variables(shapes, 21)
    want = jm.apply(variables, jx)
    wrapped = {coll: {"img_neck": tree} for coll, tree in variables.items()}
    tm = FPN(chans, 8, 6, use_norm=use_norm, relu_before_extra_convs=True)
    tm.load_state_dict({k[len("img_neck."):]: T(np.array(v)) for k, v in
                        jax_state_dict(wrapped, 1, 1).items()},
                       strict=False)
    tm.eval()
    with torch.no_grad():
        got = tm([T(x).permute(0, 3, 1, 2) for x in xs])
    assert len(got) == 6 and got[-1].shape == (2, 8, 1, 2)
    for g, w in zip(got, want):
        _close(g.permute(0, 2, 3, 1).numpy(), np.asarray(w), 1e-5)


def test_upsample_nearest_refuses_other_factors():
    """The FPN's top-down upsample equals jax.image.resize 'nearest' only
    at integer factors, and raises at any other."""
    x = torch.zeros(1, 2, 5, 7)
    assert upsample_nearest(x, (10, 21)).shape == (1, 2, 10, 21)
    for hw in ((11, 14), (10, 15), (7, 7)):
        with pytest.raises(ValueError, match="integer factor"):
            upsample_nearest(x, hw)
