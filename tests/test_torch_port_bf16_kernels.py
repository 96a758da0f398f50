"""PyTorch port vs JAX package: the sparse-conv gather-GEMM and its
backward in bfloat16 (the bf16 model's K1, K3 and K4 routes).

The plain versions compute float32 sums of the bf16 values and round once,
as the JAX package's XLA path does (`preferred_element_type=float32`, then
`.astype`): against it they are held at one bf16 ulp (relative 2^-7, plus
an atol of 2^-7 of 2^-7 of the largest output for float32 sums in another
order near zero).  Against the Pallas kernels in interpret mode, whose
windows and bf16 intermediates round elsewhere, they are held at the JAX
package's own bounds (`tests/test_pallas_onehot.py::test_bf16`,
`tests/test_pallas_onehot_bwd.py::test_bwd_matches_autodiff_bf16`).  The
JAX backward rules are called as the custom VJPs call them on the CPU
(`_onehot_conv_bwd`, `_onehot_conv_subm_bwd`: the XLA formulas).

Measured with these seeds: K4's TPU kernel rounds each offset's product to
bf16 before its scatter (`pallas_onehot_bwd.py:98`), the XLA path does
not; the port's plain dfeats (and the card kernel, which has no such step)
sit at most 1 bf16 ulp from the XLA path, and the interpret-mode kernel's
dfeats differ from the XLA path's by up to `KERNEL_VS_XLA_DFEATS` of their
largest value."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srfdet3d_tpu.ops import sparse_conv as jsc
from srfdet3d_tpu.ops.pallas_onehot import gather_matmul_onehot
from srfdet3d_tpu.ops.pallas_onehot_bwd import gather_matmul_onehot_bwd
from srfdet3d_torch.models.layers import set_dtype
from srfdet3d_torch.models.sparse_encoder import GatheredConvBN
from srfdet3d_torch.ops import gather_conv_bwd as gcb
from srfdet3d_torch.ops.gather_conv import gather_conv, gather_conv_plain
from tests.test_pallas_onehot import _near_monotone_idx, _pack, _xla_ref
from tests.test_pallas_onehot_bwd import _subm_idx

BF = torch.bfloat16
ULP = 2.0 ** -7
# the interpret-mode K4 kernel's dfeats against the XLA path's, over the
# largest |dfeats| (its bf16 ystack rounding; measured 2.4e-3, seed 11)
KERNEL_VS_XLA_DFEATS = 3e-3


def _t(x):
    """jax / numpy array -> torch tensor, bf16 kept."""
    a = np.array(jnp.asarray(x).astype(jnp.float32))
    t = torch.from_numpy(a)
    return t.to(BF) if jnp.asarray(x).dtype == jnp.bfloat16 else t


def _within_ulp(got: torch.Tensor, ref) -> None:
    ref = torch.from_numpy(np.array(jnp.asarray(ref).astype(jnp.float32)))
    got = got.float()
    tol = ULP * ref.abs() + ULP * ULP * float(ref.abs().max())
    bad = (got - ref).abs() > tol
    assert not bool(bad.any()), float((got - ref).abs().max())


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the shapes are small, and the suite runs
    several test processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cin,cout", [(32, 64), (5, 16)])
def test_k1_plain_bf16_matches_xla_and_interpret(cin, cout):
    """test_pallas_onehot.py::test_bf16's shape, and the flagship's
    conv_input width (Cin 5): the plain version within one bf16 ulp of
    the XLA path, and at JAX's own bounds of the Pallas kernel."""
    rng = np.random.default_rng(2)
    n, m, k = 2048, 512, 27
    feats = jnp.asarray(rng.normal(size=(n, cin))).astype(jnp.bfloat16)
    w = jnp.asarray(rng.normal(size=(k, cin, cout)).astype(np.float32))
    idx = _near_monotone_idx(rng, m, k, n)
    w16 = w.astype(jnp.bfloat16)
    got = gather_conv_plain(_t(feats), _t(idx), _t(w16))
    assert got.dtype == BF
    _within_ulp(got, _xla_ref(feats, idx, w16))
    kern = gather_matmul_onehot(feats, idx, w, tm=256,
                                wp=max(16, 1024 // _pack(cin)),
                                interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(kern, np.float32),
                               rtol=2e-2, atol=1.0)
    # the wrapper's CPU route is the plain version
    assert torch.equal(gather_conv(_t(feats), _t(idx), _t(w16)), got)


def test_wrappers_refuse_mixed_dtypes():
    feats = torch.zeros(4, 8, dtype=BF)
    idx = torch.zeros(2, 3, dtype=torch.int32)
    w = torch.zeros(3, 8, 4)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        gather_conv(feats, idx, w)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        gather_conv(feats.double(), idx, w.double())
    g = torch.zeros(2, 4, dtype=BF)
    for bwd in (gcb.strided_conv_bwd, gcb.subm_conv_bwd):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            bwd(feats, idx, w, g)


def _k4_case():
    """test_pallas_onehot_bwd.py::test_bwd_matches_autodiff_bf16's
    inputs."""
    rng = np.random.default_rng(11)
    n, cin, cout, m, k = 400, 16, 32, 512, 27
    feats = jnp.asarray(
        rng.normal(size=(n, cin)).astype(np.float32)).astype(jnp.bfloat16)
    idx = _near_monotone_idx(rng, m, k, n)
    w = jnp.asarray(rng.normal(size=(k, cin, cout)).astype(np.float32) * 0.1
                    ).astype(jnp.bfloat16)
    g = jnp.asarray(rng.normal(size=(m, cout)).astype(np.float32)
                    ).astype(jnp.bfloat16)
    return feats, idx, w, g


def test_k4_plain_bf16_matches_xla_vjp_and_interpret():
    """K4's plain version in bf16 (the strided backward's CPU route):
    within one bf16 ulp of `_onehot_conv`'s backward (float32 sums,
    rounded once), bf16 dfeats and dW; at JAX's bounds of the Pallas
    kernel, whose dfeats round each offset's product to bf16 first."""
    feats, idx, w, g = _k4_case()
    dfe, dw = gcb.strided_conv_bwd(_t(feats), _t(idx), _t(w), _t(g))
    assert dfe.dtype == BF and dw.dtype == BF
    ref_dfe, _, ref_dw = jsc._onehot_conv_bwd((feats, idx, w), g)
    assert ref_dfe.dtype == jnp.bfloat16
    _within_ulp(dfe, ref_dfe)
    _within_ulp(dw, ref_dw)
    k_dfe, k_dw = gather_matmul_onehot_bwd(feats, idx, w, g, tm=128, wp=64,
                                           interpret=True)
    for got, ref in ((dfe, k_dfe), (dw, k_dw)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(ref, np.float32),
                                   rtol=2e-2, atol=1e-1)
    # the TPU kernel's ystack rounding, against the XLA path
    ref = np.asarray(ref_dfe, np.float32)
    diff = np.abs(np.asarray(k_dfe, np.float32) - ref).max()
    assert diff <= KERNEL_VS_XLA_DFEATS * np.abs(ref).max()


def test_k3_route_bf16_matches_xla_vjp():
    """K3 in bf16 runs the float32 backward on upcast inputs (JAX
    `pallas_onehot_bwd.py:428`) and rounds dfeats and dW once: within one
    bf16 ulp of `_onehot_conv_subm`'s backward on a symmetric rulebook."""
    rng = np.random.default_rng(11)
    idx = _subm_idx(rng, (6, 12, 12), 400, 512)
    cin, cout = 16, 16
    feats = jnp.asarray(rng.normal(size=(512, cin))).astype(jnp.bfloat16)
    w = jnp.asarray(rng.normal(size=(27, cin, cout)) * 0.1
                    ).astype(jnp.bfloat16)
    g = jnp.asarray(rng.normal(size=(512, cout))).astype(jnp.bfloat16)
    ref_dfe, _, ref_dw = jsc._onehot_conv_subm_bwd((feats, idx, w), g)
    dfe, dw = gcb.subm_conv_bwd(_t(feats), _t(idx), _t(w), _t(g))
    assert dfe.dtype == BF and dw.dtype == BF
    _within_ulp(dfe, ref_dfe)
    _within_ulp(dw, ref_dw)


@pytest.mark.parametrize("subm", [True, False])
def test_bf16_conv_grads_reach_f32_kernel_rounded(subm):
    """A GatheredConvBN in bf16: bf16 output, and its float32 kernel's
    grad is float32 holding bf16 values (dW rounded to bf16 before the
    cast's backward, as JAX's `dw.astype(weights.dtype)`), equal to the
    backward route's dW."""
    feats, idx, w, g = _k4_case()
    if subm:
        rng = np.random.default_rng(3)
        idx = _subm_idx(rng, (6, 12, 12), 300, 400)
    conv = GatheredConvBN(16, 32, 27, relu=False, subm=subm)
    set_dtype(conv, BF)
    with torch.no_grad():
        conv.kernel.copy_(_t(w).float())
    f = _t(feats)[None].requires_grad_(True)
    mask = torch.ones(1, idx.shape[0], dtype=torch.bool)
    conv.eval()
    out = conv(f, _t(idx)[None], mask)
    assert out.dtype == BF and conv.kernel.dtype == torch.float32
    cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    out.backward(cot.to(BF))
    kg = conv.kernel.grad
    assert kg.dtype == torch.float32 and f.grad.dtype == BF
    assert torch.equal(kg, kg.to(BF).float())
    # the cotangent the BN passes back, in its own op order
    bn = conv.bn
    y = ((cot.to(BF).float() * bn.weight) *
         torch.rsqrt(bn.running_var + bn.eps)).to(BF)
    bwd = gcb.subm_conv_bwd if subm else gcb.strided_conv_bwd
    _, dw = bwd(_t(feats), _t(idx), _t(w), y[0].contiguous())
    assert torch.equal(kg, dw.float())
