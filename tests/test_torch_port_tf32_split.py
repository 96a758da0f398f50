"""The 3xTF32 arithmetic of the gather-GEMM kernels (K1's forward, K3/K4's
dfeats and dW; csrc/gather_gemm.cuh), emulated in torch on the CPU.

The kernels split every operand as hi = cvt.rna.tf32(x), lo =
cvt.rna.tf32(x - hi) and accumulate lo*hi + hi*lo + hi*hi in float32 on
the tensor cores.  Here `tf32_rna` emulates the conversion (round the
float32 mantissa to 10 bits, ties away from zero) and the three products
are float32 matmuls of the split operands.  At the flagship stage-3 subm
shape (K 27, Cin = Cout = 128, ~22 of 27 offsets hit) the 3-term product
meets chip_smoke.py's tolerance against the float64 product,
`1e-5 * |ref| + 1e-5 * sqrt(terms summed)`, for the forward and for a dW
reduction over 4,096 rows, while a single TF32 product (hi*hi) does not:
the reason the kernels never use plain TF32.  A model of the tensor core's
truncating f32 sum shows why each 8-deep step is summed in a fresh tile.

These tests pin the model of the arithmetic, not the kernels: they call
nothing in srfdet3d_torch, so a kernel that ran one TF32 product would
still pass them.  What holds the kernels themselves is chip_smoke.py on
the card, against their plain versions at the same tolerance."""

import math

import numpy as np
import pytest
import torch

RTOL = ATOL = 1e-5  # chip_smoke.py's tolerance


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero, as PTX cvt.rna.tf32.f32 (finite inputs)."""
    bits = x.contiguous().view(torch.int32)
    sign = bits & -0x80000000
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    return (sign | mag).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def product(a: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """a @ b as the kernels compute it: 3 terms, small ones first; 1 term
    is plain TF32."""
    ah, al = split(a)
    bh, bl = split(b)
    if terms == 1:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def within(got: torch.Tensor, ref: np.ndarray, terms: int) -> bool:
    err = np.abs(got.numpy().astype(np.float64) - ref)
    return bool((err <= RTOL * np.abs(ref) + ATOL * math.sqrt(terms)).all())


def stage3_gathered(rows: int = 384, k: int = 27, c: int = 128,
                    hits: float = 22.2):
    """A stage-3 subm gather-GEMM: the (rows, K*Cin) gathered matrix (zeros
    at misses) and W (K*Cin, Cout) scaled sqrt(2 / (K * Cin)), as
    chip_smoke.py's check_gather_conv draws them."""
    rng = np.random.default_rng(3)
    n = 4 * rows
    feats = rng.standard_normal((n + 1, c)).astype(np.float32)
    feats[n] = 0.0
    idx = rng.integers(0, n, (rows, k))
    idx[rng.random((rows, k)) > hits / k] = n
    a = feats[idx].reshape(rows, k * c)
    w = (rng.standard_normal((k * c, c)) *
         math.sqrt(2.0 / (k * c))).astype(np.float32)
    return a, w


def test_tf32_rna_rounds_to_ten_bits_ties_away_from_zero():
    one = 1.0
    tie = one + 2.0 ** -11           # halfway between 1 and 1 + 2^-10
    below = tie - 2.0 ** -23
    x = torch.tensor([tie, -tie, below, -below, 1.5, 0.0, 3e-39],
                     dtype=torch.float32)
    got = tf32_rna(x).tolist()
    assert got[:6] == [one + 2.0 ** -10, -(one + 2.0 ** -10), one, -one,
                       1.5, 0.0]
    assert got[6] == pytest.approx(3e-39, rel=2.0 ** -9)  # subnormal
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(
        4096).astype(np.float32))
    hi = tf32_rna(r)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((hi - r).abs() <= r.abs() * 2.0 ** -11).all())


def test_split_is_exact_to_about_2_pow_minus_21():
    r = torch.from_numpy(np.random.default_rng(1).standard_normal(
        1 << 16).astype(np.float32))
    hi, lo = split(r)
    rest = r - hi                    # exact in float32
    assert bool(((rest.double() - (r.double() - hi.double())) == 0).all())
    err = (hi.double() + lo.double() - r.double()).abs()
    assert bool((err <= r.double().abs() * 2.0 ** -21).all())


@pytest.mark.parametrize("terms,meets", [(3, True), (1, False)])
def test_stage3_forward_product_tolerance(terms, meets):
    a, w = stage3_gathered()
    ref = a.astype(np.float64) @ w.astype(np.float64)
    got = product(torch.from_numpy(a), torch.from_numpy(w), terms)
    assert within(got, ref, a.shape[1]) is meets


@pytest.mark.parametrize("terms,meets", [(3, True), (1, False)])
def test_dw_reduction_tolerance(terms, meets):
    """dW[j] = feats^T (x) gathered g over 4,096 hit rows (Cin = Cout =
    128): the reduction dimension is the rows."""
    rng = np.random.default_rng(4)
    rows = 4096
    f = rng.standard_normal((rows, 128)).astype(np.float32)
    g = rng.standard_normal((rows, 128)).astype(np.float32)
    ref = f.T.astype(np.float64) @ g.astype(np.float64)
    got = product(torch.from_numpy(f.T.copy()), torch.from_numpy(g), terms)
    assert within(got, ref, rows) is meets


def round_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """float64 -> float32, rounded toward zero."""
    y = x.float()
    over = y.double().abs() > x.abs()
    y[over] = torch.nextafter(y[over], torch.zeros_like(y[over]))
    return y


@pytest.mark.parametrize("fresh,meets", [(False, False), (True, True)])
def test_dw_accumulation_per_k8_step(fresh, meets):
    """The tensor core's f32 sum is modelled as exact, then rounded toward
    zero at every MMA.  Over a dW reduction of 4,096 rows that truncation
    drifts a running sum of one sign past the tolerance; summing each
    8-deep step's three products into a fresh tile and adding that with a
    round-to-nearest f32 add, as mma_stage does, stays within it."""
    rng = np.random.default_rng(4)
    rows = 4096
    f = torch.from_numpy(rng.standard_normal((rows, 128)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((rows, 128)).astype(np.float32))
    ref = (f.double().t() @ g.double()).numpy()
    fh, fl = split(f)
    gh, gl = split(g)
    acc = torch.zeros(128, 128)
    for k0 in range(0, rows, 8):
        s = slice(k0, k0 + 8)
        tile = torch.zeros(128, 128) if fresh else acc
        for a, b in ((fl[s], gh[s]), (fh[s], gl[s]), (fh[s], gh[s])):
            tile = round_toward_zero(tile.double() + a.double().t() @
                                     b.double())
        acc = acc + tile if fresh else tile
    assert within(acc, ref, rows) is meets


def test_three_terms_track_float32_matmul():
    """The 3-term product is as close to float64 as a float32 matmul of
    the unsplit operands, within a small factor."""
    a, w = stage3_gathered(rows=256)
    ref = a.astype(np.float64) @ w.astype(np.float64)
    got = product(torch.from_numpy(a), torch.from_numpy(w), 3).numpy()
    f32 = torch.from_numpy(a) @ torch.from_numpy(w)
    e3 = np.abs(got - ref).max()
    e32 = np.abs(f32.numpy() - ref).max()
    assert e3 <= 4 * e32 + 1e-7
