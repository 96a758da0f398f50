"""PyTorch port vs JAX package: the bf16 gather-GEMM (K1-bf16) and the
strided backward (K4-bf16) at every shape class their card kernels
dispatch on, a model of the card kernel's step schedule, and the bf16 op's
export.

The card kernels (`srfdet3d_torch/csrc/gather_gemm_sm90.cuh`,
`csrc/gather_conv_bwd.cu`) choose by Cin the channels of an item (16, 32
or 64: four, two or one offsets a 64-deep step, two steps an offset at Cin
128, rows not 16-byte aligned at Cin 5), by the output width a column tile
(16, 32, 64 or 128), skip the offsets that miss every row of a 128-row
tile, and read W (K, Cin, Cout) in place.  On the CPU the wrappers run the
plain versions; these tests hold them against the JAX package at each
class: Cin 5, 8, 16, 24, 32, 64 and 128, Cout 8 to 128, K 3, 9 and 27, M
not a multiple of the tile, a tile whose rows all miss and an offset that
misses every row; for the backward, the strided rulebook with a 1024-row
dW chunk that no output row reads.

One compiled JAX program a kind: each case is embedded, zero-padded, in
one fixed shape (Cin = Cout = 128, K = 27; a zero channel or a missed
offset adds exact zeros), so the XLA references and the Pallas kernel in
interpret mode compile once a file.  Tolerances: against the XLA path,
which sums the exact bf16 products in float32 and rounds once as the plain
versions do, one bf16 ulp (2^-7 relative) plus 2^-14 of the largest output
for float32 sums in another order near zero (chip_smoke.py's BF16_RTOL and
BF16_ATOL_REL, which hold the card kernels to the plain versions); against
the Pallas kernel, whose windows round elsewhere, JAX's own bounds
(`tests/test_pallas_onehot.py::test_bf16`: rtol 2e-2, atol 1.0)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srfdet3d_tpu.ops import sparse_conv as jsc
from srfdet3d_tpu.ops.pallas_onehot import gather_matmul_onehot
from srfdet3d_torch.ops import gather_conv_bwd as gcb
from srfdet3d_torch.ops.gather_conv import gather_conv, gather_conv_plain
from tests.test_pallas_onehot import _xla_ref

BF = torch.bfloat16
RTOL, ATOL_REL = 2.0 ** -7, 2.0 ** -14
# the padded shape every case is embedded in
C_PAD, K_PAD = 128, 27
N_FWD, M_FWD = 512, 300
N_BWD, M_BWD = 2300, 400
# the card kernel's tile rows (sm90::GatherCfg::BM) and step depth
BM, STEP_K = 128, 64

# (Cin, Cout, K): conv_input (Cin 5), the flagship's stages and downs,
# conv_out (K 3), the tiny configs' 8 channels (column tile 16), and widths
# that are no power of two
FWD_CASES = [(5, 16, 27), (8, 8, 27), (16, 16, 27), (16, 32, 27),
             (32, 32, 27), (32, 64, 27), (64, 64, 27), (64, 128, 27),
             (128, 128, 27), (128, 128, 3), (24, 40, 9)]
BWD_CASES = [(16, 32, 27), (32, 64, 27), (64, 128, 27), (128, 128, 3),
             (8, 16, 27), (24, 40, 9)]


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(rng, shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32).astype(
        jnp.bfloat16)


def _t(x):
    """numpy / jax array -> torch tensor, bf16 kept."""
    a = np.asarray(jnp.asarray(x).astype(jnp.float32))
    t = torch.from_numpy(np.array(a))
    return t.to(BF) if jnp.asarray(x).dtype == jnp.bfloat16 else t


def _pad(x, shape):
    out = np.zeros(shape, np.float32)
    out[tuple(slice(0, s) for s in x.shape)] = np.asarray(x, np.float32)
    return out.astype(jnp.bfloat16)


def _within_ulp(got: torch.Tensor, ref: np.ndarray) -> None:
    ref = torch.from_numpy(np.asarray(ref, np.float32))
    got = got.float()
    tol = RTOL * ref.abs() + ATOL_REL * float(ref.abs().max())
    err = (got - ref).abs()
    assert bool((err <= tol).all()), float(err.max())


def _fwd_case(cin, cout, k):
    """A forward rulebook over N_FWD rows: per-offset monotone with a
    spread, 15% misses, the second 128-row tile all misses, offset 1 a miss
    for every row."""
    rng = np.random.default_rng(cin * 1000 + cout * 10 + k)
    base = np.sort(rng.integers(0, N_FWD, size=M_FWD))
    idx = np.clip(base[:, None] + rng.integers(-64, 65, size=(M_FWD, k)),
                  0, N_FWD - 1).astype(np.int32)
    idx[rng.random((M_FWD, k)) < 0.15] = N_FWD
    idx[BM:2 * BM] = N_FWD
    idx[:, 1] = N_FWD
    feats = _bf16(rng, (N_FWD, cin))
    w = _bf16(rng, (k, cin, cout), 1.0 / np.sqrt(k * cin))
    return feats, idx, w


@functools.lru_cache(maxsize=None)
def _fwd_refs():
    """The XLA path and the Pallas kernel in interpret mode, each jitted
    once at the padded shape."""
    xla = jax.jit(_xla_ref)
    kern = jax.jit(lambda f, i, w: gather_matmul_onehot(
        f, i, w.astype(jnp.float32), tm=128, wp=256, interpret=True))
    return xla, kern


def _embed_fwd(feats, idx, w):
    k = idx.shape[1]
    idx_p = np.full((M_FWD, K_PAD), N_FWD, np.int32)
    idx_p[:, :k] = idx
    return (_pad(feats, (N_FWD, C_PAD)), jnp.asarray(idx_p),
            _pad(w, (K_PAD, C_PAD, C_PAD)))


@pytest.mark.parametrize("cin,cout,k", FWD_CASES)
def test_k1_bf16_plain_matches_jax_at_tile_class(cin, cout, k):
    """The bf16 forward's CPU route (the plain version) within one bf16
    ulp of the XLA path and at JAX's bounds of the Pallas kernel; the
    all-miss tile's rows are zeros."""
    feats, idx, w = _fwd_case(cin, cout, k)
    got = gather_conv(_t(feats), torch.from_numpy(idx), _t(w))
    assert got.dtype == BF and tuple(got.shape) == (M_FWD, cout)
    xla, kern = _fwd_refs()
    args = _embed_fwd(feats, idx, w)
    ref = np.asarray(xla(*args), np.float32)[:, :cout]
    _within_ulp(got, ref)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(kern(*args), np.float32)[:, :cout],
        rtol=2e-2, atol=1.0)
    assert not bool(got[BM:2 * BM].float().any())


def _schedule_model(feats, idx, w, bm=BM, step_k=STEP_K):
    """The card kernel's arithmetic, step by step, in float32 (the
    products of bf16 values are exact): tiles of bm rows, the offsets that
    hit some row of the tile in order, items of cw channels (cw = Cin's
    power of two, 16 to step_k) taken step_k // cw a step; A a step's
    gathered row chunks (zeros for a miss or a channel past Cin), B the
    matching rows of W[j] (zeros past Cin).  Returns (out rounded to bf16
    once, steps a tile)."""
    n, cin = feats.shape
    m, k = idx.shape
    cw = 16
    while cw < cin and cw < step_k:
        cw *= 2
    chunks = -(-cin // cw)
    per_step = step_k // cw
    table = torch.cat([feats.float(), torch.zeros(1, cin)])
    out = torch.zeros(m, w.shape[2])
    steps = []
    for m0 in range(0, m, bm):
        rows = idx[m0:m0 + bm].long()
        hit = [j for j in range(k) if bool((rows[:, j] < n).any())]
        items = [(j, c * cw) for j in hit for c in range(chunks)]
        steps.append(-(-len(items) // per_step))
        for s in range(0, len(items), per_step):
            a_parts, b_parts = [], []
            for j, c in items[s:s + per_step]:
                a = torch.zeros(len(rows), cw)
                b = torch.zeros(cw, w.shape[2])
                width = min(cw, cin - c)
                a[:, :width] = table[rows[:, j], c:c + width]
                b[:width] = w[j, c:c + width].float()
                a_parts.append(a)
                b_parts.append(b)
            out[m0:m0 + bm] += torch.cat(a_parts, 1) @ torch.cat(b_parts)
    return out.to(feats.dtype), steps


@pytest.mark.parametrize("cin,cout,k", [(5, 16, 27), (16, 32, 27),
                                        (32, 64, 27), (128, 128, 27),
                                        (128, 128, 3), (24, 40, 9)])
def test_kernel_step_schedule_model(cin, cout, k):
    """The card kernel's step schedule (offsets a step at Cin 16-32, two
    steps an offset at Cin 128, whole-tile misses skipped) sums the same
    products as the plain version: within one bf16 ulp, and the steps a
    tile are ceil(hit offsets x chunks / offsets a step)."""
    feats, idx, w = _fwd_case(cin, cout, k)
    f, i, wt = _t(feats), torch.from_numpy(idx), _t(w)
    got, steps = _schedule_model(f, i, wt)
    ref = gather_conv_plain(f, i, wt)
    _within_ulp(got, ref.float().numpy())
    cw = {5: 16, 16: 16, 24: 32, 32: 32}.get(cin, 64)
    per_step, chunks = STEP_K // cw, -(-cin // cw)
    for t, s in enumerate(steps):
        rows = i[t * BM:(t + 1) * BM]
        hits = int((rows < N_FWD).any(0).sum())
        assert s == -(-hits * chunks // per_step)
    assert steps[1] == 0            # the all-miss tile runs no step
    assert max(steps) <= -(-(k - 1) * chunks // per_step)  # offset 1 skipped


def _bwd_case(cin, cout, k):
    """A strided rulebook (M_BWD, k) over N_BWD input rows: each (row,
    offset) read at most once, rows 1024..2047 (the second dW chunk) never
    read, 40% misses."""
    rng = np.random.default_rng(cin * 100 + cout + k)
    pool = np.concatenate([np.arange(0, 1024), np.arange(2048, N_BWD)])
    idx = np.stack([np.sort(rng.choice(pool, M_BWD, replace=False))
                    for _ in range(k)], 1).astype(np.int32)
    idx[rng.random((M_BWD, k)) < 0.4] = N_BWD
    feats = _bf16(rng, (N_BWD, cin))
    w = _bf16(rng, (k, cin, cout), 1.0 / np.sqrt(k * cin))
    g = _bf16(rng, (M_BWD, cout))
    return feats, idx, w, g


@functools.lru_cache(maxsize=None)
def _bwd_ref():
    """`_onehot_conv`'s backward (the XLA formulas), jitted once at the
    padded shape: (dfeats, dW)."""
    def ref(f, i, w, g):
        dfe, _, dw = jsc._onehot_conv_bwd((f, i, w), g)
        return dfe, dw
    return jax.jit(ref)


@pytest.mark.parametrize("cin,cout,k", BWD_CASES)
def test_k4_bf16_plain_matches_jax_with_empty_chunk(cin, cout, k):
    """The bf16 strided backward's CPU route within one bf16 ulp of JAX's
    backward, dfeats and dW, on a rulebook with a dW chunk no output row
    reads (its input rows get zero dfeats)."""
    feats, idx, w, g = _bwd_case(cin, cout, k)
    dfe, dw = gcb.strided_conv_bwd(_t(feats), torch.from_numpy(idx), _t(w),
                                   _t(g))
    assert dfe.dtype == BF and dw.dtype == BF
    assert tuple(dw.shape) == (k, cin, cout)
    idx_p = np.full((M_BWD, K_PAD), N_BWD, np.int32)
    idx_p[:, :k] = idx
    ref_dfe, ref_dw = _bwd_ref()(
        _pad(feats, (N_BWD, C_PAD)), jnp.asarray(idx_p),
        _pad(w, (K_PAD, C_PAD, C_PAD)), _pad(g, (M_BWD, C_PAD)))
    _within_ulp(dfe, np.asarray(ref_dfe, np.float32)[:, :cin])
    _within_ulp(dw, np.asarray(ref_dw, np.float32)[:k, :cin, :cout])
    assert not bool(dfe[1024:2048].float().any())


def test_bf16_gather_conv_exports_as_one_node():
    """torch.export of a bf16 gather_conv: one `srfdet::gather_conv` node,
    W taken as it is, (K, Cin, Cout), by the node (no transpose or pad
    before it), a bf16 (M, Cout) output equal to the plain version's."""
    feats, idx, w = _fwd_case(16, 32, 27)
    args = (_t(feats), torch.from_numpy(idx), _t(w))

    class Conv(torch.nn.Module):
        def forward(self, f, i, wt):
            return gather_conv(f, i, wt)
    ep = torch.export.export(Conv(), args)
    calls = [nd for nd in ep.graph.nodes if nd.op == "call_function"]
    assert [str(nd.target) for nd in calls] == ["srfdet.gather_conv.default"]
    node = calls[0]
    assert node.args[2].op == "placeholder"
    assert tuple(node.args[2].meta["val"].shape) == (27, 16, 32)
    val = node.meta["val"]
    assert val.dtype == BF and tuple(val.shape) == (M_FWD, 32)
    assert torch.equal(ep.module()(*args), gather_conv_plain(*args))
