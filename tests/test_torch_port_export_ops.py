"""The pieces of the predict export that need no export: the registered
ops, the traced NMS loop, the port's synthetic batch and the bf16 scale.

* `torch.library.opcheck` on every `srfdet::` op (schema, fake, dispatch)
  on CPU tensors: K1 in float32 and bfloat16, K2's eq-match and plan map
  (on strided column views too), K6's key hash and lookup; each wrapper's
  CPU route equals its plain version exactly.
* `rotated_nms_bev`, now a `while_loop`, against the JAX package's
  `lax.while_loop`: keep sets exactly equal on seeded boxes, a chain of
  boxes each suppressing the next (the fixed point's longest case, which
  stops at N sweeps in both), and all-invalid rows; the eager sweep count
  stays readable.
* `tools/export.synthetic_batch` equals `__graft_entry__._synthetic_batch`
  draw for draw.
* `models/head.round_to_bf16` equals torch's bfloat16 rounding (it
  replaced a host read in the bf16 attention scale).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import srfdet3d_tpu.configs as jconfigs
from srfdet3d_torch.configs import get_config
from srfdet3d_torch.geometry import iou as tiou
from srfdet3d_torch.models.head import round_to_bf16
from srfdet3d_torch.ops import bitmap_rulebook as tbr
from srfdet3d_torch.ops import eqmatch as teq
from srfdet3d_torch.ops import gather_conv as tgc
from srfdet3d_torch.ops import rulebook_lookup as trl
from srfdet3d_torch.tools import export as texport
from srfdet3d_tpu.geometry import iou as jiou

T = torch.from_numpy
_j_nms = jax.jit(jiou.rotated_nms_bev, static_argnums=2)


def _conv_case(rng, dtype):
    n, m, k, cin, cout = 40, 24, 27, 8, 12
    feats = torch.from_numpy(rng.normal(size=(n, cin)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, n + 1, (m, k)).astype(np.int32))
    w = torch.from_numpy(rng.normal(size=(k, cin, cout)).astype(np.float32))
    return feats.to(dtype), idx, w.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_conv_op(dtype):
    feats, idx, w = _conv_case(np.random.default_rng(0), dtype)
    torch.library.opcheck(tgc.gather_conv_op, (feats, idx, w))
    got = tgc.gather_conv(feats, idx, w)
    assert got.dtype == dtype
    assert torch.equal(got, tgc.gather_conv_plain(feats, idx, w))


def _columns(seed, strided: bool):
    """A B = 2 ColumnSet of plan-major voxels on a (6, 10, 12) grid; with
    `strided` its arrays are views into wider (B, 2P) tensors."""
    rng = np.random.default_rng(seed)
    b, v, shape = 2, 48, (6, 10, 12)
    d, h, w = shape
    coords = np.zeros((b, v, 3), np.int64)
    mask = np.zeros((b, v), bool)
    for s in range(b):
        c = rng.choice(d * h * w, 40 - 6 * s, replace=False)
        z, yx = c // (h * w), c % (h * w)
        o = np.argsort(yx * d + z)
        coords[s, :len(o)] = np.stack([z[o], yx[o] // w, yx[o] % w], -1)
        mask[s, :len(o)] = True
    cs, _, _ = tbr.build_columns(T(coords), T(mask), shape)
    if strided:
        def widen(t):
            wide = torch.zeros((b, 2 * t.shape[1]) + tuple(t.shape[2:]),
                               dtype=t.dtype)
            wide[:, :t.shape[1]] = t
            return wide[:, :t.shape[1]]
        cs = tbr.ColumnSet(widen(cs.ccoords), widen(cs.cmask),
                           widen(cs.cstart), widen(cs.bits), cs.shape,
                           cs.row_cap)
        assert cs.cmask.stride(0) == 2 * cs.cmask.shape[1]
    return cs, T(coords), T(mask)


@pytest.mark.parametrize("strided", [False, True])
def test_eqmatch_ops(strided):
    cs, coords, mask = _columns(1, strided)
    args = (cs.ccoords, cs.cmask, cs.bits, cs.cstart, coords, mask,
            list(cs.shape), cs.row_cap)
    for scale, offset in ((1, [1, 1, 1]), (2, [1, 0, 1])):
        torch.library.opcheck(teq.eqmatch_rulebook_op,
                              args + (scale, offset))
        got = teq.eqmatch_rulebook(cs, coords, mask, scale, tuple(offset))
        ref = teq.column_query_plain(cs, teq.plan_map_plain(cs), coords,
                                     mask, scale, tuple(offset))
        assert torch.equal(got, ref)
    torch.library.opcheck(teq.plan_map_op,
                          (cs.ccoords, cs.cmask, list(cs.shape)))
    assert torch.equal(teq.plan_map(cs), teq.plan_map_plain(cs))


def test_rulebook_lookup_ops():
    rng = np.random.default_rng(2)
    n, sentinel = 300, 5000
    keys = np.sort(rng.integers(0, sentinel, n))
    keys[-20:] = sentinel                      # padding keys, one run
    rows = rng.permutation(n).astype(np.int32)
    queries = rng.integers(-3, sentinel + 3, (64, 27))
    queries[:8] = keys[:8 * 27].reshape(8, 27)
    keys, rows, queries = T(keys), T(rows), T(queries)
    log2 = trl.hash_slots_log2(n)
    torch.library.opcheck(trl.key_hash_op, (keys, rows, sentinel, log2))
    hashed = trl.key_hash(keys, rows, sentinel)
    assert hashed.table.shape == (1 << log2,)
    assert torch.equal(hashed.table, trl.key_hash_plain(keys, rows,
                                                        sentinel, log2))
    # each distinct valid key sits once, with its first row
    words = hashed.table[hashed.table != -1]
    first = {}
    for k, r in zip(keys.tolist(), rows.tolist()):
        if 0 <= k < sentinel:
            first.setdefault(k, r)
    assert sorted((words >> trl.ROW_BITS).tolist()) == sorted(first)
    assert all(first[w >> trl.ROW_BITS] == w & ((1 << trl.ROW_BITS) - 1)
               for w in words.tolist())
    torch.library.opcheck(trl.rulebook_lookup_op,
                          (keys, rows, queries, hashed.table, sentinel))
    got = trl.rulebook_lookup(keys, rows, queries, sentinel, hashed)
    assert torch.equal(got, trl.rulebook_lookup_plain(keys, rows, queries,
                                                      sentinel))


def _chain(n, start=0.0):
    """n 2 x 2 boxes along x, 1 m apart: each overlaps the next at IoU 1/3
    and touches none further."""
    boxes = np.zeros((n, 5), np.float32)
    boxes[:, 0] = start + np.arange(n)
    boxes[:, 2:4] = 2.0
    return boxes


def _nms_cases():
    rng = np.random.default_rng(5)
    b, c, n = 2, 3, 40
    boxes = np.zeros((b, c, n, 5), np.float32)
    boxes[..., :2] = rng.uniform(-6, 6, (b, c, n, 2))
    boxes[..., 2:4] = rng.uniform(0.8, 4.0, (b, c, n, 2))
    boxes[..., 4] = rng.uniform(-np.pi, np.pi, (b, c, n))
    scores = rng.uniform(0, 1, (b, c, n)).astype(np.float32)
    scores[0, 0, :6] = 0.5                      # ties
    valid = rng.uniform(size=(b, c, n)) > 0.2
    valid[1, 2] = False                         # an all-invalid row
    yield "random", boxes, scores, valid, 0.3
    # a chain of N boxes, scores falling along it: each sweep settles one
    # more box, so the loop runs into its cap of N sweeps
    n = 12
    chain = np.stack([_chain(n), _chain(n, 30.0)])[:, None]
    falling = np.tile(np.linspace(1, 0.1, n, dtype=np.float32), (2, 1, 1))
    valid = np.ones((2, 1, n), bool)
    valid[1] = False
    yield "chain", chain, falling, valid, 0.2
    # the chain again, shuffled and one link invalid
    perm = rng.permutation(n)
    valid = np.ones((1, n), bool)
    valid[0, perm.tolist().index(5)] = False
    yield "chain_cut", _chain(n)[perm][None], falling[0, 0][perm][None], \
        valid, 0.2


@pytest.mark.parametrize("case", [c[0] for c in _nms_cases()])
def test_rotated_nms_keep_sets_match_jax(case):
    _, boxes, scores, valid, thr = next(c for c in _nms_cases()
                                        if c[0] == case)
    ref = np.asarray(_j_nms(jnp.asarray(boxes), jnp.asarray(scores), thr,
                            jnp.asarray(valid)))
    got = tiou.rotated_nms_bev(T(boxes), T(scores), thr, T(valid))
    np.testing.assert_array_equal(got.numpy(), ref)
    n = boxes.shape[-2]
    if case == "chain":
        assert tiou.last_nms_sweeps == n        # the cap
        # greedy NMS keeps every other box of the chain
        assert got[0, 0].tolist() == [i % 2 == 0 for i in range(n)]
    assert not got[~T(valid)].any()


def test_nms_loop_leaves_the_count_while_tracing():
    boxes = T(np.stack([_chain(6)]))
    scores = torch.linspace(1, 0.1, 6)[None]

    class Nms(torch.nn.Module):
        def forward(self, boxes, scores):
            return tiou.rotated_nms_bev(boxes, scores, 0.2)

    want = tiou.rotated_nms_bev(boxes, scores, 0.2)
    tiou.last_nms_sweeps = -1
    prog = torch.export.export(Nms(), (boxes, scores), strict=False)
    assert tiou.last_nms_sweeps == -1
    targets = {str(n.target) for n in prog.graph.nodes
               if n.op == "call_function"}
    assert "while_loop" in targets
    assert "aten._local_scalar_dense.default" not in targets
    assert torch.equal(prog.module()(boxes, scores), want)


@pytest.mark.parametrize("name", ["tiny", "tiny_kitti", "tiny_pillar",
                                  "srfdet_voxel_nusc_L"])
def test_synthetic_batch_matches_graft(name):
    jname = {"tiny": "tiny_test_config", "tiny_kitti":
             "tiny_kitti_test_config", "tiny_pillar":
             "tiny_pillar_test_config"}.get(name, name)
    jcfg = getattr(jconfigs, jname)()
    cfg = get_config(name)
    for with_gt, b, seed in ((False, 1, 0), (True, 2, 3)):
        want = graft._synthetic_batch(jcfg, b, with_gt=with_gt, seed=seed)
        got = texport.synthetic_batch(cfg, b, with_gt=with_gt, seed=seed)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]), err_msg=k)


def test_round_to_bf16_matches_torch():
    for dh in range(1, 1025):
        v = math.sqrt(dh)
        assert round_to_bf16(v) == torch.tensor(
            v, dtype=torch.bfloat16).item()
    for v in (1e-8, 0.1, 3.0e38, 12345.678):
        assert round_to_bf16(v) == torch.tensor(
            v, dtype=torch.bfloat16).item()
