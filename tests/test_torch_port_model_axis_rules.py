"""The model axis's pieces that need no process group: the capacity rules
with a slot offset, cut into M = 2, 3 and 4 blocks of proposals with the
exclusive prefix of the blocks' counts, against the whole run (exactly:
integer slots, the dropped sets, the pooled values and their zeros),
fallback -1 (every misfit kept, on every block) among them; the
dropout mask drawn whole and cut; `shard_proposal_axis` and
`proposal_sharding` outside a group, as the JAX package's
`tests/test_parallel_model.py::test_shard_proposal_axis_noop_outside_context`
holds them.  No JAX here: the whole run of the port's own rule is the
reference (the rules themselves are held against JAX in
test_torch_port_options_roi.py and test_torch_port_lc_head.py)."""

import numpy as np
import pytest
import torch

from srfdet3d_torch.models.head import compact_pairs, visible_mask
from srfdet3d_torch.models.layers import dropout
from srfdet3d_torch.ops.roi_align import (corner_samples,
                                          multilevel_roi_align, patch_fits)
from srfdet3d_torch.parallel import mesh

B, R = 3, 24
SHAPES = [(40, 40), (20, 20), (10, 10), (5, 5)]
STRIDES = (2, 4, 8, 16)
# (rule, window, fallback slots): some rows' misfits overflow the slots
# inside a block, so blocks straddle the fallback boundary; "patch_all"
# keeps every misfit (fallback -1) on blocks with misfits below them
RULES = {"patch": ("patch", 4, 5), "patch_all": ("patch", 4, -1),
         "xpatch": ("xpatch", 5, 4)}


def _rois(seed):
    """(B, R, 4) RoIs in the 80 x 80 stride-1 frame: small ones that fit
    a window and large ones that do not."""
    rng = np.random.default_rng(seed)
    ctr = rng.uniform(0, 80, (B, R, 2))
    size = np.where(rng.uniform(size=(B, R, 1)) < 0.5,
                    rng.uniform(1, 6, (B, R, 2)),
                    rng.uniform(10, 60, (B, R, 2)))
    return torch.from_numpy(np.concatenate([ctr - size / 2, ctr + size / 2],
                                           -1).astype(np.float32))


def _blocks(m):
    n = R // m
    return [(k * n, (k + 1) * n) for k in range(m)]


def _prefix(counts):
    """Each block's exclusive prefix of the per-row counts: (M, rows)."""
    c = torch.stack(counts)
    return torch.cumsum(c, 0) - c


@pytest.mark.parametrize("m", [2, 3, 4])
@pytest.mark.parametrize("rule", sorted(RULES))
def test_patch_fallback_blocks_equal_whole(rule, m):
    kind, size, fallback = RULES[rule]
    kw = {kind: size, f"{kind}_fallback": fallback}
    rois = _rois(1)
    feats = [torch.randn((B,) + s + (4,), generator=torch.Generator()
                         .manual_seed(2)) for s in SHAPES]
    whole = corner_samples(SHAPES, rois, STRIDES, **kw)
    pooled = multilevel_roi_align(feats, rois, STRIDES, **kw)
    drop = whole.drop.reshape(B, R)
    if fallback < 0:
        assert not drop.any()
    else:
        assert drop.any() and not drop.all()
    blocks = _blocks(m)
    mis = [(~patch_fits(SHAPES, rois[:, lo:hi].reshape(-1, 4), STRIDES,
                        size, x_only=kind == "xpatch")).reshape(B, -1)
           .sum(1) for lo, hi in blocks]
    offsets = _prefix(mis)
    straddles = past_block = 0
    for (lo, hi), off, count in zip(blocks, offsets, mis):
        seen = []

        def offset(counts, off=off, seen=seen):
            seen.append(counts.clone())
            return off
        part = corner_samples(SHAPES, rois[:, lo:hi], STRIDES, **kw,
                              offset=offset)
        if fallback < 0:
            assert seen == []       # no slot to count: no gather
        else:
            torch.testing.assert_close(seen[0], count, rtol=0, atol=0)
        assert torch.equal(part.drop.reshape(B, -1), drop[:, lo:hi])
        assert torch.equal(part.idx.reshape(B, hi - lo, -1),
                           whole.idx.reshape(B, R, -1)[:, lo:hi])
        got = multilevel_roi_align(feats, rois[:, lo:hi], STRIDES, **kw,
                                   offset=lambda c, off=off: off)
        assert torch.equal(got, pooled[:, lo:hi])
        straddles += int(((off < fallback) & (off + count > fallback))
                         .sum())
        past_block += int((off + count > hi - lo).sum())
    if fallback < 0:
        # some block's misfits run past its own length with the lower
        # blocks' ahead of them: none may drop
        assert past_block > 0
    else:
        # some block starts below the fallback and runs past it
        assert straddles > 0


@pytest.mark.parametrize("m", [2, 3, 4])
def test_compact_pairs_blocks_equal_whole(m):
    """Each block's pairs, compacted after the lower blocks' visible
    counts, take the whole run's slots (local slot + offset) with the same
    RoIs; the pairs past the cap are dropped in both, and unused local
    slots hold the off-image RoI and the block's n_p."""
    rng = np.random.default_rng(3)
    n_cam, cap, img_shape, strides = 2, 6, (64, 128), (4, 8, 16, 32)
    ctr = rng.uniform(-150, 280, (B, n_cam, R, 2))
    size = rng.uniform(4, 40, (B, n_cam, R, 2))
    cam = torch.from_numpy(np.concatenate([ctr - size / 2, ctr + size / 2],
                                          -1).astype(np.float32))
    rois_w, src_w = compact_pairs(cam, img_shape, strides, cap)
    vis = visible_mask(cam, img_shape, strides).reshape(B * n_cam, R)
    assert (vis.sum(1) > cap).any() and (vis.sum(1) < cap).any()
    blocks = _blocks(m)
    counts = [vis[:, lo:hi].sum(1) for lo, hi in blocks]
    offsets = _prefix(counts)
    kept = torch.zeros(B * n_cam, cap, dtype=torch.long)
    straddles = 0
    for (lo, hi), off, count in zip(blocks, offsets, counts):
        rois, src = compact_pairs(cam[:, :, lo:hi], img_shape, strides, cap,
                                  offset=lambda c, off=off: off)
        assert rois.shape == rois_w.shape and src.shape == src_w.shape
        for row in range(B * n_cam):
            used = src[row] < hi - lo
            n_used = int(used.sum())
            assert n_used == max(min(int(count[row]),
                                     cap - int(off[row])), 0)
            assert bool(used[:n_used].all())
            slots = torch.arange(n_used) + off[row]
            assert torch.equal(src_w[row, slots], src[row, :n_used] + lo)
            assert torch.equal(rois_w[row, slots], rois[row, :n_used])
            kept[row, slots] += 1
            assert bool((rois[row, n_used:] == -1e6).all())
            assert bool((src[row, n_used:] == hi - lo).all())
        straddles += int(((off < cap) & (off + count > cap)).sum())
    # every whole-run slot in use is some block's, once
    assert torch.equal(kept, (src_w < R).long())
    assert straddles > 0


def test_dropout_block_is_the_whole_mask_cut():
    """A block's mask is the whole draw's rows, and the generator ends
    where the whole draw leaves it."""
    x = torch.randn(2, 12, 5)
    whole_gen = torch.Generator().manual_seed(4)
    whole = dropout(x, 0.3, whole_gen)
    for lo, hi in ((0, 6), (6, 12), (4, 8)):
        gen = torch.Generator().manual_seed(4)
        got = dropout(x[:, lo:hi], 0.3, gen, (2, 12, 5), (1, lo, hi - lo))
        assert torch.equal(got, whole[:, lo:hi])
        assert torch.equal(gen.get_state(), whole_gen.get_state())


def test_shard_proposal_axis_noop_outside_context():
    """Outside proposal_sharding the helper returns its input object, and
    so does it inside for an axis the model ranks do not divide (the JAX
    package's silent skip); otherwise the rank's contiguous block."""
    x = torch.randn(2, 8, 4)
    assert mesh.sharding() is None
    assert mesh.shard_proposal_axis(x) is x
    assert mesh.gather_proposal_axis(x) is x
    assert torch.equal(mesh.proposal_offsets(torch.tensor([3, 1])),
                       torch.zeros(2, dtype=torch.long))
    grid = mesh.Mesh((mesh.DATA_AXIS, mesh.MODEL_AXIS), n_data=1, n_model=4,
                     model_index=2)
    with mesh.proposal_sharding(grid):
        assert mesh.sharding() is grid and mesh.shards(8)
        odd = torch.randn(2, 6, 4)
        assert mesh.shard_proposal_axis(odd) is odd
        assert mesh.shard_proposal_axis(x, axis=3) is x
        assert torch.equal(mesh.shard_proposal_axis(x), x[:, 4:6])
        assert torch.equal(mesh.shard_proposal_axis(x.transpose(1, 2), 2),
                           x[:, 4:6].transpose(1, 2))
    assert mesh.sharding() is None
    one = mesh.Mesh((mesh.DATA_AXIS, mesh.MODEL_AXIS), n_data=1, n_model=1)
    with mesh.proposal_sharding(one):
        assert mesh.shard_proposal_axis(x) is x and not mesh.shards(8)


def test_proposal_sharding_needs_a_model_axis():
    """A mesh without a model axis raises, as in the JAX package; a 2-D
    mesh needs a world of n_data * n_model ranks."""
    flat = mesh.Mesh((mesh.DATA_AXIS,), n_data=1)
    with pytest.raises(ValueError, match="model"):
        with mesh.proposal_sharding(flat):
            pass
    assert mesh.sharding() is None
    try:
        with pytest.raises(ValueError, match="ranks"):
            mesh.make_mesh_2d(2, 1)
        grid = mesh.make_mesh_2d(1, 1)
        assert grid.axis_names == (mesh.DATA_AXIS, mesh.MODEL_AXIS)
        assert (grid.data_index, grid.model_index, grid.n_data,
                grid.n_model) == (0, 0, 1, 1)
        assert mesh.data_group() is None and mesh.data_size() == 1
        with mesh.proposal_sharding(grid):
            assert mesh.sharding() is grid
    finally:
        mesh.shutdown()
