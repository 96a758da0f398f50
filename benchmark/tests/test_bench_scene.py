"""The traffic generator (scene.py): seeded, in range, GT around its
points, and denser neighbourhoods than the uniform synthetic scene."""

from __future__ import annotations

import json

import pytest
import torch

from benchmark import scene
from benchmark.registry import Registry

REG = Registry()


def _doc_and_scene(traffic="lidar_stream"):
    cell = next(w for w in REG.spec["workloads"] if w["traffic"] == traffic)
    return REG.config(cell), REG.traffic(cell)["scene"]


def _sample(seed, p=None, doc=None):
    d, s = _doc_and_scene()
    g = torch.Generator().manual_seed(scene.derived_seed(seed))
    return scene.make_sample(p or s, doc or d, g, "cpu")


def test_same_seed_same_frames():
    a, b = _sample(11), _sample(11)
    for k in ("points", "points_mask", "gt_boxes", "gt_labels", "gt_mask"):
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["points"], _sample(12)["points"])


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_points_in_range_and_cap(seed):
    doc, _ = _doc_and_scene()
    s = _sample(seed)
    pts, mask = s["points"], s["points_mask"]
    assert pts.shape == (doc["points_cap"], doc["points_dim"])
    live = pts[mask]
    pc = doc["pc_range"]
    for d in range(3):
        assert bool((live[:, d] >= pc[d]).all())
        assert bool((live[:, d] <= pc[d + 3]).all())
    assert int(mask.sum()) == min(s["returns"], doc["points_cap"])
    assert bool((pts[~mask] == 0).all())
    # the time lag channel: 0 to (sweeps - 1) * interval
    assert float(live[:, 4].min()) >= 0.0
    assert float(live[:, 4].max()) <= 0.45 + 1e-6


@pytest.mark.parametrize("seed", [4, 5])
def test_boxes_hold_the_points_of_their_faces(seed):
    s = _sample(seed)
    hit = s["hit"]
    boxes = s["gt_boxes"][s["gt_mask"]]
    pts = s["points"][hit >= 0]
    which = hit[hit >= 0]
    assert len(which) > 0
    b = boxes[which]
    c, sn = torch.cos(b[:, 6]), torch.sin(b[:, 6])
    dx, dy = pts[:, 0] - b[:, 0], pts[:, 1] - b[:, 1]
    local = torch.stack([dx * c - dy * sn, dx * sn + dy * c,
                         pts[:, 2] - b[:, 2]], 1)
    # range noise is 2 cm (sigma): 12 cm is six sigma
    assert bool((local.abs() <= b[:, 3:6] / 2 + 0.12).all())


def _subm_hits_per_site(points, mask, doc):
    """Mean neighbours a voxel finds among its 27 taps at stage 0."""
    from benchmark import port
    from benchmark.reference import config as rconfig
    from benchmark.reference.models.sparse_encoder import BitmapRulebooks
    from benchmark.reference.ops.voxelize import voxelize_points_batched
    cfg = port.build_config(rconfig, doc)
    vox = voxelize_points_batched(points[None], mask[None], cfg.voxelization)
    rb = BitmapRulebooks(vox.voxel_coords, vox.voxel_mask,
                         cfg.voxelization.sparse_shape)
    idx = rb.subm()
    n = vox.voxel_mask.numel()
    live = vox.voxel_mask.reshape(-1)
    hits = (idx.reshape(n, 27) < n)[live].sum(1).float()
    return float(hits.mean())


def test_denser_neighbourhoods_than_the_uniform_scene():
    """At a grid cut to 1/4 of the flagship's extent (same voxel size),
    a sensor-like frame's voxels find more neighbours than the uniform
    synthetic scene's (which finds almost only itself)."""
    doc, p = _doc_and_scene()
    doc = json.loads(json.dumps(doc))
    doc.update(pc_range=[-13.8, -13.8, -5.0, 13.8, 13.8, 3.0],
               points_cap=32768, voxels_cap=30000)
    p = dict(p, azimuth_steps=600, object_area=25.0, wall_distance=[8, 13])
    s = _sample(6, p, doc)
    ours = _subm_hits_per_site(s["points"], s["points_mask"], doc)
    from srfdet3d_torch.tools.export import synthetic_batch
    from benchmark import port
    u = synthetic_batch(port.config(doc), 1, seed=6)
    uniform = _subm_hits_per_site(u["points"][0], u["points_mask"][0], doc)
    assert ours > 3 * uniform, (ours, uniform)
