"""What a traffic mix's frames ask of the sparse encoder, beside the
uniform synthetic scene of the system's own bench script
(`tools/export.synthetic_batch`: half of points_cap uniform in pc_range):
returns a frame, points kept, the share over the cap, voxels, and the
mean rulebook hits a site at each subm stage (of 27 taps), by the
reference's plain rulebooks.  Counts only; runs on the CPU.

    python3 benchmark/scene_stats.py --workload <name> --seeds 1 2 3
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def encoder_hits(points, mask, cfg):
    """(voxels, [mean hits a site at each subm stage]) of one frame."""
    from benchmark.reference.models.sparse_encoder import (
        BitmapRulebooks, down_pads)
    from benchmark.reference.ops.voxelize import voxelize_points_batched
    m = cfg.middle
    vox = voxelize_points_batched(points[None], mask[None],
                                  cfg.voxelization)
    rb = BitmapRulebooks(vox.voxel_coords, vox.voxel_mask,
                         cfg.voxelization.sparse_shape)
    hits = []

    def stage():
        idx = rb.subm()
        n = rb.mask.numel()
        live = rb.mask.reshape(-1)
        hits.append(float((idx.reshape(n, 27) < n)[live].sum(1).float()
                          .mean()))
    stage()
    pads = down_pads(m.block_type, m.encoder_channels, m.encoder_paddings)
    for level, pad in enumerate(pads):
        rb.downsample(pad, m.capacities[level])
        stage()
    return int(vox.voxel_mask.sum()), hits


def main(argv=None) -> int:
    import torch

    from benchmark import port, scene
    from benchmark.reference import config as rconfig
    from benchmark.registry import Registry
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    reg = Registry(ROOT)
    cell = reg.cell(args.workload)
    doc, traffic = reg.config(cell), reg.traffic(cell)
    cfg = port.build_config(rconfig, doc)
    n = traffic["pool"] * traffic["batch"]
    for seed in args.seeds:
        for k in range(n):
            g = torch.Generator().manual_seed(scene.derived_seed(seed, k))
            s = scene.make_sample(traffic["scene"], doc, g, "cpu", k, n)
            vox, hits = encoder_hits(s["points"], s["points_mask"], cfg)
            kept = int(s["points_mask"].sum())
            print(json.dumps({"scene": traffic["scene"].get("name", "sensor"),
                              "seed": seed, "stratum": k,
                              "returns": s["returns"], "points": kept,
                              "over_cap": 1 - kept / s["returns"],
                              "voxels": vox, "hits_per_site": hits}),
                  flush=True)
        from srfdet3d_torch.tools.export import synthetic_batch
        u = synthetic_batch(port.config(doc), 1, seed=seed)
        vox, hits = encoder_hits(u["points"][0], u["points_mask"][0], cfg)
        print(json.dumps({"scene": "uniform", "seed": seed,
                          "points": int(u["points_mask"].sum()),
                          "voxels": vox, "hits_per_site": hits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
