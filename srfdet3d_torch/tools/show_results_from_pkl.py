"""Render BEV visualizations from a dumped results pickle
(reference tools/show_results_from_pkl.py:21-52; the port's copy of the
JAX package's tool, the same arguments and files).

Usage: python -m srfdet3d_torch.tools.show_results_from_pkl results.pkl
       --out-dir vis/ [--pc-range x0 y0 z0 x1 y1 z1] [--max-frames N]
       [--config NAME --info-path PKL [--data-root DIR] [--score-thr T]
       [--save-3d]]

Needs cv2 (a host tool: the card machine has none).
"""

from __future__ import annotations

import argparse
import os
import pickle


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("pkl")
    ap.add_argument("--out-dir", default="vis")
    ap.add_argument("--pc-range", type=float, nargs=6,
                    default=[-55.2, -55.2, -5.0, 55.2, 55.2, 3.0])
    ap.add_argument("--max-frames", type=int, default=50)
    ap.add_argument("--config", default=None,
                    help="config name; with --info-path, renders through "
                    "dataset.show() (BEV + camera overlays + 3D files)")
    ap.add_argument("--info-path", default=None)
    ap.add_argument("--data-root", default="")
    ap.add_argument("--score-thr", type=float, default=0.2)
    ap.add_argument("--save-3d", action="store_true")
    args = ap.parse_args(argv)

    import numpy as _np

    with open(args.pkl, "rb") as f:
        dump = pickle.load(f)
    gts, preds = dump["gts"], dump["preds"]
    # the pickle stores gravity-center z (the eval convention, see
    # tools/test.py); the visualizers draw bottom-center boxes
    for fr in list(gts) + list(preds):
        if len(fr.get("boxes", [])):
            b = _np.asarray(fr["boxes"], _np.float32).copy()
            b[:, 2] -= 0.5 * b[:, 5]
            fr["boxes"] = b

    if args.config and args.info_path:
        # full dataset.show path: re-load points/images from the infos
        import numpy as np
        from ..configs import get_config
        from ..data import KittiDataset, NuScenesDataset, WaymoDataset
        cfg = get_config(args.config)
        ds_cls = {"nuscenes": NuScenesDataset, "kitti": KittiDataset,
                  "waymo": WaymoDataset}[cfg.dataset]
        ds = ds_cls(cfg, info_path=args.info_path,
                    data_root=args.data_root, test_mode=True)
        for p in preds:
            p.setdefault("labels", np.zeros(len(p["boxes"]), np.int64))
        n = ds.show(preds, args.out_dir, score_thr=args.score_thr,
                    max_frames=args.max_frames, save_3d=args.save_3d)
        print(f"wrote {n} frames to {args.out_dir}")
        return

    from ..vis import show_bev_result
    for i, (g, p) in enumerate(zip(gts, preds)):
        if i >= args.max_frames:
            break
        show_bev_result(p.get("points"), g["boxes"], p["boxes"],
                        os.path.join(args.out_dir, f"frame_{i:04d}.png"),
                        pc_range=args.pc_range)
    print(f"wrote {min(len(preds), args.max_frames)} frames to "
          f"{args.out_dir}")


if __name__ == "__main__":
    main()
