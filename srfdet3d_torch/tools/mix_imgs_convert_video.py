"""Stitch saved result images into a video grid
(reference tools/mix_imgs_convert_video.py; the port's copy of the JAX
package's tool, the same arguments and video).

Usage: python -m srfdet3d_torch.tools.mix_imgs_convert_video --bev-dir vis/
       --out out.mp4 [--cam-dirs d1 d2 ...] [--fps 2]

Needs cv2 (a host tool: the card machine has none).
"""

from __future__ import annotations

import argparse
import glob
import os


def _natsort(paths):
    import re

    def key(p):
        return [int(t) if t.isdigit() else t
                for t in re.split(r"(\d+)", os.path.basename(p))]
    return sorted(paths, key=key)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--bev-dir", required=True)
    ap.add_argument("--cam-dirs", nargs="*", default=[])
    ap.add_argument("--out", default="results.mp4")
    ap.add_argument("--fps", type=int, default=2)
    args = ap.parse_args(argv)

    import cv2
    import numpy as np

    bev_files = _natsort(glob.glob(os.path.join(args.bev_dir, "*.png")) +
                         glob.glob(os.path.join(args.bev_dir, "*.jpg")))
    if not bev_files:
        raise SystemExit(f"no images in {args.bev_dir}")
    cam_files = [_natsort(glob.glob(os.path.join(d, "*.png")) +
                          glob.glob(os.path.join(d, "*.jpg")))
                 for d in args.cam_dirs]

    first = cv2.imread(bev_files[0])
    h, w = first.shape[:2]
    n_cam = len(cam_files)
    out_w = w * (1 + (n_cam > 0))
    writer = cv2.VideoWriter(args.out, cv2.VideoWriter_fourcc(*"mp4v"),
                             args.fps, (out_w, h))
    for i, bf in enumerate(bev_files):
        frame = cv2.imread(bf)
        frame = cv2.resize(frame, (w, h))
        if n_cam:
            cams = []
            for cf in cam_files:
                img = cv2.imread(cf[min(i, len(cf) - 1)]) \
                    if cf else np.zeros((h, w, 3), np.uint8)
                cams.append(cv2.resize(img, (w, h // max(n_cam, 1))))
            right = np.concatenate(cams, axis=0)[:h]
            if right.shape[0] < h:
                right = np.pad(right, ((0, h - right.shape[0]), (0, 0),
                                       (0, 0)))
            frame = np.concatenate([frame, right], axis=1)
        writer.write(frame)
    writer.release()
    print(f"wrote {args.out} ({len(bev_files)} frames)")


if __name__ == "__main__":
    main()
