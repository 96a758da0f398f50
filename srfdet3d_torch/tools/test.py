"""Evaluation CLI of the port (the JAX package's `tools/test.py`).

Usage:
  python -m srfdet3d_torch.tools.test <config_name> [<checkpoint>]
      [--eval auto|mAP|kitti|waymo] [--synthetic] [--out results.pkl]
      [--batch-size B] [--data-root PATH] [--ann-file PATH]
      [--device DEV] [--cfg-options k=v ...]

Runs inference with the config's test_cfg (rotated NMS etc.) on the val
infos, optionally dumps per-frame results to a pickle (--out), and
evaluates with the native metric implementations.  `--eval-from-pkl
results.pkl` re-runs evaluation from a dump without inference.  --device
defaults to cuda (the model, and iou_3d of the KITTI and Waymo metrics).

Multi-process evaluation (dist_test.sh, one process per card, the same
environment as the train CLI's): rank r predicts the frames r, r + W,
r + 2W, ... (`_ProcessShard`), the ranks all-gather each frame's
fixed-shape rows with a mask of real frames, and every rank evaluates
every frame in dataset order, so each reports the metrics one process
would; rank 0 alone writes --out.
"""

from __future__ import annotations

import argparse
import os
import pickle
from typing import Dict, List, Optional

import numpy as np
import torch

from ..parallel import mesh

GT_KEYS = ("gt_boxes", "gt_labels", "gt_mask")


def evaluate(cfg, gts, preds, protocol: str = "auto", device=None) -> Dict:
    """protocol: auto (= cfg.dataset) | mAP/nuscenes | kitti | waymo
    (reference --eval values, tools/test.py:243-252)."""
    from ..evals import kitti_eval, nuscenes_eval, waymo_eval
    kind = cfg.dataset if protocol in ("auto", None) else \
        {"mAP": "nuscenes"}.get(protocol, protocol)
    if kind == "nuscenes":
        return nuscenes_eval(gts, preds, cfg.class_names)
    if kind == "kitti":
        return kitti_eval(gts, preds, cfg.class_names, device=device)
    if kind == "waymo":
        return waymo_eval(gts, preds, cfg.class_names, device=device)
    raise SystemExit(f"unknown --eval protocol {protocol!r}")


def frames_from_outputs(cfg, out: Dict[str, np.ndarray],
                        batch: Dict[str, np.ndarray], n_real: int):
    """The per-frame (gt, pred) dicts of a predict's outputs: the valid
    rows, boxes moved from bottom to gravity centre, label names."""
    names = np.asarray(cfg.class_names)
    gts, preds = [], []
    for i in range(n_real):
        v = out["valid"][i].astype(bool)
        pb = out["boxes"][i][v].copy()
        pb[:, 2] += 0.5 * pb[:, 5]           # bottom -> gravity center
        preds.append({"boxes": pb, "scores": out["scores"][i][v],
                      "labels_name": names[out["labels"][i][v]]})
        gm = batch["gt_mask"][i].astype(bool)
        gts.append({"boxes": batch["gt_boxes"][i][gm],
                    "labels_name": names[batch["gt_labels"][i][gm]]})
    return gts, preds


class _ProcessShard:
    """Strided per-process view of a dataset (multi-process eval): items
    offset, offset + stride, ..."""

    def __init__(self, ds, offset: int, stride: int):
        self.ds, self.offset, self.stride = ds, offset, stride

    def __len__(self):
        return max((len(self.ds) - self.offset + self.stride - 1)
                   // self.stride, 0)

    def __getitem__(self, i):
        return self.ds[self.offset + i * self.stride]


def run_inference_eval(cfg, dataset, model, batch_size: int,
                       protocol: str = "auto", out: Optional[str] = None,
                       device=None) -> Dict:
    """Inference over `dataset` with `model` in eval mode, then the native
    metric.  Every frame scores: the ragged tail batch is padded to
    batch_size by repeating its last frame and only its real rows are
    kept.  Optionally dumps {gts, preds} to `out`.  Returns the metric
    dict.

    Under a process group each rank predicts its strided shard, the
    frames' fixed-shape rows are all-gathered (process-major, padded to
    the largest shard, with a mask of real frames, as the JAX package's
    process_allgather) and put back in dataset order, as the reference's
    collect_results does; every rank evaluates them all, and rank 0 alone
    writes `out`.  Fewer frames than ranks aborts on every rank."""
    from ..data import data_loader
    from ..train.trainer import eval_step

    if mesh.active():
        w = mesh.world()
        if len(dataset) < w:
            # the global length decides on every rank alike
            raise SystemExit(f"dataset has {len(dataset)} frames < "
                             f"{w} processes")
        dataset = _ProcessShard(dataset, mesh.rank(), w)

    parts: Dict[str, List[np.ndarray]] = {}
    for batch in data_loader(dataset, batch_size, shuffle=False,
                             num_workers=2, drop_last=False):
        n_real = next(iter(batch.values())).shape[0]
        if n_real < batch_size:
            batch = {k: np.concatenate(
                [v] + [v[-1:]] * (batch_size - n_real)) for k, v in
                batch.items()}
        res = eval_step(model, {k: torch.from_numpy(v)
                                for k, v in batch.items()
                                if k not in GT_KEYS})
        rows = {k: v.cpu().numpy()[:n_real] for k, v in res.items()}
        rows.update({k: batch[k][:n_real] for k in GT_KEYS})
        for k, v in rows.items():
            parts.setdefault(k, []).append(v)
    rows = {k: np.concatenate(v) for k, v in parts.items()}
    if mesh.active():
        rows = mesh.strided_order(*mesh.gather_rows(rows))
    gts, preds = frames_from_outputs(cfg, rows, rows,
                                     len(rows["gt_mask"]) if rows else 0)
    if out and mesh.rank() == 0:
        with open(out, "wb") as f:
            pickle.dump({"gts": gts, "preds": preds}, f)
        print(f"dumped {len(preds)} frames to {out}", flush=True)
    return evaluate(cfg, gts, preds, protocol, device=device)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("config")
    ap.add_argument("checkpoint", nargs="?", default=None)
    ap.add_argument("--eval", default="auto")
    ap.add_argument("--out", default=None)
    ap.add_argument("--eval-from-pkl", default=None)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--synthetic-length", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--data-root", default="data/nuscenes")
    ap.add_argument("--ann-file", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--cfg-options", nargs="*", default=None)
    return ap


def main(argv: Optional[List[str]] = None) -> Dict:
    """Evaluate; returns the metric dict (per-class tables included)."""
    args = build_parser().parse_args(argv)
    dev = mesh.rank_device(args.device)
    joined = mesh.init_from_env(dev)
    try:
        return _test(args, dev)
    finally:
        if joined:
            mesh.shutdown()


def _test(args, dev: torch.device) -> Dict:
    from ..configs import get_config
    from .train import apply_cfg_options, dataset_class
    cfg = apply_cfg_options(get_config(args.config), args.cfg_options)

    if args.eval_from_pkl:
        with open(args.eval_from_pkl, "rb") as f:
            dump = pickle.load(f)
        res = evaluate(cfg, dump["gts"], dump["preds"], args.eval,
                       device=dev)
        print({k: v for k, v in res.items() if not isinstance(v, dict)})
        return res

    from ..data import SyntheticDataset
    from ..models.detector import SRFDet
    from ..utils.checkpoint import load_for_eval

    if args.synthetic:
        # keep GTs for eval but run the DETERMINISTIC protocol: no
        # random augs, no sweep sampling, no point shuffle
        dataset = SyntheticDataset(cfg, length=args.synthetic_length,
                                   test_mode=False, augment=False)
    else:
        ann = args.ann_file or os.path.join(
            args.data_root, f"{cfg.dataset}_infos_val.pkl")
        dataset = dataset_class(cfg)(cfg, info_path=ann,
                                     data_root=args.data_root,
                                     test_mode=False, augment=False)

    model = SRFDet(cfg, device=dev)
    if args.checkpoint:
        step = load_for_eval(args.checkpoint, model)
        print(f"loaded {args.checkpoint} @ step {step}", flush=True)
    res = run_inference_eval(cfg, dataset, model, args.batch_size,
                             args.eval, out=args.out, device=dev)
    who = f"rank {mesh.rank()}: " if mesh.world() > 1 else ""
    print(who + str({k: (round(v, 4) if isinstance(v, float) else v)
                     for k, v in res.items() if not isinstance(v, dict)}))
    return res


if __name__ == "__main__":
    main()
