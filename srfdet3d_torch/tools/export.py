"""Export the whole predict as one `torch.export` artifact (the JAX
package's `tools/export.py`).

The artifact is one static-shape program: voxelize -> VFE -> sparse
encoder -> SECOND/FPN -> head -> decode -> rotated NMS, an
`ExportedProgram` written by `torch.export.save` (`.pt2`).  It runs
without the model's Python code.  The hand-written kernels stay in it as
the registered ops `srfdet::gather_conv`, `srfdet::eqmatch_rulebook`,
`srfdet::key_hash` and `srfdet::rulebook_lookup`, and NMS's fixed point as
one `while_loop` node; a program exported on the card launches the same
kernels, as often, as the live predict.

Usage:
  python -m srfdet3d_torch.tools.export --config srfdet_voxel_nusc_L \\
      --out flagship.pt2
  python -m srfdet3d_torch.tools.export --config srfdet_voxel_nusc_L \\
      --out flagship.pt2 --checkpoint work_dirs/x/epoch_1.pt \\
      --bake-params --batch-size 1 [--device cpu]

The two calling conventions:
  * weights passed in (the default): the program takes (state, batch),
    `state` the model's parameters and buffers by name (its
    `state_dict()`); pair it with a checkpoint at load time;
  * --bake-params: the program takes only `batch`, and the weights
    travel in the `.pt2` (self-contained, larger file).
`batch` is {"points" (B, P, D) float32, "points_mask" (B, P) bool} and,
for an LC config, "images" (B, n_cam, H, W, 3) float32 and "lidar2img"
(B, n_cam, 4, 4) float32, at the shapes of the export (batch size and
capacities are fixed, as in the JAX artifact).  The output is the
predict's dict (boxes, scores, labels, valid).

A loader imports the op library first, then loads:
  import srfdet3d_torch.ops.library       # registers the srfdet:: ops
  prog = torch.export.load("flagship.pt2")
  out = prog.module()(state, batch)       # or prog.module()(batch)
(`load_artifact(path)` does both.)  --device defaults to cuda: a program
exported on the card calls the CUDA kernels, one exported on the CPU the
plain versions.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from .. import resolve_device


def synthetic_batch(cfg, batch_size: int = 1, with_gt: bool = False,
                    seed: int = 0) -> Dict[str, torch.Tensor]:
    """The JAX package's synthetic scene (`__graft_entry__`'s
    `_synthetic_batch`), draw for draw, as CPU tensors: half of
    points_cap real points, uniform in pc_range; with_gt adds gt_cap GT
    boxes of which the first 8 are valid."""
    rng = np.random.default_rng(seed)
    b, p = batch_size, cfg.points_cap
    pts = np.zeros((b, p, cfg.points_dim), np.float32)
    n = p // 2
    lo, hi = cfg.pc_range[:3], cfg.pc_range[3:6]
    for d in range(3):
        pts[:, :n, d] = rng.uniform(lo[d], hi[d], (b, n))
    if cfg.points_dim > 3:
        pts[:, :n, 3:] = rng.uniform(0, 1, (b, n, cfg.points_dim - 3))
    mask = np.zeros((b, p), bool)
    mask[:, :n] = True
    batch = {"points": pts, "points_mask": mask}
    if with_gt:
        g = cfg.gt_cap
        gt = np.zeros((b, g, 9 if cfg.head.code_size == 10 else 7),
                      np.float32)
        gt[..., 0] = rng.uniform(lo[0] * 0.8, hi[0] * 0.8, (b, g))
        gt[..., 1] = rng.uniform(lo[1] * 0.8, hi[1] * 0.8, (b, g))
        gt[..., 2] = rng.uniform(lo[2] * 0.5, hi[2] * 0.5, (b, g))
        gt[..., 3:6] = rng.uniform(0.5, 4.0, (b, g, 3))
        gt[..., 6] = rng.uniform(-np.pi, np.pi, (b, g))
        batch["gt_labels"] = rng.integers(0, cfg.num_classes,
                                          (b, g)).astype(np.int32)
        gmask = np.zeros((b, g), bool)
        gmask[:, :min(8, g)] = True
        batch["gt_boxes"], batch["gt_mask"] = gt, gmask
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def example_batch(cfg, batch_size: int = 1, seed: int = 0,
                  device=None) -> Dict[str, torch.Tensor]:
    """The export's example inputs on `device`: the synthetic scene and,
    for an LC config, zero images and identity lidar2img, as the JAX
    `build_predict` makes them."""
    batch = synthetic_batch(cfg, batch_size, seed=seed)
    if cfg.use_img:
        n_cam = cfg.img.num_cams
        h, w = cfg.img.img_shape
        batch["images"] = torch.zeros(batch_size, n_cam, h, w, 3)
        batch["lidar2img"] = torch.eye(4).expand(batch_size, n_cam, 4,
                                                 4).contiguous()
    return {k: v.to(device) for k, v in batch.items()}


class PredictWithState(nn.Module):
    """forward(state, batch) = model.predict(batch) with every parameter
    and buffer of the model taken from `state` (by state_dict name).  The
    model is held outside the module tree, so an export of this module
    carries none of its tensors."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.__dict__["model"] = model

    @torch.no_grad()
    def forward(self, state: Dict[str, torch.Tensor],
                batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        preds = torch.func.functional_call(self.model, state, (batch,),
                                           strict=True)
        return self.model.decode(preds)


class PredictBaked(nn.Module):
    """forward(batch) = model.predict(batch); an export of this module
    carries the model's parameters and buffers."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, batch: Dict[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        return self.model.predict(batch)


def build_predict(cfg, model: Optional[nn.Module] = None,
                  bake_params: bool = False, batch_size: int = 1,
                  rng_seed: int = 0, device=None):
    """(module, example_args) of the predict surface of `cfg`: a
    PredictWithState and (state, batch), or with bake_params a
    PredictBaked and (batch,).  Without `model`, a model of `cfg` with the
    seeded init `rng_seed` on `device` (default cuda); the batch is
    `example_batch` on the model's device."""
    if model is None:
        from ..models.detector import SRFDet
        model = SRFDet(cfg, device=resolve_device(device), seed=rng_seed)
    model.eval()
    batch = example_batch(cfg, batch_size, seed=rng_seed,
                          device=model.device)
    if bake_params:
        return PredictBaked(model), (batch,)
    return PredictWithState(model), (model.state_dict(), batch)


def export_predict(cfg, out_path: str, model: Optional[nn.Module] = None,
                   bake_params: bool = False, batch_size: int = 1,
                   rng_seed: int = 0, device=None
                   ) -> torch.export.ExportedProgram:
    """Export the predict of `cfg` (build_predict's module) and write it
    to `out_path` with `torch.export.save`; returns the program."""
    module, args = build_predict(cfg, model=model, bake_params=bake_params,
                                 batch_size=batch_size, rng_seed=rng_seed,
                                 device=device)
    with torch.no_grad():
        prog = torch.export.export(module, args, strict=False)
    # the example inputs would travel in the file (with weights passed
    # in, the whole state): a caller brings its own
    prog.example_inputs = None
    # the program's weights share the model's tensors; frozen copies keep
    # a baked program's outputs free of autograd, as the live predict's
    for name, t in list(prog.state_dict.items()):
        prog.state_dict[name] = nn.Parameter(t.detach(), requires_grad=False) \
            if isinstance(t, nn.Parameter) else t
    torch.export.save(prog, out_path)
    return prog


def load_artifact(path: str) -> torch.export.ExportedProgram:
    """Load a `.pt2` of export_predict: registers the srfdet:: ops (the op
    library alone, no model code), then `torch.export.load`.  Call it
    with `.module()(state, batch)` or `.module()(batch)`."""
    from ..ops import library  # noqa: F401  (registers the ops)
    return torch.export.load(path)


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", required=True,
                   help="config name (srfdet3d_torch.configs)")
    p.add_argument("--out", required=True, help="output .pt2 path")
    p.add_argument("--checkpoint", default=None,
                   help="the port's checkpoint to export the weights of "
                        "(default: the seeded init)")
    p.add_argument("--bake-params", action="store_true",
                   help="carry the weights in the artifact; it then takes "
                        "only the batch")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--device", default=None,
                   help="device to export on (default: cuda)")
    args = p.parse_args(argv)

    from ..configs import get_config
    from ..models.detector import SRFDet
    from ..utils.checkpoint import load_for_eval

    cfg = get_config(args.config)
    model = SRFDet(cfg, device=resolve_device(args.device))
    if args.checkpoint:
        load_for_eval(args.checkpoint, model)
    t0 = time.perf_counter()
    prog = export_predict(cfg, args.out, model=model,
                          bake_params=args.bake_params,
                          batch_size=args.batch_size)
    seconds = time.perf_counter() - t0
    size = os.path.getsize(args.out)
    n_inputs = len(prog.graph_signature.user_inputs)
    print(f"exported {args.config} predict -> {args.out} "
          f"({size / 1e6:.1f} MB, device={model.device}, "
          f"{'baked' if args.bake_params else 'weights passed in'}, "
          f"{n_inputs} inputs, {seconds:.1f} s)")
    return dict(program=prog, path=args.out, bytes=size, seconds=seconds,
                model=model)


if __name__ == "__main__":
    main()
