"""Convert a reference SRFDet3D checkpoint (.pth) for the port (the JAX
package's `tools/convert_checkpoint.py`, writing the port's checkpoint).

Usage:
  python -m srfdet3d_torch.tools.convert_checkpoint <config_name> <in.pth>
      <out.pt> [--spconv-layout KIO|OKI]

Reads the mm-stack checkpoint ({'state_dict': ..., 'meta': ...} or a bare
state_dict; mmdet's distributed `module.` prefix stripped), maps it onto
the port's state_dict names and layouts
(`srfdet3d_torch.utils.torch_convert.convert_reference_state_dict`) and
writes a weights-only checkpoint, parameters and BN running statistics,
that both CLIs read:

  python -m srfdet3d_torch.tools.test <config> <out.pt> ...     # evaluate
  python -m srfdet3d_torch.tools.train <config> --load-from <out.pt> ...

with `<out.pt>.meta.json` beside it (the tensors converted, the reference
keys left unused and the port tensors the file does not set: a LiDAR-only
checkpoint into an LC config sets none of the image branch, which then
keeps its initialisation).  Nothing is written when no tensor matched.
`--spconv-layout`: mmcv.ops sparse convs store (kz, ky, kx, in, out) = KIO
(the reference's import, the default); OKI for spconv 2.x exports.  The
conversion runs on the host; it moves nothing to a device.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

import torch


def load_reference_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference .pth -> {name: tensor} on the CPU, without the `module.`
    prefix of mmdet's distributed checkpoints."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    if state and all(k.startswith("module.") for k in state):
        state = {k[len("module."):]: v for k, v in state.items()}
    return dict(state)


def port_state_shapes(cfg) -> Dict[str, tuple]:
    """The port model's parameters and BN statistics with their shapes
    (the model built on the meta device: no memory, no card)."""
    from ..models.detector import SRFDet
    with torch.device("meta"):
        model = SRFDet(cfg, device="meta")
    return {k: tuple(v.shape) for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("config", help="config name (srfdet3d_torch.configs, "
                                   "e.g. srfdet_voxel_nusc_L)")
    ap.add_argument("input", help="reference checkpoint (.pth)")
    ap.add_argument("output", help="the port's checkpoint file to write")
    ap.add_argument("--spconv-layout", default="KIO", choices=("KIO", "OKI"))
    return ap


def main(argv: Optional[List[str]] = None) -> Dict:
    """Convert; returns the meta record written beside the output."""
    args = build_parser().parse_args(argv)
    from ..configs import get_config
    from ..utils.torch_convert import convert_reference_state_dict

    cfg = get_config(args.config)
    state = load_reference_state_dict(args.input)
    print(f"loaded {len(state)} reference tensors from {args.input}",
          flush=True)
    converted, unused = convert_reference_state_dict(
        state, cfg, spconv_layout=args.spconv_layout)
    if not converted:
        raise SystemExit(
            f"conversion produced ZERO tensors: the checkpoint's module "
            f"names do not match config {cfg.name!r} (sample keys: "
            f"{sorted(state)[:6]}); not writing {args.output}")
    shapes = port_state_shapes(cfg)
    stray = sorted(set(converted) - set(shapes))
    wrong = [k for k in converted if k in shapes and
             tuple(converted[k].shape) != shapes[k]]
    if stray or wrong:
        shown = [(k, tuple(converted[k].shape), shapes[k]) for k in wrong[:4]]
        raise SystemExit(f"converted tensors the {cfg.name!r} model does not "
                         f"hold {stray[:4]} or holds at another shape "
                         f"{shown}")
    unset = sorted(set(shapes) - set(converted))
    out = os.path.abspath(args.output)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = out + ".tmp"
    torch.save({"model": converted, "step": 0}, tmp)
    os.replace(tmp, out)
    stats = sum(k.endswith(("running_mean", "running_var"))
                for k in converted)
    meta = {"config": cfg.name, "classes": list(cfg.class_names),
            "source": os.path.abspath(args.input),
            "spconv_layout": args.spconv_layout,
            "tensors": len(converted), "param_tensors": len(converted) - stats,
            "batch_stat_tensors": stats,
            "unused_reference_keys": len(unused),
            "unused_reference_sample": unused[:20],
            "unset_port_tensors": len(unset),
            "unset_port_sample": unset[:20], "converted": True}
    with open(out + ".meta.json", "w") as f:
        json.dump(meta, f, indent=2)
    print(f"wrote {out}: {len(converted)} tensors ({stats} BN statistics); "
          f"{len(unused)} reference keys unused, {len(unset)} port tensors "
          f"not set", flush=True)
    return meta


if __name__ == "__main__":
    main()
