"""Checkpoints: save and restore a run, and the partial loads of a
pretrained model (the JAX package's `utils/checkpoint.py`, with
`torch.save` / `torch.load` in place of orbax).

A checkpoint is one file written by `torch.save`:

    {"model": model.state_dict(),        # parameters and BN buffers
     "step": int,
     "opt": {"mu", "nu", "count"}}       # FlatAdamW; absent in a
                                         # weights-only checkpoint

and a `<path>.meta.json` beside it (config name, class names, epoch, step)
when the caller passes `meta`.  The partial loads keep the JAX package's
rules: tensors are matched by their state_dict name, a shape mismatch
raises ValueError, and a load that matches no parameter raises KeyError.
The parameters are the JAX package's "params" and the BN running
statistics its "batch_stats"; torch's BatchNorm step counters
(`num_batches_tracked`) have no JAX counterpart and are not loaded.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import torch


def save_checkpoint(path: str, model: torch.nn.Module, opt=None,
                    step: int = 0, meta: Optional[Dict] = None) -> None:
    """Write the model's state_dict, the optimizer's moments and count (when
    given) and the step to `path` (a file; written whole, then renamed)."""
    path = os.path.abspath(path)
    tree = {"model": model.state_dict(), "step": int(step)}
    if opt is not None:
        tree["opt"] = {"mu": opt.mu, "nu": opt.nu, "count": int(opt.count)}
    tmp = path + ".tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)
    if meta is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f, indent=2, default=str)


def _load(path: str, device) -> Dict:
    return torch.load(os.path.abspath(path), map_location=device,
                      weights_only=True)


def restore_checkpoint(path: str, model: torch.nn.Module, opt=None) -> int:
    """Restore a checkpoint of :func:`save_checkpoint` into `model` (every
    tensor, strictly) and, when given, `opt`; returns the saved step."""
    ckpt = _load(path, model.device)
    model.load_state_dict(ckpt["model"])
    if opt is not None:
        if "opt" not in ckpt:
            raise KeyError(f"{path} holds no optimizer state")
        state = ckpt["opt"]
        for name in ("mu", "nu"):
            buf = getattr(opt, name)
            src = state[name]
            if src.shape != buf.shape:
                raise ValueError(
                    f"optimizer {name}: checkpoint {tuple(src.shape)} vs "
                    f"{tuple(buf.shape)} (another set of trainable "
                    f"parameters)")
            buf.copy_(src)
        opt.count = int(state["count"])
    return int(ckpt["step"])


def _merge(model: torch.nn.Module, src: Dict[str, torch.Tensor],
           names) -> List[str]:
    """Copy src's tensors into the model's of the same names (among
    `names`), shape-guarded; returns the names restored."""
    own = model.state_dict()
    hit = []
    for name in names:
        if name not in src:
            continue
        if tuple(src[name].shape) != tuple(own[name].shape):
            raise ValueError(
                f"partial load: shape mismatch at {name}: model "
                f"{tuple(own[name].shape)} vs ckpt {tuple(src[name].shape)}")
        hit.append(name)
    with torch.no_grad():
        for name in hit:
            own[name].copy_(src[name])
    return hit


def _stat_names(model: torch.nn.Module):
    return [n for n, _ in model.named_buffers()
            if not n.endswith("num_batches_tracked")]


def load_partial(model: torch.nn.Module, ckpt_path: str,
                 prefix: str = "") -> List[str]:
    """Prefix-filtered partial restore of parameters (the reference's
    Pretrained-prefix mechanism): every parameter of `model` under the top
    module `prefix` (all of them when empty) takes the checkpoint's tensor
    of the same name; everything else keeps its initialization.  Returns
    the names restored."""
    src = _load(ckpt_path, model.device)["model"]
    params = [n for n, _ in model.named_parameters()]
    if prefix:
        head = prefix + "."
        if not any(n.startswith(head) for n in src) or \
                not any(n.startswith(head) for n in params):
            where = "params" if any(n.startswith(head) for n in src) \
                else "checkpoint"
            raise KeyError(
                f"load_partial: prefix {prefix!r} not found in {where} "
                f"(ckpt top-level keys: "
                f"{sorted({n.split('.')[0] for n in src})[:8]})")
        params = [n for n in params if n.startswith(head)]
    hit = _merge(model, src, params)
    if not hit:
        # a typo'd layout silently fine-tuning from random init is the
        # worst failure mode a partial load can have
        raise KeyError(
            f"load_partial: ZERO leaves matched between {ckpt_path} and "
            f"the model params (ckpt top-level keys: "
            f"{sorted({n.split('.')[0] for n in src})[:8]})")
    print(f"load_partial: restored {len(hit)} leaves from {ckpt_path}"
          + (f" under {prefix!r}" if prefix else ""), flush=True)
    return hit


def load_pretrained(model: torch.nn.Module, ckpt_path: str) -> List[str]:
    """Partial load of parameters AND BN running statistics by name: the
    LiDAR checkpoint into an LC model for the staged fine-tune, where
    frozen-BN fine-tuning needs the running statistics, not just the
    weights.  Returns the names restored."""
    src = _load(ckpt_path, model.device)["model"]
    hit = _merge(model, src, [n for n, _ in model.named_parameters()])
    if not hit:
        raise KeyError(
            f"load_pretrained: ZERO param leaves matched from {ckpt_path} "
            f"(ckpt top-level keys: "
            f"{sorted({n.split('.')[0] for n in src})[:8]})")
    stats = _merge(model, src, _stat_names(model))
    print(f"load_pretrained: restored {len(hit)} param + {len(stats)} "
          f"batch-stat leaves from {ckpt_path}", flush=True)
    return hit + stats


def load_for_eval(path: str, model: torch.nn.Module) -> int:
    """Restore for inference: a training checkpoint (it carries optimizer
    state) whole, else a weights-only checkpoint through
    :func:`load_pretrained`.  Returns the checkpoint's step (0 for a
    weights-only one without a step)."""
    ckpt = _load(path, model.device)
    if "opt" in ckpt:
        model.load_state_dict(ckpt["model"])
        return int(ckpt["step"])
    load_pretrained(model, path)
    return int(ckpt.get("step", 0))
