"""What the benchmark takes from the system under test, `srfdet3d_torch`:
its config type, the detector, the train step, its kernel build and its
counters.  No other file of the harness imports the system; the reference
(`benchmark/reference`) imports nothing of it."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

import torch

from . import weights

# the config's nested groups and the dataclass each one holds
GROUPS = {"vfe": "VFEConfig", "middle": "MiddleConfig",
          "backbone": "BackboneConfig", "img": "ImgBranchConfig",
          "head": "HeadConfig", "ota": "OTAConfig", "loss": "LossConfig",
          "test": "TestConfig", "optim": "OptimConfig", "aug": "AugConfig"}
# the CUDA sources of the system's kernels (built once a checkout)
KERNELS = ("gather_conv", "gather_conv_bwd", "eqmatch", "roi_scatter",
           "rulebook_lookup")


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def build_config(config_module, doc: dict):
    """The SRFDetConfig of a config file's fields (`doc`), built with the
    dataclasses of `config_module` (the system's `config` or the
    reference's copy of it); keys that are no field (source, assumed)
    are skipped.  Raises unless the config, written back, gives the same
    fields: the file holds the configuration as it is run."""
    cls = config_module.SRFDetConfig
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in doc:
            raise KeyError(f"config file lacks {f.name!r}")
        v = doc[f.name]
        if f.name in GROUPS and v is not None:
            sub = getattr(config_module, GROUPS[f.name])
            v = sub(**{k: _tuples(x) for k, x in v.items()})
        kw[f.name] = _tuples(v)
    cfg = cls(**kw)
    back = dataclasses.asdict(cfg)
    if _lists(back) != _lists({k: doc[k] for k in back}):
        raise ValueError("the config file does not round-trip")
    return cfg


def _lists(v):
    if isinstance(v, dict):
        return {k: _lists(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_lists(x) for x in v]
    return v


def system():
    return importlib.import_module("srfdet3d_torch")


def config(doc: dict):
    return build_config(importlib.import_module("srfdet3d_torch.config"),
                        doc)


def build_kernels() -> float:
    """Build (first run of a checkout) or find every kernel library under
    the checkout's build/kernels; returns the seconds taken."""
    from srfdet3d_torch.ops import cuda_build
    return cuda_build.build_kernels(KERNELS)


@torch.no_grad()
def model(cfg, seed: int, device):
    """The detector with the benchmark's seeded weights (weights.py), made
    on the device: built without its own random init (a deployment loads
    its weights), then loaded."""
    from srfdet3d_torch.models.detector import SRFDet
    init = SRFDet._init_weights
    SRFDet._init_weights = lambda self, g: None
    try:
        with torch.device(device):
            net = SRFDet(cfg, device=device)
    finally:
        SRFDet._init_weights = init
    state = weights.seeded_state(net.state_dict(), seed, device)
    missing = [k for k, v in net.state_dict().items()
               if v.is_floating_point() and k not in state]
    if missing:
        raise KeyError(f"no seeded weights for {missing[:3]}")
    net.load_state_dict(state, strict=False)
    return net


def optimizer(net, cfg, total_steps: int):
    from srfdet3d_torch.train.trainer import make_optimizer
    return make_optimizer(net, cfg, total_steps)


def train_step(net, opt, batch, generator):
    from srfdet3d_torch.train.trainer import train_step as step
    return step(net, opt, batch, generator)


def step_generator(net, seed: int, step: int):
    from srfdet3d_torch.train.trainer import step_generator as gen
    return gen(net, seed, step)


def nms_sweeps() -> int:
    """Host round trips of the last predict's rotated-NMS loop (the
    system's counter)."""
    from srfdet3d_torch.geometry import iou
    return iou.last_nms_sweeps


def k3_call():
    """(module, attribute, span) of the system's submanifold backward call
    (K3), which the traced run wraps in a span."""
    return [(importlib.import_module("srfdet3d_torch.ops.sparse_conv"),
             "subm_conv_bwd", "k3")]


def losses_module():
    """The module whose `ota_assign_batch` the losses call (the
    assignment's recorder wraps it)."""
    return importlib.import_module("srfdet3d_torch.models.losses")


def modules(net) -> Dict[str, torch.nn.Module]:
    """The detector's stages that the traced run times by name."""
    names = ("pts_middle_encoder", "pts_backbone", "pts_neck", "bbox_head",
             "img_backbone", "img_neck")
    return {n: getattr(net, n) for n in names if hasattr(net, n)}
