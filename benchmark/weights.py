"""Seeded weights, made on the device in a few large draws.

The rule reads only a state dict's names and shapes, so the system under
test and the reference, whose state dicts have the same names and shapes,
get the same weights from one seed.  Families (the detector's own init,
with the norms, biases and running statistics also drawn, so that every
term of the arithmetic is exercised):

  - dense and conv weights (ndim 2: (out, in); ndim 4: (out, in / groups,
    kh, kw)): N(0, 1 / fan_in);
  - sparse-conv kernels `*.kernel` (K, Cin, Cout): N(0, 2 / (K * Cin));
  - the head's proposal embeddings `init_proposal_*`: N(0, 1);
  - norm scales (`*.weight`, ndim 1): 1 + N(0, 0.1^2); other biases
    N(0, 0.02^2), the class logits' bias around the focal prior;
  - running means N(0, 0.1^2), running variances 1 + 0.2 U(-0.5, 0.5);
  - integer buffers (BN step counts) are left as they are.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from .scene import derived_seed

# log(p / (1 - p)) at the configs' prior_prob 0.01
FOCAL_BIAS = -math.log((1 - 0.01) / 0.01)


def _family(name: str, shape) -> tuple:
    """(kind, scale, shift) of one entry: kind "n" (normal) or "u"
    (uniform on [-0.5, 0.5])."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "running_mean":
        return "n", 0.1, 0.0
    if leaf == "running_var":
        return "u", 0.2, 1.0
    if "init_proposal_" in leaf:
        return "n", 1.0, 0.0
    if leaf == "kernel":
        k, cin = shape[0], shape[1]
        return "n", math.sqrt(2.0 / (k * cin)), 0.0
    if leaf == "bias":
        if name.endswith("class_logits.bias"):
            return "n", 0.1, FOCAL_BIAS
        return "n", 0.02, 0.0
    if len(shape) == 1:
        return "n", 0.1, 1.0
    fan_in = math.prod(shape[1:])
    return "n", 1.0 / math.sqrt(fan_in), 0.0


@torch.no_grad()
def seeded_state(template: Dict[str, torch.Tensor], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """A state dict with the names and shapes of `template` (float entries
    only), drawn from `seed` on `device`: one normal and one uniform draw
    for all entries, then one scale and shift a element."""
    names = [k for k, v in template.items() if v.is_floating_point()]
    shapes = [tuple(template[k].shape) for k in names]
    sizes = [math.prod(s) for s in shapes]
    fams = [_family(k, s) for k, s in zip(names, shapes)]
    g = torch.Generator(device=device)
    g.manual_seed(derived_seed(seed, 0x5EED))
    total = sum(sizes)
    normal = torch.randn(total, generator=g, device=device)
    uniform = torch.rand(total, generator=g, device=device) - 0.5
    counts = torch.tensor(sizes, device=device)
    is_u = torch.tensor([f[0] == "u" for f in fams], device=device)
    scale = torch.tensor([f[1] for f in fams], device=device)
    shift = torch.tensor([f[2] for f in fams], device=device)
    flat = torch.where(is_u.repeat_interleave(counts), uniform, normal)
    flat = flat * scale.repeat_interleave(counts) + \
        shift.repeat_interleave(counts)
    return {k: v.view(s) for k, v, s in zip(
        names, torch.split(flat, sizes), shapes)}
