"""Small constant tensors made once on their device.

`like.new_tensor(values)` or `torch.tensor(values, device=card)` copies
from host memory on every call, and on a card that copy waits for the
stream: the host stalls until the card has drained its queue.  The model
builds the same few constants every iteration (the point-cloud range, the
voxel size, the RoI levels' extents), so `constant` makes each one once
per (values, dtype, device) and hands back that tensor afterwards.  The
values are the ones `torch.tensor` makes, bit for bit (bfloat16 included:
the key holds the dtype).  Only the first call of a key copies, and only
it counts as a `host_sync`.  A CUDA graph may read a cached constant: it
stays alive, at its address, for the life of the process.

While a program is exported or compiled, and for fake or meta tensors,
nothing is cached: the call is the plain `torch.tensor`.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from . import profiling

_cache: Dict[Tuple, torch.Tensor] = {}


def constant(values: Sequence, like: Optional[torch.Tensor] = None, *,
             dtype: Optional[torch.dtype] = None,
             device: Optional[torch.device] = None) -> torch.Tensor:
    """`like.new_tensor(values)` (like's dtype and device), or
    `torch.tensor(values, dtype=dtype, device=device)` without `like`,
    made once and shared.  Callers must not write into it."""
    if like is not None:
        dtype, device = like.dtype, like.device
    device = torch.device("cpu" if device is None else device)
    if (torch.compiler.is_exporting() or torch.compiler.is_compiling() or
            device.type == "meta" or
            (like is not None and type(like) is not torch.Tensor and
             type(like) is not torch.nn.Parameter)):
        return torch.tensor(values, dtype=dtype, device=device)
    values = tuple(values)
    # with no dtype the values' Python types pick it (1 and 1.0 hash alike)
    key = (values, dtype, device, torch.get_default_dtype(),
           tuple(map(type, values)) if dtype is None else None)
    t = _cache.get(key)
    if t is None:
        # a plain tensor even inside inference mode: a train step may save
        # it for its backward
        with torch.inference_mode(False):
            t = torch.tensor(values, dtype=dtype, device=device)
        if type(t) is not torch.Tensor:       # a fake or functional mode
            return t
        # on a card the copy from host memory waits for the stream
        profiling.count("host_sync")
        _cache[key] = t
    return t
