"""Masked segment reductions (the JAX package's `jax.ops.segment_*` and
mmcv's DynamicScatter)."""

from __future__ import annotations

import torch


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """Mean of data rows per segment; empty segments yield 0.

    Ids outside [0, num_segments) (e.g. ``num_segments`` as the invalid
    marker) are dropped.  Sums and counts accumulate in float32."""
    c = data.shape[1]
    ok = (segment_ids >= 0) & (segment_ids < num_segments)
    ids = torch.where(ok, segment_ids, num_segments).to(torch.int64)
    aug = torch.cat([data.float(), torch.ones_like(data[:, :1],
                                                   dtype=torch.float32)], 1)
    tot = torch.zeros(num_segments + 1, c + 1, dtype=torch.float32,
                      device=data.device).index_add_(0, ids, aug)
    total, count = tot[:num_segments, :-1], tot[:num_segments, -1]
    return (total / count.clamp_min(1.0)[:, None]).to(data.dtype)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Max of data rows per segment; empty segments yield 0, as mmcv's
    DynamicScatter does (it writes only the touched rows of a zero canvas).
    Ids outside [0, num_segments) are dropped."""
    c = data.shape[1]
    ok = (segment_ids >= 0) & (segment_ids < num_segments)
    ids = torch.where(ok, segment_ids, num_segments).to(torch.int64)
    out = data.new_zeros(num_segments + 1, c)
    out = out.scatter_reduce(0, ids[:, None].expand(-1, c), data, "amax",
                             include_self=False)
    return out[:num_segments]
