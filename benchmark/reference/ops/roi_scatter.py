"""The bilinear corners of a RoI's samples, per axis and expanded."""

from __future__ import annotations

import torch


def expand_axes(cells: torch.Tensor, cw: torch.Tensor, level: torch.Tensor):
    """Per-axis corners -> (idx (R, 4, S, S) int64 table rows, w (R, 4, S,
    S) weights), corner q = 2 * (y corner) + (x corner): the outer product
    of the sample rows' and columns' corners."""
    base = level[:, 0].long()[:, None, None]
    width = level[:, 1].long()[:, None, None]
    cl = cells.long()
    idx, w = [], []
    for qy in (0, 1):
        for qx in (2, 3):
            idx.append(base + cl[:, qy, :, None] * width + cl[:, qx, None, :])
            w.append(cw[:, qy, :, None] * cw[:, qx, None, :])
    return torch.stack(idx, 1), torch.stack(w, 1)
