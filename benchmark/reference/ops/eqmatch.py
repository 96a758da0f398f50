"""Column-query rulebooks in plain PyTorch (the port's eq-match, K2).

For each query row q of a ColumnSet's queries, with base cell
(zb, yb, xb) = coord * scale - offset, and each of the 27 taps
(dz, dy, dx) in {0, 1, 2}^3, z-major, the result is the global feature row
of voxel (zb + dz, yb + dy, xb + dx):

    slot = plan map[b, y, x]              (the column of cell (y, x))
    row  = cstart[slot] + popcount(bits[slot] & bits below z)

or the miss row B * row_cap when the cell is out of the plan, its column or
z bit is absent, the row lies past the stage capacity, or the query row is
invalid.  A submanifold rulebook queries each voxel with scale 1 and offset
1; a stride-2 one each output site with scale 2 and offset pad.
"""

from __future__ import annotations

from typing import Tuple

import torch

_I64_MAX = (1 << 63) - 1


def popcount64(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 word (all 64 bits, sign bit included)."""
    x = x - ((x >> 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + ((x >> 2) & 0x3333333333333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    x = x + (x >> 32)
    return x & 0x7F


def mask_below(n: torch.Tensor) -> torch.Tensor:
    """int64 word with the n low bits set; saturates outside [0, 64]."""
    nn = n.clamp(0, 62)
    m = (torch.ones_like(nn) << nn) - 1
    m = torch.where(n == 63, torch.full_like(m, _I64_MAX), m)
    m = torch.where(n >= 64, torch.full_like(m, -1), m)
    return torch.where(n <= 0, torch.zeros_like(m), m)


def plan_map_plain(cs) -> torch.Tensor:
    """Plain version of the plan map: (B * H * W,) int32, each plan cell's
    global column slot b * P + p, or B * P where no column sits."""
    b, p = cs.cmask.shape
    _, h, w = cs.shape
    dev = cs.cmask.device
    cell = (cs.ccoords[..., 0] * w + cs.ccoords[..., 1] +
            torch.arange(b, device=dev)[:, None] * (h * w))
    cell = torch.where(cs.cmask, cell, b * h * w).reshape(-1)
    pmap = torch.full((b * h * w + 1,), b * p, dtype=torch.int32, device=dev)
    pmap[cell] = torch.arange(b * p, dtype=torch.int32, device=dev)
    return pmap[:-1]


def column_query_plain(cs, pmap: torch.Tensor, coords: torch.Tensor,
                       valid: torch.Tensor, scale: int = 1,
                       offset: Tuple[int, int, int] = (1, 1, 1)
                       ) -> torch.Tensor:
    """Plain version of the query: coords (B, Q, 3) zyx and valid (B, Q)
    -> (B, Q, 27) int32, through the plan map of 9 columns a query."""
    b, q, _ = coords.shape
    p = cs.cmask.shape[1]
    _, h, w = cs.shape
    dev = coords.device
    oz, oy, ox = offset
    zb = coords[..., 0] * scale - oz
    c = torch.arange(9, device=dev)
    y = (coords[..., 1] * scale - oy)[..., None] + c // 3     # (B, Q, 9)
    x = (coords[..., 2] * scale - ox)[..., None] + c % 3
    gb = torch.arange(b, device=dev)[:, None, None]
    inb = (y >= 0) & (y < h) & (x >= 0) & (x < w)
    cell = torch.where(inb, (gb * h + y) * w + x, 0)
    slot = torch.where(inb, pmap[cell].long(), b * p)
    words = torch.cat([cs.bits.reshape(-1), cs.bits.new_zeros(1)])
    starts = torch.cat([cs.cstart.reshape(-1), cs.cstart.new_zeros(1)])
    word = words[slot][..., None, :]                          # (B, Q, 1, 9)
    start = starts[slot][..., None, :]
    z = (zb[..., None] + torch.arange(3, device=dev))[..., None]  # (B,Q,3,1)
    present = (z >= 0) & (z < 64) & (((word >> z.clamp(0, 63)) & 1) != 0)
    row = start + popcount64(word & mask_below(z))
    local = row - gb[..., None] * cs.row_cap
    ok = (present & (local >= 0) & (local < cs.row_cap) &
          valid.bool()[..., None, None])
    out = torch.where(ok, row, b * cs.row_cap).to(torch.int32)
    return out.reshape(b, q, 27)


def eqmatch_rulebook(cs, coords: torch.Tensor, valid: torch.Tensor,
                     scale: int = 1,
                     offset: Tuple[int, int, int] = (1, 1, 1)
                     ) -> torch.Tensor:
    """The column-query rulebook (B, Q, 27) int32 of a ColumnSet `cs` at
    queries coords (B, Q, 3) int64 zyx and valid (B, Q) bool."""
    return column_query_plain(cs, plan_map_plain(cs), coords, valid, scale,
                              tuple(offset))
