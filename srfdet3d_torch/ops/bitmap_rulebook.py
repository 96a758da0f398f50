"""Bitmap-column rulebooks for the sparse 3D encoder.

The z axis of every shipped grid is thin (41 -> 21 -> 11 -> 5 cells), so a
stage's voxel set factorizes into plan (y, x) columns times per-column z
bitmaps.  A column's occupancy is one int64 word here (bit z set iff voxel
(z, y, x) exists); the JAX package keeps the same bits as two uint32 words.

With voxels sorted plan-major ((y, x) major, z minor, invalid rows at each
sample's tail), every rulebook entry is integer math on small tables: the
feature row of voxel (z, y, x) is its column's first row plus the number of
set bits below z.  Rows index the flat (B * row_cap + 1,) feature table of
the stage; B * row_cap is the miss row, which reads zeros.

Offsets are z-major (dz, dy, dx).  A capacity overflow drops the highest
plan-major sites, and a neighbour whose row lies past its stage's capacity
misses, exactly as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..utils import profiling
from .eqmatch import eqmatch_rulebook, mask_below, popcount64


# ------------------------------------------------------------ int64 bits

def bit_get(word: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    ok = (z >= 0) & (z < 64)
    return ok & (((word >> z.clamp(0, 63)) & 1) != 0)


def select_bit(word: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Position of the (k+1)-th set bit of each word (k < popcount)."""
    pos = torch.arange(64, device=word.device)
    cum = torch.cumsum((word[..., None] >> pos) & 1, dim=-1)
    return (cum <= k[..., None]).sum(-1)


def decimate_bits(bits: torch.Tensor, pz: int, zout: int) -> torch.Tensor:
    """z occupancy under a kernel-3 stride-2 conv along z: out bit oz is
    set iff any of in bits 2*oz - pz + {0, 1, 2} is (zout <= 32)."""
    u = bits << pz
    oz = torch.arange(zout, device=bits.device)
    taps = ((u[..., None] >> (2 * oz)) & 7) != 0
    return (taps.to(torch.int64) << oz).sum(-1)


# ------------------------------------------------------------ columns

@dataclasses.dataclass
class ColumnSet:
    """Plan-sparse, z-bitmap view of one stage's voxel set (batched).

    Columns ascend by plan key (y * W + x) with the invalid ones at each
    sample's tail; a column's voxels are contiguous feature rows, ascending
    in z."""
    ccoords: torch.Tensor   # (B, P, 2) int64 (y, x)
    cmask: torch.Tensor     # (B, P) bool
    cstart: torch.Tensor    # (B, P) int64 GLOBAL row of the column's first voxel
    bits: torch.Tensor      # (B, P) int64 z occupancy
    shape: Tuple[int, int, int]   # (D, H, W)
    row_cap: int


def build_columns(coords: torch.Tensor, vmask: torch.Tensor,
                  shape: Tuple[int, int, int]):
    """Plan-major sorted voxels (B, V, 3) zyx -> (ColumnSet, vcol (B, V),
    vz (B, V)).  vcol is the global column slot b * P + p (miss B * P);
    the column capacity P equals V."""
    b, v, _ = coords.shape
    _, h, w = shape
    dev = coords.device
    p_cap = v
    pkey = torch.where(vmask, coords[..., 1] * w + coords[..., 2], h * w)
    gb = torch.arange(b, device=dev)[:, None]
    fkey = (pkey + gb * (h * w + 1)).reshape(-1)
    fmask = vmask.reshape(-1)
    head = torch.ones_like(fmask)
    head[1:] = fkey[1:] != fkey[:-1]
    head &= fmask
    grank = torch.cumsum(head.to(torch.int64), 0) - 1
    starts = torch.arange(b, device=dev) * v
    base = torch.where(starts > 0, grank[(starts - 1).clamp_min(0)] + 1, 0)
    sb = torch.arange(b, device=dev).repeat_interleave(v)
    col_local = grank - base[sb]

    trash = b * (p_cap + 1) - 1
    gcol = torch.where(fmask, col_local + sb * (p_cap + 1), trash)
    ghead = torch.where(head, gcol, trash)
    n = b * (p_cap + 1)
    cc = torch.zeros(n, 2, dtype=torch.int64, device=dev)
    cc[ghead] = coords.reshape(-1, 3)[:, 1:3]
    cstart = torch.zeros(n, dtype=torch.int64, device=dev)
    cstart[ghead] = torch.arange(b * v, device=dev)
    cmask = torch.zeros(n, dtype=torch.bool, device=dev)
    cmask[ghead] = True
    # the scalar's copy from host memory waits for the stream on a card
    profiling.count("host_sync")
    z = coords[..., 0].reshape(-1)
    # distinct voxels of a column have distinct z: the sum is an exact OR
    bits = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
        0, gcol, torch.where(fmask, torch.ones_like(z) << z.clamp(0, 63), 0))

    def strip(t):
        return t.reshape((b, p_cap + 1) + t.shape[1:])[:, :p_cap]

    cs = ColumnSet(ccoords=strip(cc), cmask=strip(cmask),
                   cstart=strip(cstart), bits=strip(bits), shape=shape,
                   row_cap=v)
    vcol = torch.where(fmask, col_local + sb * p_cap, b * p_cap).reshape(b, v)
    return cs, vcol, coords[..., 0]


def column_tables(cs: ColumnSet):
    """Flat (B * P,) column tables for rulebook queries: globally ascending
    keys b * (H*W + 1) + y * W + x (an invalid column holds its sample's
    sentinel b * (H*W + 1) + H*W), int64 z words and global first rows
    (both zero on invalid columns)."""
    b, p = cs.cmask.shape
    _, h, w = cs.shape
    gb = torch.arange(b, device=cs.cmask.device)[:, None]
    key = torch.where(cs.cmask, cs.ccoords[..., 0] * w + cs.ccoords[..., 1],
                      h * w) + gb * (h * w + 1)
    words = torch.where(cs.cmask, cs.bits, 0)
    starts = torch.where(cs.cmask, cs.cstart, 0)
    return (key.reshape(-1).contiguous(), words.reshape(-1).contiguous(),
            starts.reshape(-1).contiguous())


def _column_yx(cs: ColumnSet, vcol: torch.Tensor) -> torch.Tensor:
    """(B, M) global column slots (miss B * P) -> (B, M, 2) plan coords."""
    b, p = cs.cmask.shape
    flat = torch.cat([cs.ccoords.reshape(b * p, 2),
                      cs.ccoords.new_zeros(1, 2)])
    return flat[vcol]


def column_rulebook_plain(keys: torch.Tensor, words: torch.Tensor,
                          starts: torch.Tensor, ybase: torch.Tensor,
                          xbase: torch.Tensor, zbase: torch.Tensor,
                          valid: torch.Tensor, hw: Tuple[int, int],
                          row_cap: int) -> torch.Tensor:
    """The rulebook of queries with base cells (zbase, ybase, xbase) from
    the flat column tables (column_tables): each tap's column found by a
    search of the sorted keys.  keys/words/starts (N,) int64, bases and
    valid (B, Q) -> (B, Q, 27) int32, taps z-major."""
    b, q = ybase.shape
    h, w = hw
    dev = keys.device
    t = torch.arange(27, device=dev)
    dz, dy, dx = t // 9, (t // 3) % 3, t % 3
    y = ybase.to(torch.int64)[..., None] + dy
    x = xbase.to(torch.int64)[..., None] + dx
    z = zbase.to(torch.int64)[..., None] + dz
    gb = torch.arange(b, device=dev)[:, None, None]
    inb = (y >= 0) & (y < h) & (x >= 0) & (x < w)
    key = torch.where(inb, gb * (h * w + 1) + y * w + x, -1)
    pos = torch.searchsorted(keys, key.reshape(-1)).reshape(key.shape)
    pos = pos.clamp_max(keys.numel() - 1)
    found = inb & (keys[pos] == key)
    word = torch.where(found, words[pos], 0)
    present = bit_get(word, z)
    row = starts[pos] + popcount64(word & mask_below(z))
    local = row - gb * row_cap
    ok = (found & present & (local >= 0) & (local < row_cap) &
          valid.bool()[..., None])
    return torch.where(ok, row, b * row_cap).to(torch.int32)


def _query(cs: ColumnSet, ybase, xbase, zbase, valid):
    keys, words, starts = column_tables(cs)
    return column_rulebook_plain(keys, words, starts, ybase, xbase, zbase,
                                 valid, cs.shape[1:], cs.row_cap)


def subm_rulebook_bitmap(cs: ColumnSet, vcol: torch.Tensor, vz: torch.Tensor,
                         vmask: torch.Tensor) -> torch.Tensor:
    """Submanifold 3x3x3 rulebook (B, V, 27) int32 of global feature rows,
    in plain PyTorch through the sorted column keys: the reference that the
    eq-match kernel's output must equal."""
    yx = _column_yx(cs, vcol)
    return _query(cs, yx[..., 0] - 1, yx[..., 1] - 1, vz - 1, vmask)


def subm_rulebook_eqmatch(cs: ColumnSet, coords: torch.Tensor,
                          vmask: torch.Tensor) -> torch.Tensor:
    """subm_rulebook_bitmap through the eq-match kernel (identical output);
    coords (B, V, 3) int64 zyx and vmask (B, V) bool of the plan-major
    voxels are the queries, as they are."""
    return eqmatch_rulebook(cs, coords, vmask)


def _expand_sites(bits: torch.Tensor, out_cap: int, ccoords: torch.Tensor):
    """Per-column z words (B, P) -> plan-major sites (B, M = out_cap):
    (vcol, vz, vm, vyx, start_local).  Site rows are the columns' set bits
    in column order then z order; rows past out_cap are dropped."""
    b, p = bits.shape
    dev = bits.device
    counts = popcount64(bits)
    ends = torch.cumsum(counts, dim=1)
    start_local = ends - counts
    r = torch.arange(out_cap, device=dev).expand(b, out_cap).contiguous()
    c = torch.searchsorted(ends, r, right=True).clamp_max(p - 1)
    vm = r < ends[:, -1:]
    k = r - torch.gather(start_local, 1, c)
    vz = torch.where(vm, select_bit(torch.gather(bits, 1, c), k.clamp_min(0)),
                     0)
    gb = torch.arange(b, device=dev)[:, None]
    vcol = torch.where(vm, c + gb * p, b * p)
    yx = torch.gather(ccoords, 1, c[..., None].expand(b, out_cap, 2))
    vyx = torch.where(vm[..., None], yx, 0)
    return vcol, vz, vm, vyx, start_local


def strided_downsample_bitmap(cs: ColumnSet, padding: Tuple[int, int, int],
                              out_cap: int):
    """Sites and rulebook of a kernel-3 stride-2 sparse conv.

    An output site exists iff its receptive field touches an input voxel
    (spconv semantics).  Returns (cs_out, vcol, vz, vmask (B, M),
    gidx (B, M, 27) int32, vyx (B, M, 2)) with M = out_cap."""
    b, p = cs.cmask.shape
    d, h, w = cs.shape
    dev = cs.cmask.device
    pz, py, px = padding
    od = (d + 2 * pz - 3) // 2 + 1
    oh = (h + 2 * py - 3) // 2 + 1
    ow = (w + 2 * px - 3) // 2 + 1
    if od <= 0 or oh <= 0 or ow <= 0 or od > 32:
        raise ValueError("bitmap strided conv needs 0 < out depth <= 32")
    gb = torch.arange(b, device=dev)[:, None]

    # a column whose decimated z bits are empty reaches no output site
    dlo = decimate_bits(cs.bits, pz, od)
    emits = cs.cmask & (dlo != 0)

    # output columns: the <= 2x2 output cells each emitting column reaches
    y, x = cs.ccoords[..., 0], cs.ccoords[..., 1]
    ylo, yhi = -((2 - y - py) // 2), (y + py) // 2
    xlo, xhi = -((2 - x - px) // 2), (x + px) // 2
    ohw = oh * ow
    occ = torch.zeros(b * ohw + 1, dtype=torch.bool, device=dev)
    for iy in range(2):
        for ix in range(2):
            cy, cx = ylo + iy, xlo + ix
            ok = ((cy <= yhi) & (cx <= xhi) & (cy >= 0) & (cx >= 0) &
                  (cy < oh) & (cx < ow) & emits)
            occ[torch.where(ok, cy * ow + cx + gb * ohw, b * ohw)] = True
            profiling.count("host_sync")
    occ = occ[:-1].reshape(b, ohw)
    rank = torch.cumsum(occ.to(torch.int64), 1) - 1
    keep = occ & (rank < out_cap)
    cell = torch.arange(ohw, device=dev).expand(b, ohw)
    trash = b * (out_cap + 1) - 1
    slot = torch.where(keep, rank + gb * (out_cap + 1), trash).reshape(-1)
    cc_o = torch.zeros(b * (out_cap + 1), 2, dtype=torch.int64, device=dev)
    cc_o[slot] = torch.stack([cell // ow, cell % ow], -1).reshape(-1, 2)
    cm_o = torch.zeros(b * (out_cap + 1), dtype=torch.bool, device=dev)
    cm_o[slot] = True
    profiling.count("host_sync")
    cc_o = cc_o.reshape(b, out_cap + 1, 2)[:, :out_cap]
    cm_o = cm_o.reshape(b, out_cap + 1)[:, :out_cap]
    cc_o = torch.where(cm_o[..., None], cc_o, 0)

    # output z words: OR of the 3x3 input neighbours' decimated words, read
    # from a dense padded plan image of them
    h2, w2 = h + 2 * py, w + 2 * px
    dense = torch.zeros(b * h2 * w2 + 1, dtype=torch.int64, device=dev)
    didx = torch.where(emits, (gb * h2 + y + py) * w2 + x + px, b * h2 * w2)
    dense[didx.reshape(-1)] = dlo.reshape(-1)
    oy, ox = cc_o[..., 0], cc_o[..., 1]
    olo = torch.zeros_like(oy)
    for g in range(3):
        for dx in range(3):
            olo |= dense[(gb * h2 + 2 * oy + g) * w2 + 2 * ox + dx]
    olo = torch.where(cm_o, olo, 0)

    vcol_o, vz_o, vm_o, vyx_o, start_local = _expand_sites(olo, out_cap,
                                                           cc_o)
    cs_out = ColumnSet(ccoords=cc_o, cmask=cm_o,
                       cstart=start_local + gb * out_cap, bits=olo,
                       shape=(od, oh, ow), row_cap=out_cap)
    gidx = strided_rulebook_bitmap(cs, vyx_o, vz_o, vm_o, padding)
    return cs_out, vcol_o, vz_o, vm_o, gidx, vyx_o


def strided_rulebook_bitmap(cs_in: ColumnSet, vyx_out: torch.Tensor,
                            vz_out: torch.Tensor, vmask_out: torch.Tensor,
                            padding: Tuple[int, int, int]) -> torch.Tensor:
    """(B, M, 27) int32 input rows of a kernel-3 stride-2 conv: output site
    (z, y, x) reads input cells 2 * (z, y, x) - pad + {0, 1, 2}^3."""
    pz, py, px = padding
    return _query(cs_in, 2 * vyx_out[..., 0] - py, 2 * vyx_out[..., 1] - px,
                  2 * vz_out - pz, vmask_out)


def convout_sites_bitmap(cs: ColumnSet, out_cap: int):
    """Sites of the (3,1,1) / (2,1,1) / pad-0 conv_out (z-only stride):
    (cs_out, vcol (B, M), vz (B, M), vmask (B, M)); the output columns keep
    the input's column slots."""
    b, p = cs.cmask.shape
    d, h, w = cs.shape
    od = (d - 3) // 2 + 1
    if od <= 0 or od > 32:
        raise ValueError("bitmap conv_out needs 0 < out depth <= 32")
    olo = torch.where(cs.cmask, decimate_bits(cs.bits, 0, od), 0)
    vcol_o, vz_o, vm_o, _, start_local = _expand_sites(olo, out_cap,
                                                       cs.ccoords)
    gb = torch.arange(b, device=olo.device)[:, None]
    cs_out = ColumnSet(ccoords=cs.ccoords, cmask=cs.cmask & (olo != 0),
                       cstart=start_local + gb * out_cap, bits=olo,
                       shape=(od, h, w), row_cap=out_cap)
    return cs_out, vcol_o, vz_o, vm_o


def convout_rulebook_bitmap(cs_in: ColumnSet, vcol_out: torch.Tensor,
                            vz_out: torch.Tensor, vmask_out: torch.Tensor
                            ) -> torch.Tensor:
    """(B, M, 3) int32 rulebook of the z-only conv_out: input rows at
    z = 2 * oz + dz within the site's own column."""
    b, p = cs_in.cmask.shape
    dev = vcol_out.device
    row_cap = cs_in.row_cap
    miss = b * row_cap
    word = torch.cat([cs_in.bits.reshape(-1), cs_in.bits.new_zeros(1)])[
        vcol_out][..., None]
    start = torch.cat([cs_in.cstart.reshape(-1),
                       cs_in.cstart.new_zeros(1)])[vcol_out][..., None]
    z = 2 * vz_out[..., None] + torch.arange(3, device=dev)
    row = start + popcount64(word & mask_below(z))
    local = row - torch.arange(b, device=dev)[:, None, None] * row_cap
    ok = (bit_get(word, z) & (local >= 0) & (local < row_cap) &
          vmask_out[..., None])
    return torch.where(ok, row, miss).to(torch.int32)


def dense_bev_coords(cs: ColumnSet, vcol: torch.Tensor,
                     vz: torch.Tensor) -> torch.Tensor:
    """(B, M, 3) zyx coords of a stage's sites, for the dense scatter."""
    return torch.cat([vz[..., None], _column_yx(cs, vcol)], -1)
