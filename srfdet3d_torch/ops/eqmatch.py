"""Column-query rulebooks: the eq-match kernel (K2) and its plain version.

Replaces the JAX package's Pallas kernel
`ops/pallas_eqmatch.py::eqmatch_rulebook` (kernel body `_eqmatch_kernel`).
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

The plan map (B * H * W,) int32 holds each plan cell's global column slot
b * P + p, or the miss slot B * P: the JAX package's `plan_table`.  The
kernel builds it on each call (a fill and a scatter), then runs one thread
per (query, plan column (dy, dx)): one map load and one column load answer
3 taps.  The plain version below does the same arithmetic in PyTorch.

The wrappers call the registered ops `srfdet::eqmatch_rulebook` (the plan
map and the query in one call) and `srfdet::plan_map`: their CPU
implementations are the plain versions, their CUDA ones the launches, and
their fakes give the output shapes to `torch.export`.  A ColumnSet goes in
as its four tensors (strided column views too), its shape and its row
capacity.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from . import cuda_build
from ..utils import profiling

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    # ccoords, cmask, their sample strides, B, P, H, W, map, stream
    "plan_map": [_P, _P, _LL, _LL, _I, _I, _I, _I, _P, _P],
    # ccoords, cmask, bits, cstart and their sample strides, coords, valid,
    # Q, B, P, H, W, row_cap, scale, offset z, y, x, map, out, stream
    "eqmatch_rulebook": [_P, _P, _LL, _LL, _P, _P, _LL, _LL, _P, _P, _I, _I,
                         _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
}
_lib = None

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


def _kernels():
    global _lib
    if _lib is None:
        _lib = cuda_build.load_library("eqmatch", _SIGNATURES)
    return _lib


def _sample_stride(t: torch.Tensor, shape, inner: int, name: str) -> int:
    """The sample stride (elements) of a (B, P[, 2]) column array whose
    columns lie `inner` elements apart and whose last axis is dense."""
    if t.shape != shape or t.stride(1) != inner or (
            t.dim() == 3 and t.stride(2) != 1) or (
            shape[0] > 1 and t.stride(0) < shape[1] * inner):
        raise ValueError(f"eqmatch_rulebook: {name} must be a {shape} view "
                         f"with dense columns")
    return t.stride(0)


def _columns(cs, dev: torch.device):
    """Check a ColumnSet's arrays for the kernels: (ccoords, cmask, bits,
    cstart) with their sample strides, as the C entries take them."""
    b, p = cs.cmask.shape
    _, h, w = cs.shape
    args = []
    for name, t, dtype, shape, inner in (
            ("ccoords", cs.ccoords, torch.int64, (b, p, 2), 2),
            ("cmask", cs.cmask, torch.bool, (b, p), 1),
            ("bits", cs.bits, torch.int64, (b, p), 1),
            ("cstart", cs.cstart, torch.int64, (b, p), 1)):
        if t.dtype != dtype or t.device != dev:
            raise ValueError(f"eqmatch_rulebook: {name} must be {dtype} on "
                             f"{dev}")
        args.append((t.data_ptr(), _sample_stride(t, shape, inner, name)))
    if b * p >= 2 ** 31 or b * h * w >= 2 ** 31:
        raise ValueError("eqmatch_rulebook: slots and cells must fit int32")
    return args


def _column_set(ccoords, cmask, cstart, bits, shape, row_cap):
    """The ColumnSet of an op's arguments, for the plain versions."""
    from .bitmap_rulebook import ColumnSet  # it imports this module
    return ColumnSet(ccoords, cmask, cstart, bits, tuple(shape), row_cap)


def plan_map(cs) -> torch.Tensor:
    """The plan map of a ColumnSet: the fill and scatter kernels for
    tensors on the card, the plain version for tensors on the CPU, through
    the op `srfdet::plan_map`.  The eq-match wrapper builds its own; this
    one serves checks and timing."""
    cuda_build.check_device("plan_map", cs.cmask.device)
    return plan_map_op(cs.ccoords, cs.cmask, list(cs.shape))


@torch.library.custom_op("srfdet::plan_map", mutates_args=(),
                         device_types="cpu")
def plan_map_op(ccoords: torch.Tensor, cmask: torch.Tensor,
                shape: List[int]) -> torch.Tensor:
    """The op's CPU implementation: the plain version."""
    return plan_map_plain(_column_set(ccoords, cmask, None, None, shape, 0))


@plan_map_op.register_fake
def _plan_map_fake(ccoords, cmask, shape):
    _, h, w = shape
    return cmask.new_empty(cmask.shape[0] * h * w, dtype=torch.int32)


@plan_map_op.register_kernel("cuda")
def _plan_map_cuda(ccoords: torch.Tensor, cmask: torch.Tensor,
                   shape: List[int]) -> torch.Tensor:
    """The op's CUDA implementation: the fill and scatter kernels."""
    dev = cmask.device
    b, p = cmask.shape
    _, h, w = shape
    if b * p >= 2 ** 31 or b * h * w >= 2 ** 31:
        raise ValueError("plan_map: slots and cells must fit int32")
    for name, t, dtype in (("ccoords", ccoords, torch.int64),
                           ("cmask", cmask, torch.bool)):
        if t.dtype != dtype or t.device != dev:
            raise ValueError(f"plan_map: {name} must be {dtype} on {dev}")
    s_cc = _sample_stride(ccoords, (b, p, 2), 2, "ccoords")
    s_cm = _sample_stride(cmask, (b, p), 1, "cmask")
    pmap = torch.empty(b * h * w, dtype=torch.int32, device=dev)
    lib = _kernels()
    with torch.cuda.device(dev):
        rc = lib.plan_map(ccoords.data_ptr(), cmask.data_ptr(), s_cc, s_cm,
                          b, p, h, w, pmap.data_ptr(),
                          torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(lib, rc, "plan_map")
    return pmap


def eqmatch_rulebook(cs, coords: torch.Tensor, valid: torch.Tensor,
                     scale: int = 1,
                     offset: Tuple[int, int, int] = (1, 1, 1)
                     ) -> torch.Tensor:
    """The column-query rulebook (B, Q, 27) int32 of a ColumnSet `cs` at
    queries coords (B, Q, 3) int64 zyx and valid (B, Q) bool: the plan map
    and the query kernel, in one call, for tensors on the card, the plain
    version for tensors on the CPU, through the op
    `srfdet::eqmatch_rulebook` (the ColumnSet goes in as its four tensors,
    its shape and row capacity)."""
    cuda_build.check_device("eqmatch_rulebook", coords.device)
    return eqmatch_rulebook_op(cs.ccoords, cs.cmask, cs.bits, cs.cstart,
                               coords, valid, list(cs.shape), cs.row_cap,
                               scale, list(offset))


@torch.library.custom_op("srfdet::eqmatch_rulebook", mutates_args=(),
                         device_types="cpu")
def eqmatch_rulebook_op(ccoords: torch.Tensor, cmask: torch.Tensor,
                        bits: torch.Tensor, cstart: torch.Tensor,
                        coords: torch.Tensor, valid: torch.Tensor,
                        shape: List[int], row_cap: int, scale: int,
                        offset: List[int]) -> torch.Tensor:
    """The op's CPU implementation: the plain version."""
    cs = _column_set(ccoords, cmask, cstart, bits, shape, row_cap)
    return column_query_plain(cs, plan_map_plain(cs), coords, valid, scale,
                              tuple(offset))


@eqmatch_rulebook_op.register_fake
def _eqmatch_rulebook_fake(ccoords, cmask, bits, cstart, coords, valid,
                           shape, row_cap, scale, offset):
    b, q, _ = coords.shape
    return coords.new_empty(b, q, 27, dtype=torch.int32)


@eqmatch_rulebook_op.register_kernel("cuda")
def _eqmatch_rulebook_cuda(ccoords: torch.Tensor, cmask: torch.Tensor,
                           bits: torch.Tensor, cstart: torch.Tensor,
                           coords: torch.Tensor, valid: torch.Tensor,
                           shape: List[int], row_cap: int, scale: int,
                           offset: List[int]) -> torch.Tensor:
    """The op's CUDA implementation: checks the arguments, builds the plan
    map, launches the query kernel and counts both (counters
    `eqmatch.map_builds`, `eqmatch.launches`, in eager and in an exported
    program alike)."""
    cs = _column_set(ccoords, cmask, cstart, bits, shape, row_cap)
    dev = coords.device
    b, q, _ = coords.shape
    p = cs.cmask.shape[1]
    _, h, w = cs.shape
    if coords.dtype != torch.int64 or coords.shape != (b, q, 3):
        raise ValueError("eqmatch_rulebook: coords must be (B, Q, 3) int64")
    if valid.dtype != torch.bool or valid.shape != (b, q) or \
            valid.device != dev:
        raise ValueError(f"eqmatch_rulebook: valid must be ({b}, {q}) bool "
                         f"on {dev}")
    if cs.cmask.shape[0] != b:
        raise ValueError("eqmatch_rulebook: queries and columns must share B")
    if b * cs.row_cap >= 2 ** 31 or b * q >= 2 ** 31:
        raise ValueError("eqmatch_rulebook: rows and queries must fit int32")
    (cc, s_cc), (cm, s_cm), (bits_p, s_bits), (cst, s_st) = \
        _columns(cs, dev)
    coords, valid = coords.contiguous(), valid.contiguous()
    out = torch.empty(b, q, 27, dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    pmap = torch.empty(b * h * w, dtype=torch.int32, device=dev)
    oz, oy, ox = offset
    lib = _kernels()
    with torch.cuda.device(dev):
        rc = lib.eqmatch_rulebook(
            cc, cm, s_cc, s_cm, bits_p, cst, s_bits, s_st,
            coords.data_ptr(), valid.data_ptr(), q, b, p, h, w, cs.row_cap,
            scale, oz, oy, ox, pmap.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(lib, rc, "eqmatch_rulebook")
    profiling.count("eqmatch.map_builds")
    profiling.count("eqmatch.launches")
    return out
