"""Column-query rulebooks: the eq-match kernel (K2) and its plain version.

Replaces the JAX package's Pallas kernel
`ops/pallas_eqmatch.py::eqmatch_rulebook` (kernel body `_eqmatch_kernel`).
For each query row q with base cell (zb, yb, xb) and each of the 27 taps
(dz, dy, dx) in {0, 1, 2}^3, z-major, the result is the global feature row
of voxel (zb + dz, yb + dy, xb + dx):

    key  = b * (H*W + 1) + y * W + x      (found in the sorted column keys)
    row  = column start + popcount(z word & bits below z)

or the miss row B * row_cap when the cell is out of the plan, its column or
z bit is absent, the row lies past the stage capacity, or the query row is
invalid.  A submanifold rulebook queries each voxel at (z-1, y-1, x-1); a
stride-2 one queries each output site at 2 * (z, y, x) - pad.

The TPU kernel windows the sorted keys because Mosaic has no dynamic gather;
the CUDA kernel binary-searches the whole key array, so it needs no window
and no fallback.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import cuda_build

# kernel launches since the last reset (chip_smoke.py reads it)
launches = 0

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# keys, words, starts, N, ybase, xbase, zbase, valid, Q, B, H, W, row_cap,
# out, stream
_SIGNATURES = {"eqmatch_rulebook": [_P, _P, _P, _LL, _P, _P, _P, _P, _I, _I,
                                    _I, _I, _I, _P, _P]}


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


def column_rulebook_plain(keys: torch.Tensor, words: torch.Tensor,
                          starts: torch.Tensor, ybase: torch.Tensor,
                          xbase: torch.Tensor, zbase: torch.Tensor,
                          valid: torch.Tensor, hw: Tuple[int, int],
                          row_cap: int) -> torch.Tensor:
    """Plain PyTorch version.  keys/words/starts (N,) int64 column tables
    (keys ascending), bases and valid (B, Q) -> (B, Q, 27) int32."""
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
    present = (z >= 0) & (z < 64) & (((word >> z.clamp(0, 63)) & 1) != 0)
    row = starts[pos] + popcount64(word & mask_below(z))
    local = row - gb * row_cap
    ok = (found & present & (local >= 0) & (local < row_cap) &
          valid.bool()[..., None])
    return torch.where(ok, row, b * row_cap).to(torch.int32)


def eqmatch_rulebook(keys: torch.Tensor, words: torch.Tensor,
                     starts: torch.Tensor, ybase: torch.Tensor,
                     xbase: torch.Tensor, zbase: torch.Tensor,
                     valid: torch.Tensor, hw: Tuple[int, int],
                     row_cap: int) -> torch.Tensor:
    """The column-query rulebook: the CUDA kernel for tensors on the card,
    the plain version for tensors on the CPU."""
    if keys.device.type == "cpu":
        return column_rulebook_plain(keys, words, starts, ybase, xbase,
                                     zbase, valid, hw, row_cap)
    if keys.device.type != "cuda":
        raise RuntimeError(f"eqmatch_rulebook: no kernel for {keys.device}")
    global launches
    b, q = ybase.shape
    h, w = hw
    n = keys.numel()
    dev = keys.device
    for name, t in (("words", words), ("starts", starts)):
        if t.dtype != torch.int64 or t.shape != (n,) or t.device != dev:
            raise ValueError(f"eqmatch_rulebook: {name} must be ({n},) "
                             f"int64 on {dev}")
    if keys.dtype != torch.int64 or keys.dim() != 1:
        raise ValueError("eqmatch_rulebook: keys must be 1-D int64")
    if b * row_cap >= 2 ** 31 or b * (h * w + 1) >= 2 ** 62:
        raise ValueError("eqmatch_rulebook: rows must fit int32")
    if n == 0:
        raise ValueError("eqmatch_rulebook: empty column table")
    for name, t in (("keys", keys), ("words", words), ("starts", starts)):
        if not t.is_contiguous():
            raise ValueError(f"eqmatch_rulebook: {name} must be contiguous")
    for name, t in (("ybase", ybase), ("xbase", xbase), ("zbase", zbase),
                    ("valid", valid)):
        if t.shape != (b, q) or t.device != dev:
            raise ValueError(f"eqmatch_rulebook: {name} must be ({b}, {q}) "
                             f"on {dev}")
    # the kernel reads int32 bases and uint8 flags
    yb, xb, zb = (t.to(torch.int32).contiguous()
                  for t in (ybase, xbase, zbase))
    vq = valid.to(torch.uint8).contiguous()
    out = torch.empty(b, q, 27, dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    lib = cuda_build.load_library("eqmatch", _SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.eqmatch_rulebook(
            keys.data_ptr(), words.data_ptr(), starts.data_ptr(), n,
            yb.data_ptr(), xb.data_ptr(), zb.data_ptr(), vq.data_ptr(), q, b,
            h, w, row_cap, out.data_ptr(), stream)
    cuda_build.check(lib, rc, "eqmatch_rulebook")
    launches += 1
    return out
