"""Sparse-conv apply over a batched rulebook, the dense scatter, and the
table rulebooks.

The table rulebooks (JAX `ops/sparse_conv.py`, the encoder's 'table'
backend) key every site by its z-major cell, key = (z * H + y) * W + x, and
find a neighbour's global feature row by looking its key up in a sorted key
table (K6, ops/rulebook_lookup.py).  Samples fold into one table by a shift
of cells + 1 per sample, so a sample's masked rows (key = cells) sort after
its sites and before the next sample's.  The miss row is B * V.  On the card
a key table also holds the hash table of its keys, built once and probed by
each of its lookups.

A strided conv's output sites follow spconv: a site exists iff its
receptive field touches an input site; each input voxel emits its
candidate outputs, and the unique ones fill the capacity in key order (the
smallest keys stay on overflow), valid sites first.

The JAX package offers several lookup strategies for the same integers (a
dense cell table, sliced gathers, searchsorted variants); the port has the
general one: neighbour keys, then the lookup.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from .gather_conv import gather_conv
from .gather_conv_bwd import strided_conv_bwd, subm_conv_bwd
from .rulebook_lookup import KeyHash, key_hash, rulebook_lookup


class GatheredConv(torch.autograd.Function):
    """The gather-GEMM with its backward: the forward is K1; the backward
    is K3 for a subm rulebook (symmetric, M == N) and K4 otherwise, as the
    JAX package's `_onehot_conv_subm` / `_onehot_conv` custom VJPs pick
    them.  The kernels' outputs carry no graph of their own, so this
    Function is what gives the encoder's weights their gradients.  feats
    and weights share one dtype, float32 or bfloat16 (the bf16 model casts
    its float32 kernels before this Function, so dW comes back rounded to
    bfloat16 and reaches the parameter through the cast, as in JAX)."""

    @staticmethod
    def forward(ctx, feats, idx, weights, subm: bool):
        ctx.save_for_backward(feats, idx, weights)
        ctx.subm = subm
        return gather_conv(feats, idx, weights)

    @staticmethod
    def backward(ctx, g):
        feats, idx, weights = ctx.saved_tensors
        bwd = subm_conv_bwd if ctx.subm else strided_conv_bwd
        dfeats, dw = bwd(feats, idx, weights, g.contiguous(),
                         need_dfeats=ctx.needs_input_grad[0])
        return dfeats, None, dw, None


def gathered_conv_apply_batched(features: torch.Tensor,
                                gather_idx: torch.Tensor,
                                weights: torch.Tensor,
                                subm: bool = False) -> torch.Tensor:
    """features (B, V, Cin), gather_idx (B, M, K) int32 GLOBAL flat rows
    (B * V is the miss row), weights (K, Cin, Cout) -> (B, M, Cout).

    subm: the rulebook is a submanifold one (M == V, symmetric neighbour
    relation), which selects the symmetric backward."""
    b, v, cin = features.shape
    _, m, k = gather_idx.shape
    out = GatheredConv.apply(features.reshape(b * v, cin).contiguous(),
                             gather_idx.reshape(b * m, k).contiguous(),
                             weights.contiguous(), subm and m == v)
    return out.reshape(b, m, -1)


def sparse_to_dense_batched(features: torch.Tensor, coords: torch.Tensor,
                            mask: torch.Tensor,
                            shape: Tuple[int, int, int]) -> torch.Tensor:
    """(B, V, C) sites at (B, V, 3) zyx coords -> (B, D, H, W, C) canvas."""
    d, h, w = shape
    b, v, c = features.shape
    cells = d * h * w
    flat = (coords[..., 0] * h + coords[..., 1]) * w + coords[..., 2]
    offs = torch.arange(b, device=features.device)[:, None] * cells
    flat = torch.where(mask, flat + offs, b * cells)
    canvas = features.new_zeros(b * cells + 1, c)
    canvas[flat.reshape(-1)] = features.reshape(-1, c)
    return canvas[:-1].reshape(b, d, h, w, c)


def _key(coords: torch.Tensor, shape, mask: torch.Tensor) -> torch.Tensor:
    """(..., 3) zyx coords -> z-major cell keys; masked rows get `cells`."""
    d, h, w = shape
    k = (coords[..., 0] * h + coords[..., 1]) * w + coords[..., 2]
    return torch.where(mask, k, d * h * w)


def _decode_key(key: torch.Tensor, shape) -> torch.Tensor:
    _, h, w = shape
    z = key // (h * w)
    rem = key % (h * w)
    return torch.stack([z, rem // w, rem % w], dim=-1)


def _offsets(kernel: Tuple[int, int, int], device) -> torch.Tensor:
    """(K, 3) kernel offsets, z-major."""
    kz, ky, kx = kernel
    oz, oy, ox = torch.meshgrid(torch.arange(kz, device=device),
                                torch.arange(ky, device=device),
                                torch.arange(kx, device=device),
                                indexing="ij")
    return torch.stack([oz.reshape(-1), oy.reshape(-1), ox.reshape(-1)], -1)


def conv_out_shape(in_shape, kernel, stride, padding) -> Tuple[int, int, int]:
    """Dense output shape of a (sparse) conv, clamped at 0."""
    return tuple(
        max((i + 2 * p - k) // s + 1, 0)
        for i, k, s, p in zip(in_shape, kernel, stride, padding))


def generate_output_sites(coords: torch.Tensor, mask: torch.Tensor, shape,
                          kernel: Tuple[int, int, int],
                          stride: Tuple[int, int, int],
                          padding: Tuple[int, int, int], out_capacity: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Active output sites of a strided sparse conv, per sample: (B, V, 3)
    coords and (B, V) mask -> ((B, cap, 3) key-sorted coords, (B, cap)
    mask); invalid sites sit at each sample's tail with coords 0."""
    out_shape = conv_out_shape(shape, kernel, stride, padding)
    _, oh, ow = out_shape
    sentinel = math.prod(out_shape)
    b = coords.shape[0]
    cands, valids = [], []
    for dim in range(3):
        i = coords[..., dim]
        p, k, s = padding[dim], kernel[dim], stride[dim]
        lo = -((k - 1 - i - p) // s)             # ceil((i + p - (k-1)) / s)
        hi = (i + p) // s
        c = lo[..., None] + torch.arange(-(-k // s), device=coords.device)
        cands.append(c)
        valids.append((c <= hi[..., None]) & (c >= 0) &
                      (c < out_shape[dim]) & mask[..., None])
    cz, cy, cx = (cands[0][..., :, None, None], cands[1][..., None, :, None],
                  cands[2][..., None, None, :])
    valid = (valids[0][..., :, None, None] & valids[1][..., None, :, None] &
             valids[2][..., None, None, :])
    keys = torch.where(valid, (cz * oh + cy) * ow + cx, sentinel)
    skey = torch.sort(keys.reshape(b, -1), dim=1).values
    head = torch.ones_like(skey, dtype=torch.bool)
    head[:, 1:] = skey[:, 1:] != skey[:, :-1]
    head &= skey < sentinel
    slot = torch.cumsum(head.to(torch.int64), 1) - 1
    slot = torch.where(head & (slot < out_capacity), slot, out_capacity)
    out = skey.new_full((b, out_capacity + 1), sentinel)
    out.scatter_(1, slot, skey)
    out_keys = out[:, :out_capacity]
    out_mask = out_keys < sentinel
    return _decode_key(torch.where(out_mask, out_keys, 0), out_shape), out_mask


@dataclasses.dataclass
class KeyTable:
    """The sample-folded sorted keys of one stage's sites and the global
    feature row of each key; queries at or above `sentinel` are invalid.
    On the card `hashed` is the hash table of the keys (None on the CPU)."""
    keys: torch.Tensor      # (B * V,) int64 ascending
    rows: torch.Tensor      # (B * V,) int32
    cells: int              # cells of one sample's grid
    sentinel: int           # B * (cells + 1)
    hashed: Optional[KeyHash]


def make_key_table(coords: torch.Tensor, mask: torch.Tensor, shape,
                   in_key_order: bool = False) -> KeyTable:
    """The key table of (B, V, 3) sites.  Rows in any order are sorted once
    (one stable sort; its permutation gives each key's row).  Sites that
    are already in key order per sample, with the masked rows at each
    sample's tail (what generate_output_sites emits), skip the sort.  On
    the card the keys are hashed here, once for all the table's lookups."""
    b, v = mask.shape
    cells = math.prod(shape)
    shift = cells + 1
    offs = torch.arange(b, device=coords.device)[:, None] * shift
    keys = (_key(coords, shape, mask) + offs).reshape(-1)
    if in_key_order:
        rows = torch.arange(b * v, dtype=torch.int32, device=coords.device)
    else:
        keys, order = torch.sort(keys, stable=True)
        rows = order.to(torch.int32)
    sentinel = b * shift
    return KeyTable(keys, rows, cells, sentinel,
                    key_hash(keys, rows, sentinel))


def lookup_rows(table: KeyTable, queries: torch.Tensor) -> torch.Tensor:
    """(B, Q, K) per-sample query keys (>= cells marks an invalid one) ->
    (B, Q, K) int32 global feature rows, B * V the miss row."""
    b, q, k = queries.shape
    offs = torch.arange(b, device=queries.device)[:, None, None] * (
        table.cells + 1)
    gq = torch.where(queries < table.cells, queries + offs, table.sentinel)
    return rulebook_lookup(table.keys, table.rows, gq.reshape(b * q, k),
                           table.sentinel, table.hashed).reshape(b, q, k)


def subm_gather_indices_batched(coords: torch.Tensor, mask: torch.Tensor,
                                shape, kernel: int = 3,
                                key_table: Optional[KeyTable] = None
                                ) -> torch.Tensor:
    """Submanifold rulebook: (B, V, 3) coords in any order, (B, V) mask ->
    (B, V, K) int32 global rows into the (B * V + 1)-row features."""
    d, h, w = shape
    offs = _offsets((kernel,) * 3, coords.device) - kernel // 2
    nc = coords[:, :, None, :] + offs                          # (B, V, K, 3)
    in_rng = ((nc >= 0).all(-1) & (nc[..., 0] < d) & (nc[..., 1] < h) &
              (nc[..., 2] < w))
    nk = torch.where(in_rng & mask[:, :, None],
                     (nc[..., 0] * h + nc[..., 1]) * w + nc[..., 2], d * h * w)
    if key_table is None:
        key_table = make_key_table(coords, mask, shape)
    return lookup_rows(key_table, nk)


def strided_gather_indices_batched(coords: torch.Tensor, mask: torch.Tensor,
                                   shape, out_coords: torch.Tensor,
                                   out_mask: torch.Tensor,
                                   kernel: Tuple[int, int, int],
                                   stride: Tuple[int, int, int],
                                   padding: Tuple[int, int, int],
                                   key_table: Optional[KeyTable] = None
                                   ) -> torch.Tensor:
    """Strided-conv rulebook: (B, M, K) int32 global rows into the
    (B * V + 1)-row input features; output site o reads input o * s - p + k
    at kernel offset k."""
    d, h, w = shape
    dev = coords.device
    offs = _offsets(kernel, dev)
    st = torch.tensor(stride, device=dev)
    pd = torch.tensor(padding, device=dev)
    ic = out_coords[:, :, None, :] * st - pd + offs            # (B, M, K, 3)
    in_rng = ((ic >= 0).all(-1) & (ic[..., 0] < d) & (ic[..., 1] < h) &
              (ic[..., 2] < w))
    ik = torch.where(in_rng & out_mask[:, :, None],
                     (ic[..., 0] * h + ic[..., 1]) * w + ic[..., 2], d * h * w)
    if key_table is None:
        key_table = make_key_table(coords, mask, shape)
    return lookup_rows(key_table, ik)
