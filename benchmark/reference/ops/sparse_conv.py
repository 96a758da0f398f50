"""Sparse-conv apply over a batched rulebook (the plain gather-GEMM),
the dense scatter, and a strided conv's output sites: a site exists iff its
receptive field touches an input site; the unique ones fill the capacity
in key order (the smallest keys stay on overflow), valid sites first."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .gather_conv import gather_conv_plain


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
    out = gather_conv_plain(features.reshape(b * v, cin),
                            gather_idx.reshape(b * m, k), weights)
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
