"""GridMask image augmentation, per image (JAX `models/grid_mask.py`,
reference models/utils/grid_mask.py with use_h = use_w = True, rotate 1,
offset False, mode 1, ratio 0.5, prob 0.7; srfdet.py:47).

Split in two: `grid_mask_draws` draws each image's parameters from the
caller's `torch.Generator`, and `apply_grid_mask` masks the images with
them.  Mode 1 keeps the stripes: a pixel stays when its row or its column
lies in the first `l` of each period `d` from the image's phase, and an
image the draw does not apply to stays whole.  The JAX package draws from
its own rng stream, so the two packages' draws differ bit for bit; the
mask function is the same.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class GridMaskDraws(NamedTuple):
    """One value per image, each (n,): apply (bool), the period d, the
    kept stripe width l, and the row and column phases st_h, st_w (all
    int64)."""
    apply: torch.Tensor
    d: torch.Tensor
    l: torch.Tensor
    st_h: torch.Tensor
    st_w: torch.Tensor


def grid_mask_draws(n: int, h: int, generator: torch.Generator,
                    prob: float = 0.7, ratio: float = 0.5) -> GridMaskDraws:
    """The draws of n images of height h, in this order: apply = U(0, 1) <
    prob; d in [2, max(h, 3)) (the bound is the height alone, as in JAX);
    l = clip(int(d * ratio + 0.5), 1, d - 1); the phases randint(0, 2**30)
    % d.  On the generator's device."""
    dev = generator.device
    apply = torch.rand(n, generator=generator, device=dev) < prob
    d = torch.randint(2, max(h, 3), (n,), generator=generator, device=dev)
    l = (d * ratio + 0.5).long().clamp(min=1)
    l = torch.minimum(l, d - 1)
    st_h = torch.randint(0, 1 << 30, (n,), generator=generator,
                         device=dev) % d
    st_w = torch.randint(0, 1 << 30, (n,), generator=generator,
                         device=dev) % d
    return GridMaskDraws(apply, d, l, st_h, st_w)


def apply_grid_mask(images: torch.Tensor, draws: GridMaskDraws
                    ) -> torch.Tensor:
    """(n, C, H, W) images -> the images with GridMask's zeros:
    keep = in_h | in_w | ~apply."""
    h, w = images.shape[-2:]
    dev = images.device
    d, l = draws.d[:, None], draws.l[:, None]
    ys = torch.arange(h, device=dev)[None]
    xs = torch.arange(w, device=dev)[None]
    in_h = torch.remainder(ys - draws.st_h[:, None], d) < l       # (n, H)
    in_w = torch.remainder(xs - draws.st_w[:, None], d) < l       # (n, W)
    keep = in_h[:, :, None] | in_w[:, None, :] | \
        ~draws.apply[:, None, None]
    return images * keep[:, None].to(images.dtype)


def grid_mask(images: torch.Tensor, generator: torch.Generator,
              prob: float = 0.7, ratio: float = 0.5) -> torch.Tensor:
    """Draw and apply: (n, C, H, W) images, one mask an image."""
    draws = grid_mask_draws(images.shape[0], images.shape[-2], generator,
                            prob, ratio)
    return apply_grid_mask(images, draws)
