"""GridMask (srfdet3d_torch/models/grid_mask.py) against the JAX package's
`models/grid_mask.py`, on the CPU.  The port draws from a torch.Generator
and JAX from its own key, so the draws differ bit for bit: the mask
function is held exactly on the draws JAX makes (replayed here from
`jax.random.split(rng, 4)` as `grid_mask.py:36-41` does), and the port's
draws by their ranges and the apply rate.  Then the detector's use of it:
on the flattened (B*n_cam) images before the backbone, drawn from
`forward`'s generator before the head's dropout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srfdet3d_tpu.models.grid_mask import grid_mask as j_grid_mask
from srfdet3d_torch.configs import tiny_lc_test_config
from srfdet3d_torch.models.detector import SRFDet
from srfdet3d_torch.models.grid_mask import (GridMaskDraws, apply_grid_mask,
                                             grid_mask, grid_mask_draws)

T = torch.from_numpy


def _jax_draws(rng, n, h, prob, ratio):
    """The draws of JAX grid_mask, replayed from its key."""
    k_apply, k_d, k_sh, k_sw = jax.random.split(rng, 4)
    apply_m = jax.random.uniform(k_apply, (n,)) < prob
    d = jax.random.randint(k_d, (n,), 2, max(h, 3))
    l = jnp.clip((d * ratio + 0.5).astype(jnp.int32), 1, d - 1)
    st_h = jax.random.randint(k_sh, (n,), 0, 1 << 30) % d
    st_w = jax.random.randint(k_sw, (n,), 0, 1 << 30) % d
    return GridMaskDraws(*(T(np.array(a)).long() if a.dtype != bool
                           else T(np.array(a))
                           for a in (apply_m, d, l, st_h, st_w)))


@pytest.mark.parametrize("lead,h,w,prob,ratio", [
    ((2, 6), 24, 40, 0.7, 0.5),      # B x cameras, wider than high
    ((40,), 33, 17, 0.7, 0.5),       # higher than wide, odd sizes
    ((3, 5), 16, 16, 0.4, 0.3),      # other prob and ratio
])
def test_mask_function_matches_jax_on_its_draws(lead, h, w, prob, ratio):
    """Exactly JAX's output, on JAX's own draws: the stripes, their
    phases and the images left whole."""
    rng = jax.random.PRNGKey(sum(lead) + h)
    images = np.random.default_rng(h).normal(
        0, 1, lead + (h, w, 3)).astype(np.float32)
    n = int(np.prod(lead))
    want = np.asarray(j_grid_mask(rng, jnp.asarray(images), prob, ratio))
    draws = _jax_draws(rng, n, h, prob, ratio)
    nchw = T(images.reshape((n, h, w, 3))).permute(0, 3, 1, 2)
    got = apply_grid_mask(nchw, draws).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got.reshape(images.shape), want)
    # the case has masked and unmasked images, and zeros where masked
    assert 0 < int(draws.apply.sum()) < n
    assert (want == 0).any()


def test_port_draws_ranges_and_rate():
    """Over 20,000 images of height 48: the apply rate within 0.015 of
    prob 0.7 (4.6 standard errors), d over all of [2, 48) and nothing
    else, l = clip(int(d / 2 + 0.5), 1, d - 1), phases in [0, d); the
    same generator seed draws the same values."""
    n, h = 20_000, 48
    draws = grid_mask_draws(n, h, torch.Generator().manual_seed(0))
    assert abs(float(draws.apply.float().mean()) - 0.7) < 0.015
    assert set(draws.d.tolist()) == set(range(2, h))
    want_l = torch.minimum((draws.d * 0.5 + 0.5).long().clamp(min=1),
                           draws.d - 1)
    assert torch.equal(draws.l, want_l)
    assert int(draws.l.min()) >= 1 and bool((draws.l <= draws.d - 1).all())
    for st in (draws.st_h, draws.st_w):
        assert int(st.min()) == 0 and bool((st < draws.d).all())
    again = grid_mask_draws(n, h, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(draws, again))


def test_short_images_draw_d_below_three():
    """JAX's bound max(H, 3): at H = 2 every d is 2 and l is 1."""
    draws = grid_mask_draws(500, 2, torch.Generator().manual_seed(1))
    assert set(draws.d.tolist()) == {2} and set(draws.l.tolist()) == {1}


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_detector_draws_grid_mask_before_dropout(dropout):
    """Train mode with use_grid_mask: the model's forward equals a forward
    without GridMask on the images masked by draws from the same
    generator, the head's dropout drawing after them from what is left of
    it; eval mode applies no mask; train mode without a generator
    raises."""
    import dataclasses

    import chip_smoke
    cfg = tiny_lc_test_config("vovnet")
    cfg = cfg.replace(head=dataclasses.replace(cfg.head, dropout=dropout))
    off = cfg.replace(img=dataclasses.replace(cfg.img, use_grid_mask=False))
    batch = chip_smoke.lc_batch(cfg, 2, seed=0)
    model = SRFDet(cfg, device="cpu", seed=1)
    ref = SRFDet(off, device="cpu", seed=1)
    with torch.no_grad():
        a, b = model(batch), ref(batch)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    model.train()
    ref.train()
    with torch.no_grad():
        got = model(batch, torch.Generator().manual_seed(3))
        gen = torch.Generator().manual_seed(3)
        draws = grid_mask_draws(2 * cfg.img.num_cams, cfg.img.img_shape[0],
                                gen)
        img = batch["images"].flatten(0, 1).permute(0, 3, 1, 2)
        masked = apply_grid_mask(img, draws).permute(0, 2, 3, 1)
        want = ref({**batch, "images": masked.reshape(
            batch["images"].shape)}, gen)
        plain = ref(batch, torch.Generator().manual_seed(3))
    for g, wv in zip(got, want):
        assert torch.equal(g, wv)
    assert int(draws.apply.sum()) > 0
    assert not torch.equal(got[0], plain[0])
    with pytest.raises(ValueError, match="Generator"):
        model(batch)


def test_grid_mask_zeroes_only_masked_pixels():
    """grid_mask draws and applies in one call: every image either stays
    whole or keeps exactly its stripes."""
    gen = torch.Generator().manual_seed(4)
    x = torch.rand(64, 3, 20, 30) + 1.0           # no zero pixels
    out = grid_mask(x, gen)
    draws = grid_mask_draws(64, 20, torch.Generator().manual_seed(4))
    for i in range(64):
        kept = out[i, 0] != 0
        if not bool(draws.apply[i]):
            assert bool(kept.all())
            continue
        ys = (torch.arange(20) - draws.st_h[i]) % draws.d[i] < draws.l[i]
        xs = (torch.arange(30) - draws.st_w[i]) % draws.d[i] < draws.l[i]
        assert torch.equal(kept, ys[:, None] | xs[None, :])
        assert torch.equal(out[i][:, kept], x[i][:, kept])
