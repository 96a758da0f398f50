"""The port's multi-view image transforms (`srfdet3d_torch/data/
img_transforms.py`) against the JAX package's.

- `_resize`: the port interpolates in PyTorch (bilinear, antialiased),
  the JAX package in PIL (BILINEAR, 'F' mode); on uniform 0-255 floats
  they agree within 0.05 at the four geometries the LC configs meet.
- the uint8 RGB -> HSV conversion equals cv2's, exhaustively over all
  2^24 colours.  cv2's HSV -> RGB is not one function of the pixel: its
  vector path and its scalar tail round differently (the same HSV triple
  converts to two RGB values depending on where it sits in a row), so no
  copy can match it bit for bit.  The port's is OpenCV's scalar formula
  and stays within one grey level of both paths, over all 180 x 256 x 256
  inputs; photometric_distortion therefore draws exactly what the JAX
  package draws (the generator states after it are equal) and lands
  within one grey level, times a contrast factor of at most 1.5.
- every other function: equal, images and lidar2img alike, up to the
  resize's tolerance where it resizes.
"""

import numpy as np
import pytest

from srfdet3d_tpu.data import img_transforms as J
from srfdet3d_torch.data import img_transforms as T

RESIZE_TOL = 0.05


@pytest.mark.parametrize("src,dst", [((1280, 1920), (640, 960)),
                                     ((886, 1920), (640, 960)),
                                     ((375, 1242), (384, 1248)),
                                     ((900, 1600), (928, 1600))])
def test_resize_matches_pil(src, dst):
    rng = np.random.default_rng(sum(src))
    img = rng.uniform(0, 255, src + (3,)).astype(np.float32)
    got = T._resize(img, dst)
    ref = J._resize(img, dst)
    assert got.shape == ref.shape == dst + (3,) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=RESIZE_TOL)


def test_rgb_to_hsv_matches_cv2_exhaustively():
    cv2 = pytest.importorskip("cv2")
    a = np.arange(256, dtype=np.uint8)
    rgb = np.stack(np.meshgrid(a, a, a, indexing="ij"), -1
                   ).reshape(4096, 4096, 3)
    np.testing.assert_array_equal(T.rgb_to_hsv_u8(rgb),
                                  cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV))


def test_hsv_to_rgb_within_one_level_of_cv2():
    cv2 = pytest.importorskip("cv2")
    a = np.arange(256, dtype=np.uint8)
    h = np.arange(180, dtype=np.uint8)
    hsv = np.stack(np.meshgrid(h, a, a, indexing="ij"), -1)
    got = T.hsv_to_rgb_u8(hsv.reshape(-1, 256, 3)).astype(np.int64)
    for shape in ((-1, 256, 3), (-1, 1, 3)):      # vector path, scalar path
        ref = cv2.cvtColor(hsv.reshape(shape), cv2.COLOR_HSV2RGB)
        diff = np.abs(ref.reshape(-1, 256, 3).astype(np.int64) - got)
        assert diff.max() <= 1
    # the scalar path rounds as the port does but at exact .5 ties
    assert (diff > 0).mean() < 1e-3


def _views(seed, n=3, hw=(90, 160)):
    rng = np.random.default_rng(seed)
    imgs = [rng.uniform(0, 255, hw + (3,)).astype(np.float32)
            for _ in range(n)]
    l2i = rng.normal(0, 100, (n, 4, 4)).astype(np.float32)
    return imgs, l2i


def _both(fn_name, seed, *args, rng_seed=None, hw=(90, 160)):
    out = []
    for mod in (J, T):
        imgs, l2i = _views(seed, hw=hw)
        sample = {"images": imgs, "lidar2img": l2i}
        extra = (np.random.default_rng(rng_seed),) if rng_seed is not None \
            else ()
        out.append(getattr(mod, fn_name)(sample, *extra, *args))
    return out


def _same(j, t, tol=0.0):
    assert sorted(j) == sorted(t)
    for a, b in zip(j["images"], t["images"]):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(b, a, rtol=0, atol=tol)
    if "lidar2img" in j:
        np.testing.assert_array_equal(j["lidar2img"], t["lidar2img"])
    assert j.get("img_flip") == t.get("img_flip")


def test_pad_normalize_crop_match_jax():
    for div in (32, 7):
        _same(*_both("pad_multiview", 0, div, 3.0))
    _same(*_both("normalize_multiview", 1))
    _same(*_both("crop_multiview", 2, (64, 100)))
    # views of unequal sizes pad to the largest
    for mod in (J, T):
        s = mod.pad_multiview({"images": [np.ones((5, 7, 3), np.float32),
                                          np.ones((9, 4, 3), np.float32)]},
                              8)
        assert [i.shape for i in s["images"]] == [(16, 8, 3)] * 2


def test_resize_scale_flip_match_jax():
    _same(*_both("resize_multiview", 3, (64, 96)), tol=RESIZE_TOL)
    _same(*_both("resize_multiview", 4, (180, 320)), tol=RESIZE_TOL)
    for seed in range(4):
        _same(*_both("random_scale_multiview", 5, (0.5, 0.75, 1.25),
                     rng_seed=seed), tol=RESIZE_TOL)
        j, t = _both("horizontal_flip_multiview", 6, rng_seed=seed)
        _same(j, t)


def test_photometric_distortion_draws_and_values():
    worst = 0.0
    for seed in range(12):
        imgs, _ = _views(100 + seed)
        states, outs = [], []
        for mod in (J, T):
            rng = np.random.default_rng(seed)
            outs.append(mod.photometric_distortion(
                {"images": [i.copy() for i in imgs]}, rng)["images"])
            states.append(rng.bit_generator.state)
        assert states[0] == states[1]
        for a, b in zip(*outs):
            assert a.dtype == b.dtype == np.float32
            worst = max(worst, float(np.abs(a - b).max()))
    assert worst <= 1.5
