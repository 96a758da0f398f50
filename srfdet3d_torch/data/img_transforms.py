"""Multi-view image pipeline transforms (host-side numpy).

A copy of the JAX package's `data/img_transforms.py`, which stands in for
the reference's datasets/pipelines/transform_3d.py:
  PadMultiViewImage (:8)               -> :func:`pad_multiview`
  NormalizeMultiviewImage (:60)        -> :func:`normalize_multiview`
  PhotoMetricDistortionMultiViewImage (:96) -> :func:`photometric_distortion`
  CropMultiViewImage (:196)            -> :func:`crop_multiview`
  RandomScaleImageMultiViewImage (:224) -> :func:`random_scale_multiview`
  ResizeImageMultiViewImage (:270)     -> :func:`resize_multiview`
  HorizontalRandomFlipMultiViewImage (:325) -> :func:`horizontal_flip_multiview`
  RandomFlip3DMultiViewImage (:374)    -> (use with transforms.random_flip_3d)

Two pieces differ in how, not in what, they compute: the bilinear resize
runs in PyTorch (the JAX package uses PIL's BILINEAR filter in 'F' mode,
which antialiases when it shrinks), and the uint8 RGB <-> HSV conversions
of the photometric distortion are numpy copies of OpenCV's integer
RGB2HSV and float HSV2RGB (the JAX package calls cv2).

All functions take/return a sample dict with:
  "images": list/array of (H, W, 3) float32,
  "lidar2img": (n_cam, 4, 4) — updated consistently with image-space edits.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch


def _resize(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize of an (H, W, C) float image to hw = (h, w), float in
    and out (a uint8 round trip would clip normalized pixels and quantize).
    Half-pixel centres and a triangle filter widened by the scale when it
    shrinks: PIL's BILINEAR, which the JAX package uses, not cv2's
    INTER_LINEAR (no antialiasing)."""
    x = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    x = x.permute(2, 0, 1)[None]
    y = torch.nn.functional.interpolate(
        x, size=tuple(hw), mode="bilinear", align_corners=False,
        antialias=True)
    return np.ascontiguousarray(y[0].permute(1, 2, 0).numpy())


_HSV_SHIFT = 12


def _hsv_tables() -> Tuple[np.ndarray, np.ndarray]:
    """OpenCV's RGB2HSV_b division tables (hue range 180), rounded half to
    even as its saturate_cast<int> rounds."""
    i = np.arange(1, 256, dtype=np.float64)
    sdiv = np.zeros(256, np.int64)
    hdiv = np.zeros(256, np.int64)
    sdiv[1:] = np.rint((255 << _HSV_SHIFT) / i)
    hdiv[1:] = np.rint((180 << _HSV_SHIFT) / (6.0 * i))
    return sdiv, hdiv


_SDIV, _HDIV = _hsv_tables()


def rgb_to_hsv_u8(rgb: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 RGB -> uint8 HSV, H in [0, 180): cv2.cvtColor(rgb,
    cv2.COLOR_RGB2HSV), OpenCV's fixed-point arithmetic."""
    c = rgb.astype(np.int64)
    r, g, b = c[..., 0], c[..., 1], c[..., 2]
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b,
                 np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([np.clip(h, 0, 255), s, v], -1).astype(np.uint8)


# per sector (b, g, r) picks from (v, v(1-s), v(1-s f), v(1-s(1-f)))
_SECTOR = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                    [2, 1, 0]])


def hsv_to_rgb_u8(hsv: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 HSV (H in [0, 180)) -> uint8 RGB: cv2.cvtColor(hsv,
    cv2.COLOR_HSV2RGB), OpenCV's float32 HSV2RGB with round-half-even
    saturation to uint8."""
    f32 = np.float32
    h = hsv[..., 0].astype(f32) * f32(6.0 / 180.0)
    s = hsv[..., 1].astype(f32) * f32(1.0 / 255.0)
    v = hsv[..., 2].astype(f32)
    sector = np.floor(h)
    frac = (h - sector).astype(f32)
    sector = sector.astype(np.int64) % 6
    one = f32(1.0)
    tab = np.stack([v, v * (one - s), v * (one - s * frac),
                    v * (one - s * (one - frac))], -1)
    pick = _SECTOR[sector]                                 # (..., 3) b, g, r
    bgr = np.take_along_axis(tab, pick, -1)
    rgb = bgr[..., ::-1]
    return np.clip(np.rint(rgb), 0, 255).astype(np.uint8)


def pad_multiview(sample: Dict, size_divisor: int = 32,
                  pad_val: float = 0.0) -> Dict:
    """Bottom/right zero-pad every view to a multiple of size_divisor."""
    imgs = sample["images"]
    h = max(i.shape[0] for i in imgs)
    w = max(i.shape[1] for i in imgs)
    h = -(-h // size_divisor) * size_divisor
    w = -(-w // size_divisor) * size_divisor
    out = []
    for img in imgs:
        pad = np.full((h, w, img.shape[2]), pad_val, np.float32)
        pad[:img.shape[0], :img.shape[1]] = img
        out.append(pad)
    sample["images"] = out
    return sample


def normalize_multiview(sample: Dict,
                        mean=(123.675, 116.28, 103.53),
                        std=(58.395, 57.12, 57.375)) -> Dict:
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    sample["images"] = [(i - mean) / std for i in sample["images"]]
    return sample


def photometric_distortion(sample: Dict, rng: np.random.Generator,
                           brightness_delta: float = 32,
                           contrast_range=(0.5, 1.5),
                           saturation_range=(0.5, 1.5),
                           hue_delta: float = 18) -> Dict:
    """Random brightness/contrast/saturation/hue, same order semantics as
    mmdet's PhotoMetricDistortion (applied per view, pre-normalization)."""
    out = []
    for img in sample["images"]:
        img = img.astype(np.float32)
        if rng.integers(2):
            img = img + rng.uniform(-brightness_delta, brightness_delta)
        contrast_first = rng.integers(2)
        if contrast_first and rng.integers(2):
            img = img * rng.uniform(*contrast_range)
        # saturation and hue applied INDEPENDENTLY w.p. 0.5 each (mmdet)
        do_sat = bool(rng.integers(2))
        do_hue = bool(rng.integers(2))
        if do_sat or do_hue:
            hsv = rgb_to_hsv_u8(np.clip(img, 0, 255).astype(np.uint8)
                                ).astype(np.float32)
            if do_sat:
                hsv[..., 1] *= rng.uniform(*saturation_range)
            if do_hue:
                hsv[..., 0] = (hsv[..., 0] +
                               rng.uniform(-hue_delta, hue_delta)) % 180
            img = hsv_to_rgb_u8(
                np.clip(hsv, 0, 255).astype(np.uint8)).astype(np.float32)
        if not contrast_first and rng.integers(2):
            img = img * rng.uniform(*contrast_range)
        out.append(np.clip(img, 0, 255))
    sample["images"] = out
    return sample


def crop_multiview(sample: Dict, crop_hw: Tuple[int, int]) -> Dict:
    """Top-left crop (reference CropMultiViewImage: fixed-size corner crop;
    the principal point shifts only for non-corner crops, so lidar2img is
    unchanged here like the reference)."""
    h, w = crop_hw
    sample["images"] = [i[:h, :w] for i in sample["images"]]
    return sample


def random_scale_multiview(sample: Dict, rng: np.random.Generator,
                           scales: Sequence[float] = (0.5,)) -> Dict:
    """Scale every view by one randomly chosen factor; the projection's
    first two rows scale with it (reference :224-268)."""
    s = float(scales[int(rng.integers(len(scales)))])
    out = []
    for img in sample["images"]:
        hw = (int(img.shape[0] * s), int(img.shape[1] * s))
        out.append(_resize(img, hw))
    sample["images"] = out
    l2i = sample["lidar2img"].copy()
    l2i[:, :2, :] *= s
    sample["lidar2img"] = l2i
    return sample


def resize_multiview(sample: Dict, target_hw: Tuple[int, int]) -> Dict:
    """Resize all views to a fixed size, rescaling lidar2img per view
    (reference ResizeImageMultiViewImage, Waymo 5-cam path :270-323)."""
    out = []
    l2i = sample["lidar2img"].copy()
    for i, img in enumerate(sample["images"]):
        sy = target_hw[0] / img.shape[0]
        sx = target_hw[1] / img.shape[1]
        out.append(_resize(img, target_hw))
        l2i[i, 0, :] *= sx
        l2i[i, 1, :] *= sy
    sample["images"] = out
    sample["lidar2img"] = l2i
    return sample


def horizontal_flip_multiview(sample: Dict, rng: np.random.Generator,
                              flip_ratio: float = 0.5) -> Dict:
    """Mirror every view horizontally; u' = (W-1) - u, i.e. the projection
    row 0 negates with an offset (reference :325-372)."""
    if rng.uniform() >= flip_ratio:
        return sample
    out = []
    l2i = sample["lidar2img"].copy()
    for i, img in enumerate(sample["images"]):
        w = img.shape[1]
        out.append(img[:, ::-1].copy())
        l2i[i, 0, :] = -l2i[i, 0, :] + (w - 1) * l2i[i, 2, :]
    sample["images"] = out
    sample["lidar2img"] = l2i
    sample["img_flip"] = True
    return sample
