"""Datasets: info-pkl loaders + pipelines + CBGS + fixed-shape collate.

A copy of the JAX package's `data/datasets.py` (numpy, the same draws:
a sample equals the JAX package's on the same point route, bit for bit,
but for the resize of `_prep_image`'s resize mode, see
`img_transforms._resize`).
Camera frames may be `.npy` arrays (H, W, 3), read as they are; JPEG and
PNG frames are decoded with PIL, imported only then.  `show()` draws
results through the port's `vis/`, which imports cv2 only then.  The
range filter with its shuffle and pad, and the .bin loads, take the route
`native.py` selects: the C++ one by default, whose samples equal the JAX
package's with its C++ extension, or numpy (SRFDET_POINT_IO=numpy),
whose equal its numpy fallback.

Replaces the reference's CustomNuScenesDataset / CustomKittiDataset /
CustomWaymoDataset (datasets/*.py) and the mmdet3d base datasets they extend.
All datasets consume the standard mmdet3d "infos" pickle files (the same
artifacts the reference's data-prep step produces), run the numpy pipeline
(transforms.py), and emit FIXED-SHAPE sample dicts ready for batching:

  {
    "points": (P_cap, D) f32, "points_mask": (P_cap,) bool,
    "gt_boxes": (G_cap, 9) f32 gravity-center z, "gt_labels": (G_cap,) i32,
    "gt_mask": (G_cap,) bool,
    ["images": (n_cam, H, W, 3) f32, "lidar2img": (n_cam, 4, 4) f32],
  }

The lidar2img computation mirrors CustomNuScenesDataset.get_data_info
(reference nuscenes_dataset.py:19-82): lidar2cam from sensor2lidar R/T,
composed with the camera intrinsics.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..config import SRFDetConfig
from . import transforms as T


def _load_image(path: str) -> np.ndarray:
    """(H, W, 3) float32 RGB: a `.npy` frame as it is, any other file
    through PIL (RGB conversion)."""
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    from PIL import Image
    return np.asarray(Image.open(path).convert("RGB"), np.float32)


class SRFDetDataset:
    """Base dataset: pipeline + fixed-shape packing."""

    def __init__(self, cfg: SRFDetConfig, info_path: str = "",
                 data_root: str = "", test_mode: bool = False,
                 augment: Optional[bool] = None,
                 db_sampler: Optional[T.DBSampler] = None,
                 sweeps_num: int = 10, seed: int = 0):
        """test_mode=True drops GT loading entirely (reference test
        pipelines); augment controls the random train transforms
        SEPARATELY (default: not test_mode) so evaluation can keep GTs
        while running the deterministic protocol (augment=False)."""
        self.cfg = cfg
        self.data_root = data_root
        self.test_mode = test_mode
        self.augment = (not test_mode) if augment is None else augment
        self.db_sampler = db_sampler
        self.sweeps_num = sweeps_num
        self.seed = seed
        # the train loop bumps this each epoch so per-index aug draws vary
        self.epoch = 0
        self.infos: List[Dict] = []
        if info_path:
            with open(info_path, "rb") as f:
                data = pickle.load(f)
            self.infos = data["infos"] if isinstance(data, dict) else data
            if isinstance(data, dict) and "infos" in data:
                self.metadata = data.get("metadata", {})

    # ---- per-dataset hooks -------------------------------------------------
    def load_points(self, info: Dict,
                    rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """rng: per-call generator when augmenting (random sweep choice);
        None = deterministic (eval/test protocol)."""
        raise NotImplementedError

    def load_annotations(self, info: Dict):
        raise NotImplementedError

    def load_images(self, info: Dict, flip: bool = False):
        """Returns (images (n_cam, H, W, 3), lidar2img (n_cam, 4, 4)).
        flip=True mirrors every raw view horizontally and folds the
        flip's projection compensation into lidar2img (the synced-2D/3D
        flip path; the caller adds the 3D-flip column negation)."""
        raise NotImplementedError

    def sample_categories(self, idx: int) -> Sequence[int]:
        """Class ids present in sample idx (for CBGS)."""
        _, labels = self.load_annotations(self.infos[idx])
        return np.unique(labels[labels >= 0]).tolist()

    # BEV render window (meters) and raster resolution per dataset —
    # mirrors the reference's three dataset-specific renderers
    # (show_result.py:443 nus 51.2 m, :634 kitti forward 70.4 m,
    # :827 waymo 75 m)
    BEV_RANGE = (-51.2, -51.2, 51.2, 51.2)
    BEV_PIXELS_PER_METER = 10.0

    def show(self, results, out_dir: str, score_thr: float = 0.2,
             max_frames: Optional[int] = None,
             save_3d: bool = False) -> int:
        """Render per-frame result visualizations (reference
        `dataset.show()`, nuscenes_dataset.py:119-239): a BEV raster of
        points + GT + thresholded predictions, per-camera projected-box
        overlays (when the config has an image branch), and optionally the
        obj/ply 3D scene files.

        results: list of per-frame dicts {"boxes" (N, 7+) bottom-center,
        "scores" (N,), "labels" (N,)} aligned with this dataset's frames.
        Returns the number of frames written.
        """
        from ..vis import (show_bev_result, show_multi_modality_result,
                           show_result)
        n = 0
        rng = self.BEV_RANGE
        pc_range = (rng[0], rng[1], -5.0, rng[2], rng[3], 3.0)
        for i, res in enumerate(results):
            if max_frames is not None and i >= max_frames:
                break
            info = self.infos[i]
            points = self.load_points(info)
            gt_boxes, gt_labels = self.load_annotations(info)
            keep = np.asarray(res["scores"]) > score_thr
            pred = np.asarray(res["boxes"])[keep]
            pred_labels = np.asarray(res.get(
                "labels", np.zeros(len(res["boxes"]))))[keep]
            show_bev_result(
                points, gt_boxes[:, :7] if len(gt_boxes) else gt_boxes,
                pred[:, :7] if len(pred) else pred,
                os.path.join(out_dir, f"{i:05d}_bev.png"),
                pc_range=pc_range,
                pixels_per_meter=self.BEV_PIXELS_PER_METER,
                pred_labels=pred_labels,
                gt_labels=gt_labels if len(gt_boxes) else None)
            if self.cfg.use_img:
                images, lidar2img = self.load_images(info)
                img_hw = images.shape[1:3]
                for v in range(images.shape[0]):
                    # per-view center gating (reference :194-228)
                    def in_view(bx):
                        if len(bx) == 0:
                            return np.zeros(0, bool)
                        return are_points_in_image(
                            bx[:, :3], lidar2img[v], img_hw)
                    g_m = in_view(gt_boxes)
                    p_m = in_view(pred)
                    # de-normalize for display (stored channel order is
                    # BGR when cfg.img.bgr — see _prep_image)
                    rgb = (images[v][..., ::-1] if self.cfg.img.bgr
                           else images[v])
                    img = rgb * IMAGENET_STD + IMAGENET_MEAN
                    show_multi_modality_result(
                        img[..., ::-1],          # RGB -> BGR
                        pred[p_m][:, :7] if p_m.any() else pred[:0, :7],
                        lidar2img[v],
                        os.path.join(out_dir, f"{i:05d}_v{v + 1}.png"),
                        gt_boxes=(gt_boxes[g_m][:, :7]
                                  if g_m.any() else None),
                        labels=pred_labels[p_m])
            if save_3d:
                show_result(points,
                            gt_boxes[:, :7] if len(gt_boxes) else None,
                            pred[:, :7] if len(pred) else None,
                            out_dir, f"{i:05d}")
            n += 1
        return n

    # ---- pipeline ----------------------------------------------------------
    def __len__(self) -> int:
        return len(self.infos)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        return self.getitem(idx)

    def getitem(self, idx: int, salt: int = 0) -> Dict[str, np.ndarray]:
        """salt: extra rng-key element for wrappers that repeat an inner
        index within one epoch (CBGS oversampling) — without it every
        duplicate of a rare-class frame would draw byte-identical
        augmentations, defeating the oversampling."""
        cfg = self.cfg
        info = self.infos[idx]
        # per-call generator: the loader maps __getitem__ over a thread
        # pool and numpy Generators are NOT thread-safe — a shared one
        # races its state (correlated aug draws, irreproducible runs)
        key = (self.seed, self.epoch, idx) if salt == 0 else \
            (self.seed, self.epoch, idx, salt)
        rng = np.random.default_rng(key)
        points = self.load_points(info, rng=rng if self.augment else None)

        sample: Dict[str, np.ndarray] = {}
        sync_flip = False
        if not self.test_mode:
            boxes, labels = self.load_annotations(info)
            if self.augment:
                if self.db_sampler is not None:
                    points, boxes, labels = self.db_sampler.apply(
                        points, boxes, labels, rng)
                # geometric augs are config-gated: the reference's
                # nuScenes LC pipelines drop them (no lidar2img
                # compensation — see AugConfig); kitti_LC keeps a
                # sync_2d flip, handled below with exact compensation
                if cfg.aug.object_noise:
                    points, boxes = T.object_noise(
                        points, boxes, rng,
                        trans_std=tuple(cfg.aug.object_noise_trans),
                        rot_range=tuple(cfg.aug.object_noise_rot),
                        num_try=cfg.aug.object_noise_tries)
                if cfg.aug.rot_scale_trans:
                    points, boxes = T.global_rot_scale_trans(
                        points, boxes, rng,
                        rot_range=tuple(cfg.aug.rot_range),
                        scale_range=tuple(cfg.aug.scale_range),
                        trans_std=tuple(cfg.aug.trans_std))
                if cfg.aug.sync_flip_2d and cfg.use_img:
                    # synced 2D/3D horizontal flip (reference kitti_LC
                    # RandomFlip3D sync_2d, transform_3d.py:374-430 /
                    # mmdet3d RandomFlip3D): flip the 3D scene here; the
                    # image flip + lidar2img compensation happens at
                    # load_images below with the same decision
                    sync_flip = rng.uniform() < cfg.aug.flip_horizontal
                    if sync_flip:
                        points, boxes = T.flip_horizontal_3d(
                            points.copy(), boxes.copy())
                elif cfg.aug.flip_horizontal or cfg.aug.flip_vertical:
                    points, boxes, _ = T.random_flip_3d(
                        points, boxes, rng,
                        flip_ratio_horizontal=cfg.aug.flip_horizontal,
                        flip_ratio_vertical=cfg.aug.flip_vertical)
            boxes, labels = T.object_range_filter(boxes, labels,
                                                  cfg.pc_range)
            boxes, labels = T.object_name_filter(boxes, labels,
                                                 cfg.num_classes)
            gt_boxes, gt_labels, gt_mask = T.pad_gts(
                boxes, labels, cfg.gt_cap,
                box_dim=9 if cfg.head.code_size == 10 else 7)
            sample.update(gt_boxes=gt_boxes, gt_labels=gt_labels,
                          gt_mask=gt_mask)

        # range filter + shuffle + capacity pad, one pass on the C++ route
        from .native import filter_pad_fast
        pts, mask = filter_pad_fast(
            points, cfg.pc_range, cfg.points_cap,
            shuffle=self.augment,
            seed=int(rng.integers(1 << 31)))
        sample.update(points=pts, points_mask=mask)

        if cfg.use_img:
            images, lidar2img = self.load_images(info, flip=sync_flip)
            if sync_flip:
                # compensate the 3D y-flip: world p -> Fp with
                # F = diag(1,-1,1,1), so M' = M_img_flipped @ F (negate
                # column 1).  Combined with the image-flip row transform
                # in _prep_image, M' @ (Fp) lands the flipped box exactly
                # on the mirrored pixel — projection-consistent (unlike
                # the reference's stale matrix, a known mmdet3d quirk)
                lidar2img = lidar2img.copy()
                lidar2img[:, :, 1] *= -1.0
            sample.update(images=images.astype(np.float32),
                          lidar2img=lidar2img.astype(np.float32))
        return sample


def are_points_in_image(points: np.ndarray, lidar2img: np.ndarray,
                        img_hw) -> np.ndarray:
    """Which lidar points project inside an image
    (reference CustomNuScenesDataset.are_points_in_image,
    nuscenes_dataset.py:84-117)."""
    hom = np.concatenate(
        [points[:, :3], np.ones((len(points), 1), points.dtype)], axis=1)
    cam = hom @ lidar2img.T
    z = cam[:, 2]
    uv = cam[:, :2] / np.maximum(z[:, None], 1e-5)
    return ((z > 0.1) & (uv[:, 0] >= 0) & (uv[:, 0] < img_hw[1]) &
            (uv[:, 1] >= 0) & (uv[:, 1] < img_hw[0]))


# nuScenes camera order used by the mmdet3d infos
NUS_CAMS = ("CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_FRONT_LEFT", "CAM_BACK",
            "CAM_BACK_LEFT", "CAM_BACK_RIGHT")


def _prep_image(img: np.ndarray, icfg, flip: bool = False
                ) -> "tuple[np.ndarray, float, float, int]":
    """Normalize + fit one RGB image to icfg.img_shape.

    mode="pad": mmcv Normalize + Pad(size_divisor) semantics (reference
    srfdet_voxel_nusc_LC.py:246-247) — the native image sits unscaled at
    the top-left of a zero canvas; lidar2img is unchanged (sx=sy=1).
    Falls back to resize when the source exceeds the canvas.
    mode="resize": scale to img_shape; the caller rescales lidar2img by
    the returned (sx, sy) (reference ResizeImageMultiViewImage,
    transform_3d.py:270).

    icfg.bgr flips the channel axis AFTER RGB normalization — identical
    to mmcv's to_rgb=False BGR mean/std on a BGR-loaded image (the
    constants are exact mirrors), reference img_norm_cfg.

    flip=True mirrors the RAW image horizontally first (reference
    pipeline order: RandomFlip3D flips the loaded image, THEN
    Normalize/Pad — so padding stays on the right edge); the returned
    sx/sy stay valid and the caller applies the flip's projection
    compensation via `_hflip_mat(w_c)` in POST-resize coordinates
    (u' = (w_c-1) - sx*u), where the returned w_c is the width the
    image CONTENT occupies after fitting: w0 in pad mode, the target
    width in resize mode.  Applying the flip at the raw width before
    the scale is off by (sx-1) px whenever the image is resized
    (ADVICE r4); the two orders coincide exactly when sx == 1.
    Returns (normalized (H, W, 3) float32, sx, sy, w_content).
    """
    h0, w0 = img.shape[:2]
    if flip:
        img = img[:, ::-1]
    h_t, w_t = icfg.img_shape
    if icfg.mode == "pad" and h0 <= h_t and w0 <= w_t:
        norm = (img.astype(np.float32) - IMAGENET_MEAN) / IMAGENET_STD
        out = np.zeros((h_t, w_t, 3), np.float32)
        out[:h0, :w0] = norm
        sx = sy = 1.0
    else:
        # bilinear, antialiased when it shrinks (the JAX package's PIL
        # BILINEAR; see img_transforms._resize)
        from .img_transforms import _resize
        img = _resize(img.astype(np.float32), (h_t, w_t))
        out = (img - IMAGENET_MEAN) / IMAGENET_STD
        sx, sy = w_t / w0, h_t / h0
        w0 = w_t  # content now spans the full target width
    if icfg.bgr:
        out = out[..., ::-1]
    return np.ascontiguousarray(out), sx, sy, w0
IMAGENET_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMAGENET_STD = np.array([58.395, 57.12, 57.375], np.float32)


def _hflip_mat(w: int) -> np.ndarray:
    """4x4 left-multiplier for a horizontal image flip at raw width w:
    u' = (w-1) - u, i.e. row0 -> -row0 + (w-1)*row2 (same convention as
    img_transforms.horizontal_flip_multiview)."""
    hf = np.eye(4, dtype=np.float32)
    hf[0, 0] = -1.0
    hf[0, 2] = float(w - 1)
    return hf


class NuScenesDataset(SRFDetDataset):
    CLASSES = ("car", "truck", "construction_vehicle", "bus", "trailer",
               "barrier", "motorcycle", "bicycle", "pedestrian",
               "traffic_cone")

    def load_points(self, info: Dict,
                    rng: Optional[np.random.Generator] = None) -> np.ndarray:
        path = info["lidar_path"]
        if not os.path.isabs(path):
            path = os.path.join(self.data_root, path)
        points = T.load_points_bin(path, 5, (0, 1, 2, 3, 4))
        # sweep paths get the same data_root treatment as lidar_path
        # (infos may store either absolute or data_root-relative paths)
        sweeps = [s if os.path.isabs(s["data_path"]) else
                  dict(s, data_path=os.path.join(self.data_root,
                                                 s["data_path"]))
                  for s in info.get("sweeps", [])]
        # rng=None (eval/test): deterministic first-N sweep selection
        return T.multi_sweep_aggregate(
            points, sweeps, self.sweeps_num,
            rng=rng, test_mode=rng is None,
            key_timestamp_us=float(info.get("timestamp", 0.0)))

    def load_annotations(self, info: Dict):
        boxes = np.asarray(info["gt_boxes"], np.float32).copy()  # (N, 7)
        # mmdet3d nuScenes infos store GRAVITY-center z (origin 0.5);
        # the pipeline convention is bottom-center like
        # LiDARInstance3DBoxes, so shift down by h/2 here (pad_gts converts
        # back to gravity center for the model).
        if len(boxes):
            boxes[:, 2] -= 0.5 * boxes[:, 5]
        vel = np.asarray(info.get("gt_velocity",
                                  np.zeros((len(boxes), 2))), np.float32)
        vel = np.nan_to_num(vel)
        boxes = np.concatenate([boxes, vel], axis=1)          # (N, 9)
        names = info["gt_names"]
        labels = np.array(
            [self.cfg.class_names.index(n) if n in self.cfg.class_names
             else -1 for n in names], np.int64)
        # reference parity: CustomNuScenesDataset leaves mmdet3d's
        # use_valid_flag=False, so the GT filter is num_lidar_pts > 0;
        # valid_flag ((lidar+radar) pts > 0) keeps radar-only boxes the
        # reference drops.  Fall back to valid_flag, then to all-true.
        if "num_lidar_pts" in info:
            valid = np.asarray(info["num_lidar_pts"])[:len(boxes)] > 0
        else:
            valid = np.asarray(
                info.get("valid_flag", np.ones(len(boxes), bool)), bool)
        return boxes[valid], labels[valid]

    def load_images(self, info: Dict, flip: bool = False):
        imgs, l2is = [], []
        for cam in NUS_CAMS:
            c = info["cams"][cam]
            path = c["data_path"]
            if not os.path.isabs(path):
                path = os.path.join(self.data_root, path)
            img = _load_image(path)
            # lidar -> cam (reference nuscenes_dataset.py:55-70)
            l2c_r = np.linalg.inv(
                np.asarray(c["sensor2lidar_rotation"]))
            l2c_t = -l2c_r @ np.asarray(c["sensor2lidar_translation"])
            l2c = np.eye(4)
            l2c[:3, :3] = l2c_r
            l2c[:3, 3] = l2c_t
            intr = np.eye(4)
            intr[:3, :3] = np.asarray(c["cam_intrinsic"])
            l2i = intr @ l2c
            # pad or resize to network input (see _prep_image); scale the
            # projection by the applied resize factors
            img, sx, sy, w_c = _prep_image(img, self.cfg.img, flip=flip)
            l2i = np.diag([sx, sy, 1.0, 1.0]) @ l2i
            if flip:
                l2i = _hflip_mat(w_c) @ l2i
            imgs.append(img)
            l2is.append(l2i)
        return np.stack(imgs), np.stack(l2is).astype(np.float32)


class KittiDataset(SRFDetDataset):
    CLASSES = ("Pedestrian", "Cyclist", "Car")
    # forward-facing window (reference show_bev_result_kitti, :634)
    BEV_RANGE = (0.0, -40.0, 70.4, 40.0)

    def load_points(self, info: Dict,
                    rng: Optional[np.random.Generator] = None) -> np.ndarray:
        pi = info.get("point_cloud", info)
        path = pi.get("velodyne_path", pi.get("lidar_path"))
        if not os.path.isabs(path):
            path = os.path.join(self.data_root, path)
        return T.load_points_bin(path, 4, (0, 1, 2, 3))

    def load_annotations(self, info: Dict):
        ann = info["annos"]
        # mmdet3d kitti infos store camera-frame boxes + calib; the infos
        # produced by mmdet3d also carry 'gt_boxes_lidar' after conversion
        if "gt_boxes_lidar" in ann:
            boxes = np.asarray(ann["gt_boxes_lidar"], np.float32)
        else:
            boxes = np.asarray(ann.get("gt_bboxes_3d", []), np.float32)
        names = np.asarray(ann.get("name", ann.get("gt_names", [])))
        if len(names) > len(boxes):
            # stock mmdet3d kitti infos keep trailing DontCare rows in
            # 'name' while gt_boxes_lidar holds only the leading non-
            # DontCare objects — align to the box count
            names = names[:len(boxes)]
        labels = np.array(
            [self.cfg.class_names.index(n) if n in self.cfg.class_names
             else -1 for n in names], np.int64)
        keep = labels >= 0
        return boxes[keep], labels[keep]

    def _load_view(self, path: str, p_mat: np.ndarray, calib: Dict,
                   flip: bool = False):
        """One camera: image padded or resized to cfg.img.img_shape (see
        _prep_image — KITTI LC pads; Waymo LC resizes, rescaling the
        lidar2img projection @ R0_rect @ Tr_velo_to_cam)."""
        if path and not os.path.isabs(path):
            path = os.path.join(self.data_root, path)
        img = _load_image(path)
        r0 = np.eye(4, dtype=np.float32)
        r0[:3, :3] = np.asarray(calib["R0_rect"], np.float32)[:3, :3]
        tr = np.asarray(calib["Tr_velo_to_cam"], np.float32)
        if tr.shape == (3, 4):
            tr = np.concatenate([tr, [[0, 0, 0, 1]]], axis=0)
        ph = np.eye(4, dtype=np.float32)
        ph[:3, :4] = np.asarray(p_mat, np.float32)[:3, :4]
        l2i = ph @ r0 @ tr
        img, sx, sy, w_c = _prep_image(img, self.cfg.img, flip=flip)
        l2i = np.diag([sx, sy, 1.0, 1.0]).astype(np.float32) @ l2i
        if flip:
            l2i = _hflip_mat(w_c) @ l2i
        return img, l2i

    def load_images(self, info: Dict, flip: bool = False):
        img_info = info.get("image", {})
        img, l2i = self._load_view(img_info.get("image_path"),
                                   info["calib"]["P2"], info["calib"],
                                   flip=flip)
        return img[None], l2i[None]


class WaymoDataset(KittiDataset):
    """Waymo via the mmdet3d kitti-format conversion (reference
    waymo_dataset_custom.py:14: num_views=5)."""
    CLASSES = ("Car", "Pedestrian", "Cyclist")
    # full-surround window (reference show_bev_result_waymo, :827)
    BEV_RANGE = (-75.0, -75.0, 75.0, 75.0)
    BEV_PIXELS_PER_METER = 7.0

    def load_points(self, info: Dict,
                    rng: Optional[np.random.Generator] = None) -> np.ndarray:
        pi = info.get("point_cloud", info)
        path = pi.get("velodyne_path", pi.get("lidar_path"))
        if not os.path.isabs(path):
            path = os.path.join(self.data_root, path)
        return T.load_points_bin(path, 6, (0, 1, 2, 3, 4))

    def load_images(self, info: Dict, flip: bool = False):
        """All num_cams surround views (reference CustomWaymoDataset
        num_views=5, waymo_dataset_custom.py:22,47): the mmdet3d
        waymo-kitti conversion stores view k's image under image_k/ with
        projection calib[Pk]."""
        n_cam = self.cfg.img.num_cams if self.cfg.img else 1
        img_info = info.get("image", {})
        path0 = img_info.get("image_path", "")
        calib = info["calib"]
        imgs, l2is = [], []
        for v in range(n_cam):
            path = path0.replace("image_0", f"image_{v}") if n_cam > 1 \
                else path0
            p_key = f"P{v}" if f"P{v}" in calib else "P2"
            img, l2i = self._load_view(path, calib[p_key], calib,
                                       flip=flip)
            imgs.append(img)
            l2is.append(l2i)
        return np.stack(imgs), np.stack(l2is)


class SyntheticDataset(SRFDetDataset):
    """Random scenes with planted boxes — tests and benchmarking."""

    def __init__(self, cfg: SRFDetConfig, length: int = 8,
                 test_mode: bool = False, augment: Optional[bool] = None,
                 seed: int = 0,
                 points_per_scene: int = 0, boxes_per_scene: int = 4):
        super().__init__(cfg, test_mode=test_mode, augment=augment,
                         seed=seed)
        self.length = length
        self.points_per_scene = points_per_scene or cfg.points_cap // 2
        self.boxes_per_scene = boxes_per_scene
        self.infos = [{"idx": i} for i in range(length)]

    def load_points(self, info: Dict,
                    rng: Optional[np.random.Generator] = None) -> np.ndarray:
        rng = np.random.default_rng(info["idx"] + 1)
        lo, hi = self.cfg.pc_range[:3], self.cfg.pc_range[3:6]
        n = self.points_per_scene
        pts = np.zeros((n, self.cfg.points_dim), np.float32)
        pts[:, 0] = rng.uniform(lo[0], hi[0], n)
        pts[:, 1] = rng.uniform(lo[1], hi[1], n)
        pts[:, 2] = rng.uniform(lo[2], hi[2], n)
        if self.cfg.points_dim > 3:
            pts[:, 3:] = rng.uniform(0, 1, (n, self.cfg.points_dim - 3))
        return pts

    def load_annotations(self, info: Dict):
        rng = np.random.default_rng(info["idx"] + 1000)
        g = self.boxes_per_scene
        lo, hi = self.cfg.pc_range[:3], self.cfg.pc_range[3:6]
        boxes = np.zeros((g, 9), np.float32)
        boxes[:, 0] = rng.uniform(lo[0] * 0.8, hi[0] * 0.8, g)
        boxes[:, 1] = rng.uniform(lo[1] * 0.8, hi[1] * 0.8, g)
        boxes[:, 2] = rng.uniform(lo[2] * 0.5, hi[2] * 0.5, g)
        boxes[:, 3:6] = rng.uniform(0.5, 4.0, (g, 3))
        boxes[:, 6] = rng.uniform(-np.pi, np.pi, g)
        labels = rng.integers(0, self.cfg.num_classes, g)
        return boxes, labels.astype(np.int64)

    def load_images(self, info: Dict, flip: bool = False):
        rng = np.random.default_rng(info["idx"] + 2000)
        n_cam = self.cfg.img.num_cams
        h, w = self.cfg.img.img_shape
        imgs = rng.normal(size=(n_cam, h, w, 3)).astype(np.float32)
        l2i = np.broadcast_to(np.eye(4, dtype=np.float32),
                              (n_cam, 4, 4)).copy()
        if flip:
            imgs = imgs[:, :, ::-1].copy()
            l2i = np.einsum("ij,njk->nik", _hflip_mat(w), l2i)
        return imgs, l2i


class CBGSWrapper:
    """Class-balanced grouping & sampling (mmdet3d CBGSDataset, used by the
    nuScenes train configs, cfg srfdet_voxel_nusc_L.py:302)."""

    def __init__(self, dataset: SRFDetDataset):
        self.dataset = dataset
        num_classes = dataset.cfg.num_classes
        cls_to_samples = {c: [] for c in range(num_classes)}
        for i in range(len(dataset)):
            for c in dataset.sample_categories(i):
                cls_to_samples[int(c)].append(i)
        frac = 1.0 / num_classes
        total = sum(len(v) for v in cls_to_samples.values())
        self.indices: List[int] = []
        rng = np.random.default_rng(0)
        for c, idxs in cls_to_samples.items():
            if not idxs:
                continue
            ratio = frac / (len(idxs) / max(total, 1))
            reps = int(len(idxs) * ratio)
            self.indices += list(
                rng.choice(idxs, reps, replace=True))
        if not self.indices:
            self.indices = list(range(len(dataset)))

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx):
        # outer index as rng salt: duplicates of an oversampled frame
        # must draw DIFFERENT augmentations (mmdet3d's fresh-randomness
        # behavior), and the epoch key still varies draws across epochs
        return self.dataset.getitem(self.indices[idx], salt=1 + idx)

    @property
    def cfg(self):
        return self.dataset.cfg

    @property
    def epoch(self):
        return self.dataset.epoch

    @epoch.setter
    def epoch(self, value):
        # tools/train.py sets dataset.epoch each epoch; without this
        # passthrough the hasattr gate silently left the inner dataset
        # at epoch 0 forever (identical augs every epoch)
        self.dataset.epoch = value


def collate_batch(samples: Sequence[Dict[str, np.ndarray]]
                  ) -> Dict[str, np.ndarray]:
    """Stack fixed-shape samples into a batch dict."""
    keys = samples[0].keys()
    return {k: np.stack([s[k] for s in samples]) for k in keys}
