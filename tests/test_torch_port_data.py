"""The port's data pipeline (`srfdet3d_torch/data/`) against the JAX
package's: the point transforms, the box helpers, DBSampler, the four
datasets from seeded info pickles (L and LC, augment on and off, the KITTI
synced flip), CBGS, collate and the loader.

The JAX package can route its range filter, shuffle and pad through a C++
extension whose shuffle draws differ from numpy's; every test here turns
that route off (`srfdet3d_tpu.data.native._NATIVE = False`) and requires
the port's samples to equal the JAX package's numpy-path samples bit for
bit, on every key.  The one exception is a resized camera frame: the port
resizes in PyTorch and the JAX package in PIL, within 0.05 grey levels on
0-255 (test_torch_port_img_transforms.py), so after the normalization
(std >= 57.12) within 0.05 / 57.12 < 1e-3.
"""

import dataclasses

import numpy as np
import pytest

import srfdet3d_tpu.data.native as jnative
from srfdet3d_tpu import config as jcfg
from srfdet3d_tpu import configs as jconfigs
from srfdet3d_tpu.data import box_np as jbox
from srfdet3d_tpu.data import datasets as jds
from srfdet3d_tpu.data import loader as jloader
from srfdet3d_tpu.data import transforms as jT
from srfdet3d_torch import config as tcfg
from srfdet3d_torch import configs as tconfigs
from srfdet3d_torch.data import box_np as tbox
from srfdet3d_torch.data import datasets as tds
from srfdet3d_torch.data import loader as tloader
from srfdet3d_torch.data import synthetic_root as roots
from srfdet3d_torch.data import transforms as tT

NORM_RESIZE_TOL = 1e-3


@pytest.fixture(autouse=True)
def jax_numpy_path(monkeypatch):
    monkeypatch.setattr(jnative, "_NATIVE", False)


def assert_same(a, b, msg=""):
    if a is None or b is None:
        assert a is None and b is None, msg
        return
    assert a.dtype == b.dtype and a.shape == b.shape, msg
    np.testing.assert_array_equal(a, b, err_msg=msg)


def assert_same_sample(j, t, resized=False):
    assert sorted(j) == sorted(t)
    for k in j:
        if k == "images" and resized:
            assert j[k].dtype == t[k].dtype and j[k].shape == t[k].shape
            np.testing.assert_allclose(t[k], j[k], rtol=0,
                                       atol=NORM_RESIZE_TOL, err_msg=k)
        else:
            assert_same(j[k], t[k], k)


def scene(seed, n=3000, g=6, dim=5):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-20, 20, (n, dim)).astype(np.float32)
    pts[:, 2] = rng.uniform(-3, 1, n)
    boxes = np.zeros((g, 9), np.float32)
    boxes[:, :2] = rng.uniform(-15, 15, (g, 2))
    boxes[:, 2] = -2.0
    boxes[:, 3:6] = rng.uniform(0.5, 4, (g, 3))
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, g)
    boxes[:, 7:] = rng.normal(0, 1, (g, 2))
    labels = rng.integers(-1, 4, g)
    return pts, boxes, labels


def test_box_np_matches_jax():
    pts, boxes, _ = scene(0)
    for f in ("points_in_boxes_bev", "points_in_boxes_3d"):
        assert_same(getattr(jbox, f)(pts, boxes), getattr(tbox, f)(pts, boxes))
    assert_same(jbox.box_corners_bev(boxes), tbox.box_corners_bev(boxes))
    for i in range(len(boxes)):
        others = np.delete(boxes, i, 0)
        assert_same(jbox.bev_overlap_exact(boxes[i], others),
                    tbox.bev_overlap_exact(boxes[i], others))
    assert_same(jbox.bev_overlap_exact(boxes[0], boxes[:0]),
                tbox.bev_overlap_exact(boxes[0], boxes[:0]))


def test_point_transforms_match_jax():
    pts, boxes, labels = scene(1)
    pc = (-10.0, -10.0, -5.0, 10.0, 10.0, 3.0)
    rot = dict(rot_range=(-0.785, 0.785), scale_range=(0.9, 1.1),
               trans_std=(0.5, 0.5, 0.5))
    for seed in range(3):
        outs = [m.global_rot_scale_trans(pts, boxes,
                                         np.random.default_rng(seed), **rot)
                for m in (jT, tT)]
        for a, b in zip(*outs):
            assert_same(a, b)
        outs = [m.random_flip_3d(pts, boxes, np.random.default_rng(seed))
                for m in (jT, tT)]
        assert outs[0][2] == outs[1][2]
        for a, b in zip(outs[0][:2], outs[1][:2]):
            assert_same(a, b)
        outs = [m.object_noise(pts, boxes, np.random.default_rng(seed))
                for m in (jT, tT)]
        for a, b in zip(*outs):
            assert_same(a, b)
        assert_same(jT.point_shuffle(pts, np.random.default_rng(seed)),
                    tT.point_shuffle(pts, np.random.default_rng(seed)))
        for cap, shuffle in ((512, True), (4096, True), (4096, False)):
            ja = jnative.filter_pad_fast(pts, pc, cap, shuffle, seed)
            ta = tT.filter_pad(pts, pc, cap, shuffle, seed)
            for a, b in zip(ja, ta):
                assert_same(a, b)
    assert_same(jT.flip_horizontal_3d(pts.copy(), boxes.copy())[1],
                tT.flip_horizontal_3d(pts.copy(), boxes.copy())[1])
    assert_same(jT.points_range_filter(pts, pc),
                tT.points_range_filter(pts, pc))
    for a, b in zip(jT.object_range_filter(boxes, labels, pc),
                    tT.object_range_filter(boxes, labels, pc)):
        assert_same(a, b)
    for a, b in zip(jT.object_name_filter(boxes, labels, 3),
                    tT.object_name_filter(boxes, labels, 3)):
        assert_same(a, b)
    for cap in (4, 16):
        for dim in (7, 9):
            for a, b in zip(jT.pad_gts(boxes, labels, cap, dim),
                            tT.pad_gts(boxes, labels, cap, dim)):
                assert_same(a, b)
        for a, b in zip(jT.pad_points(pts, cap), tT.pad_points(pts, cap)):
            assert_same(a, b)
    ang = np.linspace(-10, 10, 101)
    assert_same(jT.limit_period(ang), tT.limit_period(ang))


def test_sweeps_and_db_sampler_match_jax(tmp_path):
    r = roots.write_nuscenes_root(str(tmp_path), n_train=1, n_val=0,
                                  points=800, sweeps=5, boxes=10,
                                  db_per_class=4, seed=3)
    import pickle
    with open(r["train"], "rb") as f:
        info = pickle.load(f)["infos"][0]
    key = tT.load_points_bin(str(tmp_path / info["lidar_path"]), 5)
    assert_same(jT.load_points_bin(str(tmp_path / info["lidar_path"]), 5,
                                   (0, 1, 2)),
                tT.load_points_bin(str(tmp_path / info["lidar_path"]), 5,
                                   (0, 1, 2)))
    sweeps = [dict(s, data_path=str(tmp_path / s["data_path"]))
              for s in info["sweeps"]]
    for kw in (dict(sweeps_num=3, rng_seed=4), dict(sweeps_num=3, test=True),
               dict(sweeps_num=10, rng_seed=5)):
        outs = [m.multi_sweep_aggregate(
            key, sweeps, kw["sweeps_num"],
            rng=(np.random.default_rng(kw["rng_seed"]) if "rng_seed" in kw
                 else None), test_mode=kw.get("test", False),
            key_timestamp_us=float(info["timestamp"])) for m in (jT, tT)]
        assert_same(*outs)
    pts, boxes, labels = scene(5, g=4)
    labels = np.abs(labels) % 10
    groups = dict(car=4, truck=3, bus=2, pedestrian=5, barrier=3)
    samplers = [m.DBSampler(info_path=r["db"], data_root=r["root"],
                            classes=roots.NUS_CLASSES, sample_groups=groups,
                            min_points={c: 60 for c in roots.NUS_CLASSES})
                for m in (jT, tT)]
    pasted = 0
    for seed in range(3):
        outs = [s.apply(pts, boxes, labels, np.random.default_rng(seed))
                for s in samplers]
        for a, b in zip(*outs):
            assert_same(a, b)
        pasted += len(outs[1][1]) - len(boxes)
    assert pasted > 0


# ---- datasets from seeded info pickles -------------------------------------

@pytest.fixture(scope="module")
def data_roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("roots")
    return {
        "nus": roots.write_nuscenes_root(
            str(base / "nus"), n_train=3, n_val=1, points=1500, sweeps=4,
            boxes=14, cams=True, img_hw=(60, 90), image_ext=".png",
            db_per_class=3, seed=10),
        "kitti": roots.write_kitti_root(
            str(base / "kitti"), n_train=3, n_val=1, points=3000, boxes=8,
            img_hw=(60, 90), image_ext=".png", db_per_class=3, seed=11),
        "kitti_big": roots.write_kitti_root(
            str(base / "kitti_big"), n_train=2, n_val=0, points=2000,
            boxes=6, img_hw=(70, 110), image_ext=".png", db_per_class=0,
            seed=12),
        "waymo": roots.write_waymo_root(
            str(base / "waymo"), n_train=2, n_val=1, points=3000, boxes=8,
            views=5, img_hw=(128, 192), image_ext=".png", seed=13),
    }


def _img(mod, **kw):
    return dataclasses.replace(mod.ImgBranchConfig(), **kw)


def make_cfg(case, configs, config):
    """The config of a dataset case in one package (`configs`, `config`
    are that package's modules); the dataset reads only its data fields,
    so the capacities are cut to the test's scene sizes."""
    small = dict(points_cap=4096, gt_cap=24)
    if case.startswith("nus"):
        cfg = configs.get_config("srfdet_voxel_nusc_L").replace(**small)
        if case == "nus_lc":
            lc = configs.get_config("srfdet_voxel_nusc_LC")
            cfg = lc.replace(img=dataclasses.replace(
                lc.img, img_shape=(64, 96)), **small)
        return cfg
    if case.startswith("kitti"):
        cfg = configs.get_config("srfdet_voxel_kitti_L").replace(**small)
        if case != "kitti_l":
            lc = configs.get_config("srfdet_voxel_kitti_LC")
            # sync_flip_2d with flip ratio 1 takes the synced flip
            cfg = lc.replace(img=dataclasses.replace(
                lc.img, img_shape=(64, 96)), aug=dataclasses.replace(
                lc.aug, flip_horizontal=1.0), **small)
        return cfg
    if case.startswith("waymo"):
        name = "srfdet_dvoxel_waymo_LC" if case == "waymo_lc" else \
            "srfdet_dvoxel_waymo_L"
        cfg = configs.get_config(name).replace(**small)
        if cfg.use_img:
            cfg = cfg.replace(img=dataclasses.replace(cfg.img,
                                                      img_shape=(64, 96)))
        return cfg
    cfg = configs.tiny_test_config()
    if case == "synthetic_lc":
        cfg = cfg.replace(use_img=True, img=_img(
            config, num_cams=2, img_shape=(32, 48)),
            aug=dataclasses.replace(cfg.aug, sync_flip_2d=True,
                                    flip_horizontal=1.0))
    return cfg


def make_datasets(case, roots_, augment):
    out = []
    for configs, config, ds_mod, T in ((jconfigs, jcfg, jds, jT),
                                       (tconfigs, tcfg, tds, tT)):
        cfg = make_cfg(case, configs, config)
        if case.startswith("synthetic"):
            out.append(ds_mod.SyntheticDataset(cfg, length=3, seed=7,
                                               augment=augment,
                                               points_per_scene=600))
            continue
        r = roots_["kitti_big" if case == "kitti_lc_resize" else
                   case.split("_")[0]]
        sampler = None
        if augment and "db" in r:
            sampler = T.DBSampler(
                info_path=r["db"], data_root=r["root"],
                classes=cfg.class_names,
                sample_groups={c: 3 for c in cfg.class_names},
                min_points={c: 5 for c in cfg.class_names},
                points_load_dim=cfg.points_dim,
                points_use_dim=tuple(range(cfg.points_dim)))
        cls = {"nus": ds_mod.NuScenesDataset, "kitti": ds_mod.KittiDataset,
               "waymo": ds_mod.WaymoDataset}[case.split("_")[0]]
        kw = dict(sweeps_num=2) if case.startswith("nus") else {}
        out.append(cls(cfg, info_path=r["train"], data_root=r["root"],
                       augment=augment, seed=5, db_sampler=sampler, **kw))
    return out


CASES = [("nus_l", True), ("nus_l", False), ("nus_lc", True),
         ("nus_lc", False), ("kitti_l", True), ("kitti_l", False),
         ("kitti_lc", True), ("kitti_lc", False), ("kitti_lc_resize", True),
         ("waymo_l", True), ("waymo_l", False), ("waymo_lc", True),
         ("waymo_lc", False), ("synthetic_l", True), ("synthetic_l", False),
         ("synthetic_lc", True), ("synthetic_lc", False)]


@pytest.mark.parametrize("case,augment", CASES)
def test_dataset_samples_match_jax(data_roots, case, augment):
    """Every sample of the dataset, two epochs, on every key."""
    jd, td = make_datasets(case, data_roots, augment)
    assert len(jd) == len(td)
    resized = case in ("waymo_lc", "kitti_lc_resize")
    for epoch in (0, 1):
        jd.epoch = td.epoch = epoch
        for i in range(len(jd)):
            j, t = jd[i], td[i]
            assert_same_sample(j, t, resized)
    if augment and case.startswith(("kitti_lc", "synthetic_lc")):
        # the synced flip ran: the projection differs from the unflipped
        _, plain = make_datasets(case, data_roots, False)
        plain.epoch = td.epoch
        assert not np.array_equal(plain[len(td) - 1]["lidar2img"],
                                  t["lidar2img"])


def test_cbgs_collate_and_loader_match_jax(data_roots):
    jd, td = make_datasets("nus_l", data_roots, True)
    jw, tw = jds.CBGSWrapper(jd), tds.CBGSWrapper(td)
    assert jw.indices == tw.indices and len(tw) > len(td)
    jw.epoch = tw.epoch = 2
    assert td.epoch == 2
    for i in (0, len(tw) - 1):
        assert_same_sample(jw[i], tw[i])
    for skip, workers in ((0, 0), (2, 3), (100, 2)):
        jb = list(jloader.data_loader(jw, 3, seed=4, num_workers=workers,
                                      skip_batches=skip))
        tb = list(tloader.data_loader(tw, 3, seed=4, num_workers=workers,
                                      skip_batches=skip))
        assert len(jb) == len(tb) == max(len(tw) // 3 - skip, 0)
        for a, b in zip(jb, tb):
            assert_same_sample(a, b)
    # ragged tail without drop_last, no shuffle
    jb = list(jloader.data_loader(jd, 2, shuffle=False, num_workers=2,
                                  drop_last=False))
    tb = list(tloader.data_loader(td, 2, shuffle=False, num_workers=2,
                                  drop_last=False))
    assert [b["points"].shape[0] for b in tb] == [2, 1]
    for a, b in zip(jb, tb):
        assert_same_sample(a, b)
    samples = [td[i] for i in range(len(td))]
    assert_same_sample(jds.collate_batch(samples), tds.collate_batch(samples))


def test_npy_frames_equal_png_frames(tmp_path):
    """A frame stored as .npy (the card machine has no PIL) gives the same
    sample as the same frame stored as PNG."""
    a = roots.write_nuscenes_root(str(tmp_path / "png"), n_train=1, n_val=0,
                                  points=500, sweeps=1, boxes=4, cams=True,
                                  img_hw=(40, 60), image_ext=".png", seed=2)
    b = roots.write_nuscenes_root(str(tmp_path / "npy"), n_train=1, n_val=0,
                                  points=500, sweeps=1, boxes=4, cams=True,
                                  img_hw=(40, 60), image_ext=".npy", seed=2)
    cfg = make_cfg("nus_lc", tconfigs, tcfg)
    s = [tds.NuScenesDataset(cfg, info_path=r["train"], data_root=r["root"],
                             augment=False)[0] for r in (a, b)]
    assert_same_sample(*s)


def test_are_points_in_image_matches_jax():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-30, 30, (500, 3)).astype(np.float32)
    l2i = np.eye(4, dtype=np.float32)
    l2i[:3, :3] = [[0, -800, 320], [0, 0, 240], [1, 0, 0]]
    l2i = l2i @ np.array([[0, 0, 1, 0], [1, 0, 0, 0], [0, 1, 0, 0],
                          [0, 0, 0, 1]], np.float32).T
    assert_same(jds.are_points_in_image(pts, l2i, (480, 640)),
                tds.are_points_in_image(pts, l2i, (480, 640)))
    assert_same(jds._hflip_mat(97), tds._hflip_mat(97))
