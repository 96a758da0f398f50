"""The port's visualisation (`srfdet3d_torch/vis/`, the datasets' `show()`,
`tools/show_results_from_pkl.py`, `tools/mix_imgs_convert_video.py`)
against the JAX package's.

Exact: BEV and camera renders decode to the same pixels (and the returned
arrays are equal), the .obj and .ply files are byte for byte the same,
`dataset.show()` on a seeded root with six cameras writes the same files
(the frames fit the canvas in pad mode, so no resize runs: the port
resizes in PyTorch, within 0.05 grey levels of PIL), and the two CLIs
write the same images and a video whose frames decode the same.
Importing the port pulls in no cv2 (test_torch_port_voxelize.py); a draw
without cv2 raises ImportError naming it.
"""

import dataclasses
import os
import pickle
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from srfdet3d_tpu import config as jcfg                        # noqa: E402
from srfdet3d_tpu import configs as jconfigs                   # noqa: E402
from srfdet3d_tpu import vis as jvis                           # noqa: E402
from srfdet3d_tpu.data import datasets as jds                  # noqa: E402
from srfdet3d_torch import config as tcfg                      # noqa: E402
from srfdet3d_torch import configs as tconfigs                 # noqa: E402
from srfdet3d_torch import vis as tvis                         # noqa: E402
from srfdet3d_torch.data import datasets as tds                # noqa: E402
from srfdet3d_torch.data import synthetic_root as roots        # noqa: E402
from srfdet3d_torch.tools import mix_imgs_convert_video as tmix  # noqa: E402
from srfdet3d_torch.tools import show_results_from_pkl as tshow  # noqa: E402
from tools import mix_imgs_convert_video as jmix               # noqa: E402
from tools import show_results_from_pkl as jshow               # noqa: E402


def scene(seed, n_boxes=5):
    rng = np.random.default_rng(seed)
    pts = np.zeros((4000, 6), np.float32)
    pts[:, :2] = rng.uniform(-50, 50, (4000, 2))
    pts[:, 2] = rng.uniform(-3, 1, 4000)
    pts[:, 3:] = rng.integers(0, 256, (4000, 3))
    boxes = np.zeros((n_boxes, 7), np.float32)
    boxes[:, :2] = rng.uniform(-30, 30, (n_boxes, 2))
    boxes[:, 2] = -1.6
    boxes[:, 3:6] = rng.uniform(0.6, 5, (n_boxes, 3))
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, n_boxes)
    return pts, boxes, rng.integers(0, 12, n_boxes)


def read(path):
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    assert img is not None, path
    return img


def same_tree(a, b):
    """Every file under a and b: images by pixels, others by bytes."""
    fa, fb = sorted(os.listdir(a)), sorted(os.listdir(b))
    assert fa == fb and fa
    for f in fa:
        pa, pb = os.path.join(a, f), os.path.join(b, f)
        if f.endswith((".png", ".jpg")):
            np.testing.assert_array_equal(read(pa), read(pb), err_msg=f)
        else:
            with open(pa, "rb") as x, open(pb, "rb") as y:
                assert x.read() == y.read(), f
    return fa


def test_bev_and_camera_renders_match_jax(tmp_path):
    pts, gt, gl = scene(0)
    _, pred, pl = scene(1)
    for kw in ({}, {"pred_labels": pl, "gt_labels": gl},
               {"pc_range": (0.0, -40.0, -3.0, 70.4, 40.0, 1.0),
                "pixels_per_meter": 10.0}):
        outs = []
        for tag, mod in (("j", jvis), ("t", tvis)):
            path = str(tmp_path / tag / "bev.png")
            arr = mod.show_bev_result(pts, gt, pred, path, **kw)
            outs.append((arr, read(path)))
        np.testing.assert_array_equal(outs[0][0], outs[1][0])
        np.testing.assert_array_equal(outs[0][1], outs[1][1])
        assert (outs[1][0] > 0).any()
    # a camera looking along +x: boxes in front project into the frame
    k = np.array([[400.0, 0, 320], [0, 400.0, 180], [0, 0, 1]])
    l2c = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], np.float64)
    l2i = np.eye(4)
    l2i[:3, :3] = k @ l2c
    l2i[:3, 3] = k @ np.array([0.0, 0.3, 0.2])
    front = pred.copy()
    front[:, 0] = np.abs(front[:, 0]) + 5
    img = np.random.default_rng(2).integers(0, 255, (360, 640, 3))
    for kw in ({}, {"gt_boxes": gt, "labels": pl}):
        outs = [mod.show_multi_modality_result(
            img.astype(np.float32), front, l2i,
            str(tmp_path / tag / "cam.png"), **kw)
            for tag, mod in (("j", jvis), ("t", tvis))]
        np.testing.assert_array_equal(outs[0], outs[1])
        np.testing.assert_array_equal(read(str(tmp_path / "j" / "cam.png")),
                                      read(str(tmp_path / "t" / "cam.png")))
        assert (outs[1] != img).any()           # something was drawn


def test_obj_and_ply_files_match_jax(tmp_path):
    pts, gt, _ = scene(3)
    _, pred, _ = scene(4)
    for tag, mod in (("j", jvis), ("t", tvis)):
        mod.show_result(pts, gt, pred, str(tmp_path / tag), "f0")
        mod.show_result(pts[:, :4], None, pred[:2], str(tmp_path / tag),
                        "f1")
    files = same_tree(str(tmp_path / "j"), str(tmp_path / "t"))
    assert files == ["f0_gt.ply", "f0_points.obj", "f0_pred.ply",
                     "f1_points.obj", "f1_pred.ply"]


def test_draw_without_cv2_names_it(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    pts, gt, _ = scene(5)
    with pytest.raises(ImportError, match="cv2"):
        tvis.show_bev_result(pts, gt, None, str(tmp_path / "b.png"))
    tvis.write_ply(gt, str(tmp_path / "b.ply"))     # needs no cv2


def lc_config(configs, config):
    cfg = configs.tiny_test_config()
    return cfg.replace(
        class_names=roots.NUS_CLASSES, points_cap=8192, gt_cap=40,
        use_img=True,
        img=dataclasses.replace(config.ImgBranchConfig(),
                                backbone="vovnet-19-slim", num_cams=6,
                                img_shape=(64, 96), mode="pad"))


@pytest.fixture(scope="module")
def lc_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nus_lc"))
    return roots.write_nuscenes_root(root, n_train=2, n_val=0, points=3000,
                                     sweeps=1, boxes=8, cams=True,
                                     img_hw=(60, 80), image_ext=".png",
                                     db_per_class=0, seed=4)


def results(n, seed):
    out = []
    for i in range(n):
        _, boxes, labels = scene(seed + i, 6)
        boxes[:, :2] /= 3                        # near the cameras
        scores = np.linspace(0.9, 0.05, 6)
        out.append({"boxes": boxes, "scores": scores,
                    "labels": labels % 10})
    return out


def test_dataset_show_matches_jax(tmp_path, lc_root):
    res = results(2, 10)
    for tag, configs, config, ds_mod in (("j", jconfigs, jcfg, jds),
                                         ("t", tconfigs, tcfg, tds)):
        ds = ds_mod.NuScenesDataset(lc_config(configs, config),
                                    info_path=lc_root["train"],
                                    data_root=lc_root["root"],
                                    test_mode=True)
        n = ds.show(res, str(tmp_path / tag), score_thr=0.2, save_3d=True)
        assert n == 2
    files = same_tree(str(tmp_path / "j"), str(tmp_path / "t"))
    assert "00001_bev.png" in files and "00001_v6.png" in files
    assert "00000_points.obj" in files and "00000_pred.ply" in files


def run_tool(mod, argv, monkeypatch):
    """A tool's main() with its argv (the JAX tools read sys.argv)."""
    monkeypatch.setattr(sys, "argv", [mod.__name__, *argv])
    mod.main()


def test_show_results_and_video_clis_match_jax(tmp_path, lc_root,
                                               monkeypatch):
    pts, _, _ = scene(7)
    preds = results(2, 20)
    gts = [{"boxes": r["boxes"][:3].copy()} for r in results(2, 30)]
    for p in preds:
        p["boxes"] = p["boxes"].copy()
        p["boxes"][:, 2] += p["boxes"][:, 5] / 2     # gravity centre
    preds[0]["points"] = pts
    dump = str(tmp_path / "res.pkl")
    with open(dump, "wb") as f:
        pickle.dump({"gts": gts, "preds": preds}, f)
    for tag, show in (("j", jshow), ("t", tshow)):
        run_tool(show, [dump, "--out-dir", str(tmp_path / f"bev_{tag}"),
                        "--max-frames", "5"], monkeypatch)
        run_tool(show, [dump, "--out-dir", str(tmp_path / f"ds_{tag}"),
                        "--config", "srfdet_voxel_nusc_L", "--info-path",
                        lc_root["train"], "--data-root", lc_root["root"],
                        "--save-3d"], monkeypatch)
    assert same_tree(str(tmp_path / "bev_j"), str(tmp_path / "bev_t")) == \
        ["frame_0000.png", "frame_0001.png"]
    assert "00000_bev.png" in same_tree(str(tmp_path / "ds_j"),
                                        str(tmp_path / "ds_t"))
    frames = {}
    for tag, mix in (("j", jmix), ("t", tmix)):
        out = str(tmp_path / f"{tag}.mp4")
        run_tool(mix, ["--bev-dir", str(tmp_path / f"bev_{tag}"),
                       "--cam-dirs", str(tmp_path / f"ds_{tag}"),
                       "--out", out, "--fps", "2"], monkeypatch)
        cap = cv2.VideoCapture(out)
        frames[tag] = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames[tag].append(frame)
        cap.release()
    assert len(frames["t"]) == 2
    for a, b in zip(frames["j"], frames["t"]):
        np.testing.assert_array_equal(a, b)
