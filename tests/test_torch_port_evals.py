"""The port's evaluators and formatters (`srfdet3d_torch/evals/`) against
the JAX package's on seeded frames: nuScenes mAP / NDS equal (both numpy),
KITTI AP_R40 and Waymo AP / APH within 1e-6 (each package's own float32
iou_3d: the port's runs on the device it is given, here the CPU).

The seeded scenes keep every prediction-GT IoU at least 1e-4 away from
the match thresholds (0.5, 0.7), so a last-ulp difference between the
two iou_3d cannot flip a match; the test checks that margin.  One further
case puts an IoU exactly on a threshold, as stated there.
"""

from importlib import import_module

import numpy as np
import pytest
import torch

from srfdet3d_torch.geometry.iou import iou_3d

# the modules, not the functions of the same names the packages export
jfmt, jk, jn, jw = (import_module(f"srfdet3d_tpu.evals.{m}") for m in (
    "formatters", "kitti_eval", "nuscenes_eval", "waymo_eval"))
tfmt, tk, tn, tw = (import_module(f"srfdet3d_torch.evals.{m}") for m in (
    "formatters", "kitti_eval", "nuscenes_eval", "waymo_eval"))

NUS = ("car", "truck", "construction_vehicle", "bus", "trailer", "barrier",
       "motorcycle", "bicycle", "pedestrian", "traffic_cone")
KITTI = ("Pedestrian", "Cyclist", "Car")
WAYMO = ("Car", "Pedestrian", "Cyclist")
AP_TOL = 1e-6


def frames(seed, classes, n_frames=8, per_class=4, box_dim=9, extent=45.0):
    """Seeded (gts, preds): per frame `per_class` GT boxes of each class
    (gravity-centre z) in shuffled order; per GT one jittered prediction
    of its class, a fifth of them moved 5 m away (a miss and a false
    positive), and one more false positive a class, with scores.  Every
    (frame, class) pair has the same shapes, so the JAX package's eager
    iou_3d compiles once."""
    rng = np.random.default_rng(seed)
    gts, preds = [], []
    n_gt = per_class * len(classes)
    for _ in range(n_frames):
        g = np.zeros((n_gt, box_dim), np.float32)
        g[:, :2] = rng.uniform(-extent, extent, (n_gt, 2))
        g[:, 2] = rng.uniform(-1, 1, n_gt)
        g[:, 3:6] = rng.uniform(0.5, 4.5, (n_gt, 3))
        g[:, 6] = rng.uniform(-np.pi, np.pi, n_gt)
        if box_dim > 7:
            g[:, 7:9] = rng.normal(0, 3, (n_gt, 2))
        names = np.array(classes)[rng.permutation(
            np.repeat(np.arange(len(classes)), per_class))]
        p = g.copy()
        p[:, :3] += rng.normal(0, 0.25, (n_gt, 3))
        p[:, 3:6] *= rng.uniform(0.85, 1.15, (n_gt, 3))
        p[:, 6] += rng.normal(0, 0.2, n_gt)
        p[rng.random(n_gt) < 0.2, 0] += 5.0
        fp = np.zeros((len(classes), box_dim), np.float32)
        fp[:, :2] = rng.uniform(-extent, extent, (len(classes), 2))
        fp[:, 3:6] = rng.uniform(0.5, 4, (len(classes), 3))
        p = np.concatenate([p, fp])
        pn = np.concatenate([names, np.array(classes)])
        gts.append({"boxes": g, "labels_name": names,
                    "num_points": rng.integers(0, 40, n_gt),
                    "attrs": np.array(["a", "b", ""])[
                        rng.integers(0, 3, n_gt)]})
        preds.append({"boxes": p, "labels_name": pn,
                      "scores": rng.uniform(0.05, 1, len(p)
                                            ).astype(np.float32),
                      "attrs": np.array(["a", "b"])[
                          rng.integers(0, 2, len(p))]})
    return gts, preds


def iou_margin(gts, preds, thresholds=(0.5, 0.7)):
    """The least distance of any prediction-GT IoU to a threshold."""
    m = np.inf
    for g, p in zip(gts, preds):
        if len(g["boxes"]) and len(p["boxes"]):
            iou = iou_3d(torch.from_numpy(p["boxes"][:, :7]),
                         torch.from_numpy(g["boxes"][:, :7])).numpy()
            m = min(m, min(float(np.abs(iou - t).min()) for t in thresholds))
    return m


def _same_metrics(a, b, tol):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            _same_metrics(a[k], b[k], tol)
        elif tol == 0:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            np.testing.assert_allclose(b[k], a[k], rtol=0, atol=tol,
                                       err_msg=k)


@pytest.mark.parametrize("seed", [0, 1])
def test_nuscenes_eval_equals_jax(seed):
    gts, preds = frames(seed, NUS)
    res = tn.nuscenes_eval(gts, preds, NUS)
    _same_metrics(jn.nuscenes_eval(gts, preds, NUS), res, 0)
    assert 0 < res["mAP"] < 1 and 0 < res["NDS"] < 1


@pytest.mark.parametrize("seed", [2, 3])
def test_kitti_eval_matches_jax(seed):
    gts, preds = frames(seed, KITTI, n_frames=12, box_dim=7, extent=30.0)
    assert iou_margin(gts, preds) >= 1e-4
    res = tk.kitti_eval(gts, preds, KITTI, device="cpu")
    _same_metrics(jk.kitti_eval(gts, preds, KITTI), res, AP_TOL)
    assert res["mAP_3d_moderate"] > 0


@pytest.mark.parametrize("seed", [4, 5])
def test_waymo_eval_matches_jax(seed):
    gts, preds = frames(seed, WAYMO, n_frames=6, extent=60.0)
    assert iou_margin(gts, preds) >= 1e-4
    kw = dict(range_breakdown=True, velocity_breakdown=True)
    res = tw.waymo_eval(gts, preds, WAYMO, device="cpu", **kw)
    _same_metrics(jw.waymo_eval(gts, preds, WAYMO, **kw), res, AP_TOL)
    assert res["mAPH_L2"] > 0


def test_iou_on_a_threshold():
    """Pedestrian predictions whose IoU with their GT is 0.5 in exact
    arithmetic (the GT's box at half its length, yaw 1).  Both packages
    compute it above 0.5 (the intersection's 1e-4 edge shrink), and can
    differ in the last place there (at x = 5: 0.50005162 and 0.50005168).  The
    match threshold is KITTI's strict `>` 0.5 and Waymo's `>=` 0.5; both
    take the match on both sides, so every AP is 1 on both."""
    g = np.array([[5.0, 2.0, -1.0, 0.8, 1.0, 1.8, 1.0]], np.float32)
    p = g.copy()
    p[0, 4] = 0.5
    p[0, 0] += 0.25 * np.sin(1.0)
    p[0, 1] -= 0.25 * np.cos(1.0)
    iou = float(tk._iou3d_np(p, g, torch.device("cpu"))[0, 0])
    assert 0.5 < iou < 0.5 + 1e-4
    # 45 such pairs 3 m apart in one frame: past the 41 recall slots of
    # AP_R40, and one iou_3d call
    n = 45
    shift = np.zeros((n, 7), np.float32)
    shift[:, 0] = 3.0 * np.arange(n)
    names = np.array(["Pedestrian"] * n)
    gts = [{"boxes": g + shift, "labels_name": names}]
    preds = [{"boxes": p + shift, "labels_name": names,
              "scores": np.full(n, 0.9, np.float32)}]
    res = tk.kitti_eval(gts, preds, KITTI, device="cpu")
    _same_metrics(jk.kitti_eval(gts, preds, KITTI), res, AP_TOL)
    assert res["Pedestrian_3d_easy"] == 1.0
    res = tw.waymo_eval(gts, preds, WAYMO, device="cpu")
    _same_metrics(jw.waymo_eval(gts, preds, WAYMO), res, AP_TOL)
    assert res["Pedestrian_AP_L2"] == 1.0


def test_kitti_statistics_match_scalar_oracle():
    rng = np.random.default_rng(7)
    for _ in range(200):
        nd, ng = rng.integers(0, 8, 2)
        ious = rng.uniform(0, 1, (nd, ng))
        gt_ign = rng.integers(-1, 2, ng)
        det_ign = rng.integers(-1, 2, nd)
        scores = rng.uniform(0, 1, nd)
        for fp in (False, True):
            args = (ious, gt_ign, det_ign, scores, 0.5, 0.3, fp)
            assert tk.compute_statistics(*args) == \
                tk.compute_statistics_ref(*args) == \
                jk.compute_statistics(*args)
    s = rng.uniform(0, 1, 60)
    assert tk.get_thresholds(s, 70) == jk.get_thresholds(s, 70)


def test_formatters_equal_jax(tmp_path):
    _, preds = frames(8, NUS, n_frames=2)
    nus = [dict(p, sample_token=f"t{i}") for i, p in enumerate(preds)]
    assert tfmt.format_nuscenes_results(nus, str(tmp_path / "a.json")) == \
        jfmt.format_nuscenes_results(nus, str(tmp_path / "b.json"))
    assert (tmp_path / "a.json").read_text() == \
        (tmp_path / "b.json").read_text()
    _, kpreds = frames(9, KITTI, n_frames=2, box_dim=7)
    l2c = np.array([[0, -1, 0, 0], [0, 0, -1, -0.08], [1, 0, 0, -0.27],
                    [0, 0, 0, 1]], float)
    p2 = np.array([[721.5, 0, 609.6, 44.9], [0, 721.5, 172.9, 0.2],
                   [0, 0, 1, 0.003], [0, 0, 0, 1]])
    kit = [dict(p, frame_id=i, lidar2cam=l2c, P2=p2, img_shape=(375, 1242))
           for i, p in enumerate(kpreds)]
    assert tfmt.format_kitti_results(kit, str(tmp_path / "ka")) == \
        jfmt.format_kitti_results(kit, str(tmp_path / "kb"))
    for i in range(2):
        assert (tmp_path / "ka" / f"{i:06d}.txt").read_text() == \
            (tmp_path / "kb" / f"{i:06d}.txt").read_text()
