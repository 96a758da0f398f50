"""`python -m srfdet3d_torch.tools.create_data` against the JAX package's
`tools/create_data.py` on the same raw trees (the port's writers
`synthetic_root.write_raw_kitti_root` / `write_raw_nuscenes_root`, written
twice from one seed, one copy a tool: each tool writes its GT database
under its data root).

Exact: every info and dbinfo pickle field by field (arrays bit for bit
with their dtypes and shapes, strings and relative paths equal), and
every GT-database .bin byte for byte.  The writers' trees are also held
against the boxes they were written from (float32 rounding of the label
text and the transforms: 1e-4 m and rad).
"""

import os
import pickle

import numpy as np
import pytest

from srfdet3d_torch.data import synthetic_root as roots
from srfdet3d_torch.tools import create_data as tcreate
from tools import create_data as jcreate

BOX_TOL = 1e-4


def assert_same(a, b, where="root"):
    assert type(a) is type(b), (where, type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b), (where, list(a), list(b))
        for k in a:
            assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert a.tobytes() == b.tobytes(), where
    else:
        assert a == b, (where, a, b)


def run_both(tmp_path, write, argv):
    """The same tree twice; JAX's tool on one, the port's on the other.
    Returns the two roots."""
    out = []
    for tag, tool in (("jax", jcreate), ("port", tcreate)):
        root = str(tmp_path / tag)
        write(root)
        tool.main([argv[0], "--root", root, *argv[1:]])
        out.append(root)
    return out


def assert_same_outputs(jroot, troot):
    files = sorted(f for f in os.listdir(jroot) if f.endswith(".pkl"))
    assert files == sorted(f for f in os.listdir(troot)
                           if f.endswith(".pkl"))
    assert any("dbinfos" in f for f in files)
    for f in files:
        with open(os.path.join(jroot, f), "rb") as fj, \
                open(os.path.join(troot, f), "rb") as ft:
            assert_same(pickle.load(fj), pickle.load(ft), f)
    db = sorted(os.listdir(os.path.join(jroot, "gt_database")))
    assert db and db == sorted(os.listdir(os.path.join(troot,
                                                       "gt_database")))
    for f in db:
        with open(os.path.join(jroot, "gt_database", f), "rb") as fj, \
                open(os.path.join(troot, "gt_database", f), "rb") as ft:
            assert fj.read() == ft.read(), f


@pytest.mark.parametrize("name", ["kitti", "waymo"])
def test_kitti_tree(tmp_path, name):
    tree = {}

    def write(root):
        tree.update(roots.write_raw_kitti_root(
            root, n_train=3, n_val=2, points=3000, boxes=6, per_box=40,
            seed=1))

    argv = ["kitti", "--with-db"]
    if name == "waymo":
        argv += ["--dataset-name", "waymo"]
    jroot, troot = run_both(tmp_path, write, argv)
    assert_same_outputs(jroot, troot)
    with open(os.path.join(troot, f"{name}_infos_train.pkl"), "rb") as f:
        infos = pickle.load(f)
    assert [f"{i['image']['image_idx']:06d}" for i in infos] == tree["train"]
    for info in infos:
        idx = f"{info['image']['image_idx']:06d}"
        ann = info["annos"]
        assert list(ann["name"]) == tree["names"][idx]     # no DontCare
        np.testing.assert_allclose(ann["gt_boxes_lidar"], tree["boxes"][idx],
                                   atol=BOX_TOL, rtol=0)
    with open(os.path.join(troot, f"{name}_dbinfos_train.pkl"), "rb") as f:
        db = pickle.load(f)
    counts = [e["num_points_in_gt"] for v in db.values() for e in v]
    assert len(counts) == 3 * 6 and min(counts) >= 40


@pytest.mark.parametrize("split", ["frac", "names", "names_file"])
def test_nuscenes_tree(tmp_path, split):
    tree = {}

    def write(root):
        tree.update(roots.write_raw_nuscenes_root(
            root, n_train=4, n_val=2, points=3000, sweeps=3, boxes=12,
            train_scenes=2, val_scenes=2, per_box=30, version="v1.0-mini",
            seed=2))

    argv = ["nuscenes", "--version", "v1.0-mini", "--max-sweeps", "2",
            "--with-db"]
    if split == "frac":
        argv += ["--val-scene-frac", "0.5"]
    elif split == "names":
        argv += ["--val-scenes", "scene-0002,scene-0004"]
    else:
        path = tmp_path / "val.txt"
        path.write_text("scene-0002\nscene-0004\n")
        argv += ["--val-scenes", str(path)]
    jroot, troot = run_both(tmp_path, write, argv)
    assert_same_outputs(jroot, troot)
    infos = {}
    for s in ("train", "val"):
        with open(os.path.join(troot, f"nuscenes_infos_{s}.pkl"), "rb") as f:
            infos[s] = pickle.load(f)
    # the frac form takes the last half of the scene names as val
    want_val = 2 if split == "frac" else 3
    assert len(infos["val"]) == want_val
    assert len(infos["train"]) + len(infos["val"]) == 6
    for info in infos["train"] + infos["val"]:
        assert len(info["sweeps"]) == 2              # --max-sweeps
        assert list(info["gt_names"]) == tree["names"][info["token"]]
        got, want = info["gt_boxes"], tree["lidar_boxes"][info["token"]]
        np.testing.assert_allclose(got[:, :6], want[:, :6], atol=BOX_TOL,
                                   rtol=0)
        dyaw = np.angle(np.exp(1j * (got[:, 6] - want[:, 6])))
        assert np.abs(dyaw).max() < BOX_TOL
        assert np.isfinite(info["gt_velocity"]).all()
    with open(os.path.join(troot, "nuscenes_dbinfos_train.pkl"), "rb") as f:
        db = pickle.load(f)
    assert sorted(db) == sorted(roots.NUS_CLASSES)
    assert min(e["num_points_in_gt"] for v in db.values() for e in v) >= 30
