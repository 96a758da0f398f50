"""The port's C++ point route (`srfdet3d_torch/data/native.py`,
`csrc/pointio.cpp`) against the JAX package's C++ extension
(`srfdet3d_tpu.data.native` with its extension on).

Exact unless noted: load_points byte for byte, filter_pad bit for bit
(points and mask, same rows in the same shuffled order) below, at and over
the capacity, with the shuffle on and off, at seeds up to 2^31 - 1.
transform_points within rtol 1e-6: the JAX extension is built with
-march=native and may contract a product and a sum into one FMA where the
port's build does not.
"""

import numpy as np
import pytest

import srfdet3d_tpu.data.native as jnative
from srfdet3d_tpu.data import transforms as jT
from srfdet3d_torch.data import native as tnative
from srfdet3d_torch.data import transforms as tT

SEEDS = (0, 1, 7, 12345, 2**31 - 1)


@pytest.fixture(autouse=True)
def cpp_routes(monkeypatch):
    """Both packages on their C++ route."""
    monkeypatch.delenv(tnative.ROUTE_ENV, raising=False)
    if not jnative.have_native():
        pytest.fail("the JAX package's C++ extension is not built")


def cloud(seed, n=5000, d=5):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-20, 20, (n, d)).astype(np.float32)
    # points exactly on the range's faces are kept (inclusive bounds)
    pts[:8, :3] = [[-10, -10, -10], [10, 10, 10], [-10, 0, 0], [0, 10, 0],
                   [0, 0, -10], [10.0001, 0, 0], [0, -10.0001, 0],
                   [0, 0, 10.0001]]
    return pts


PC = (-10.0, -10.0, -10.0, 10.0, 10.0, 10.0)


def test_load_points_byte_equal(tmp_path):
    for d in (4, 5, 6):
        pts = cloud(d, 3001, d)
        path = str(tmp_path / f"p{d}.bin")
        pts.tofile(path)
        j = jnative.load_points_fast(path, d)
        t = tnative.load_points_fast(path, d)
        assert t.dtype == j.dtype == np.float32 and t.shape == j.shape
        assert t.tobytes() == j.tobytes() == pts.tobytes()
    empty = str(tmp_path / "empty.bin")
    open(empty, "wb").close()
    assert tnative.load_points_fast(empty, 5).shape == (0, 5)
    # load_points_bin picks the used channels after the load
    np.testing.assert_array_equal(
        tT.load_points_bin(path, 6, (0, 1, 2, 3, 4)),
        jT.load_points_bin(path, 6, (0, 1, 2, 3, 4)))


def test_partial_row_and_missing_file_raise(tmp_path):
    path = str(tmp_path / "bad.bin")
    np.zeros(11, np.float32).tofile(path)       # 2 rows of 5 and 1 float
    with pytest.raises(ValueError, match="not a multiple"):
        jnative.load_points_fast(path, 5)
    with pytest.raises(ValueError, match="not a multiple"):
        tnative.load_points_fast(path, 5)
    with pytest.raises(FileNotFoundError):
        tnative.load_points_fast(str(tmp_path / "none.bin"), 5)
    with pytest.raises(ValueError):
        tnative.load_points_fast(path, 0)


@pytest.mark.parametrize("shuffle", [False, True])
def test_filter_pad_bit_equal(shuffle):
    pts = cloud(1)
    inside = len(jT.points_range_filter(pts, PC))
    for cap in (0, 1, inside // 3, inside - 1, inside, inside + 1, 4096):
        for seed in SEEDS:
            jp, jm = jnative.filter_pad_fast(pts, PC, cap, shuffle, seed)
            tp, tm = tnative.filter_pad_fast(pts, PC, cap, shuffle, seed)
            assert tp.dtype == jp.dtype and tp.shape == jp.shape
            assert tm.dtype == jm.dtype == bool and tm.shape == jm.shape
            assert tp.tobytes() == jp.tobytes(), (cap, seed)
            np.testing.assert_array_equal(tm, jm)
            assert tm.sum() == min(cap, inside)


def test_filter_pad_keeps_the_numpy_routes_set():
    """Under the capacity both routes keep the same rows; the numpy route
    is reached by SRFDET_POINT_IO=numpy only."""
    pts = cloud(2)
    want = tT.points_range_filter(pts, PC)
    got, mask = tnative.filter_pad_fast(pts, PC, 4096, True, 3)
    assert sorted(map(tuple, got[mask])) == sorted(map(tuple, want))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(tnative.ROUTE_ENV, "numpy")
        np_pts, np_mask = tnative.filter_pad_fast(pts, PC, 4096, True, 3)
        ref = tT.filter_pad(pts, PC, 4096, True, 3)
        np.testing.assert_array_equal(np_pts, ref[0])
        np.testing.assert_array_equal(np_mask, ref[1])
        mp.setenv(tnative.ROUTE_ENV, "fortran")
        with pytest.raises(ValueError, match="SRFDET_POINT_IO"):
            tnative.filter_pad_fast(pts, PC, 4096, True, 3)
    assert not np.array_equal(np_pts, got)      # other shuffle draws


def test_transform_points_matches_jax():
    pts = cloud(3, 2000)
    for ang in (0.0, 0.7, -2.9):
        rot = np.array([[np.cos(ang), -np.sin(ang), 0.01],
                        [np.sin(ang), np.cos(ang), -0.02],
                        [0.0, 0.02, 1.0]], np.float32)
        tr = np.array([1.0, -2.0, 0.5], np.float32)
        src = pts.copy()
        got = tnative.transform_points_fast(src, rot, tr)
        want = jnative.transform_points_fast(pts, rot, tr)
        np.testing.assert_array_equal(src, pts)      # input untouched
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got[:, 3:], pts[:, 3:])


def test_failed_build_raises_not_falls_back(tmp_path, monkeypatch):
    broken = tmp_path / "pointio.cpp"
    broken.write_text(tnative.SOURCE.read_text() + "\nthis is not C++;\n")
    monkeypatch.setattr(tnative, "SOURCE", broken)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_lib", None)
    path = str(tmp_path / "p.bin")
    cloud(4, 10).tofile(path)
    with pytest.raises(RuntimeError, match=r"(?s)g\+\+ failed.*this is"):
        tnative.load_points_fast(path, 5)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tnative.filter_pad_fast(cloud(4, 10), PC, 16)
    assert not list((tmp_path / "build").glob("*"))   # no partial library


def test_library_is_named_by_source_and_built_once(tmp_path, monkeypatch):
    """Two first uses at once (threads here; xdist workers across
    processes) each write a temporary file and move it into place."""
    import threading
    src = tmp_path / "pointio.cpp"
    src.write_bytes(tnative.SOURCE.read_bytes())
    monkeypatch.setattr(tnative, "SOURCE", src)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    paths, errors = [], []

    def first_use():
        try:
            paths.append(tnative.build())
        except Exception as e:          # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=first_use) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert not errors and len(set(paths)) == 1
    assert [p.name for p in (tmp_path / "build").iterdir()] == \
        [paths[0].name]
    src.write_bytes(src.read_bytes() + b"\n// changed\n")
    assert tnative.library_path() != paths[0]
