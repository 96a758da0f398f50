"""The C++ route of the host-side point pipeline (`csrc/pointio.cpp`).

The JAX package's C++ extension (`native/pointio.cpp`), ported to a plain
C interface bound with ctypes: the .bin load, the range filter with its
shuffle and the pad to capacity in one pass, and the rigid transform of a
sweep.  ctypes releases the interpreter lock for the length of each call,
so the loader's threads run these loops in parallel with each other and
with the main thread's dispatch of the train step; the numpy route holds
the lock between its numpy calls.

The library is built at first use with g++ (`-O3 -std=c++17 -shared
-fPIC`) into `build/host/` at the root of the checkout, named by a hash of
its source and flags, and loaded as it is when already built.  Concurrent
first uses each write a temporary file and move it into place.  A failed
build raises with the compiler's output.

The route is chosen by the environment variable SRFDET_POINT_IO: `cpp`
(the default) or `numpy` (the numpy code of `transforms.py`).  Both keep
the same points; the shuffle's order differs (std::mt19937_64 against
numpy's default_rng), so over capacity they keep different subsets.  The
C++ route equals the JAX package's C++ extension bit for bit, the numpy
route its numpy fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "pointio.cpp"
BUILD_DIR = _PKG.parent / "build" / "host"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
ROUTE_ENV = "SRFDET_POINT_IO"
ROUTES = ("cpp", "numpy")

_lib = None
_lock = threading.Lock()

_f32p = ctypes.POINTER(ctypes.c_float)
_i64 = ctypes.c_int64
_SIGNATURES = {
    "pointio_count_rows": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_int,
                                          ctypes.POINTER(_i64),
                                          ctypes.POINTER(_i64)]),
    "pointio_load": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_int, _i64,
                                    _f32p]),
    "pointio_filter_pad": (_i64, [_f32p, _i64, _i64, _f32p, _i64,
                                  ctypes.c_int, ctypes.c_uint64, _f32p,
                                  ctypes.POINTER(ctypes.c_uint8)]),
    "pointio_transform": (None, [_f32p, _i64, _i64, _f32p, _f32p]),
}


def route() -> str:
    """The route SRFDET_POINT_IO names: 'cpp' (default) or 'numpy'."""
    name = os.environ.get(ROUTE_ENV, "cpp")
    if name not in ROUTES:
        raise ValueError(f"{ROUTE_ENV}={name!r}: expected one of {ROUTES}")
    return name


def library_path() -> Path:
    """The library of the current source and flags."""
    digest = hashlib.sha256(SOURCE.read_bytes() +
                            " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"pointio_{digest[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built; returns its path.  Raises
    RuntimeError with g++'s output when the build fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the C++ point route cannot be "
                           f"built (or set {ROUTE_ENV}=numpy)")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{proc.stdout}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded library, built first if need be."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for fn, (restype, argtypes) in _SIGNATURES.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _lib = lib
    return _lib


def _ptr(a: np.ndarray, ctype=ctypes.c_float):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def load_points_fast(path: str, load_dim: int) -> np.ndarray:
    """(N, load_dim) float32 from a .bin file.  FileNotFoundError when it
    cannot be opened, ValueError on a trailing partial row."""
    if route() == "numpy":
        return np.fromfile(path, dtype=np.float32).reshape(-1, load_dim)
    if load_dim <= 0:
        raise ValueError(f"load_dim must be > 0, got {load_dim}")
    lib = library()
    name = os.fsencode(path)
    rows, size = _i64(), _i64()
    rc = lib.pointio_count_rows(name, load_dim, ctypes.byref(rows),
                                ctypes.byref(size))
    if rc == -1:
        raise FileNotFoundError(f"cannot open {path}")
    if rc == -2:
        raise ValueError(f"{path}: {size.value} bytes is not a multiple of "
                         f"{4 * load_dim} (corrupt file?)")
    out = np.empty((rows.value, load_dim), np.float32)
    rc = lib.pointio_load(name, load_dim, rows.value, _ptr(out))
    if rc == -1:
        raise FileNotFoundError(f"cannot open {path}")
    if rc != 0:
        raise OSError(f"short read on {path}")
    return out


def filter_pad_fast(points: np.ndarray, pc_range: Sequence[float], cap: int,
                    shuffle: bool = True, seed: int = 0
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Range filter, (optional) shuffle and pad to capacity in one pass:
    (cap, D) float32 and its (cap,) mask."""
    if route() == "numpy":
        from .transforms import filter_pad
        return filter_pad(points, pc_range, cap, shuffle, seed)
    pts = np.ascontiguousarray(points, np.float32)
    rng = np.ascontiguousarray(pc_range, np.float32)
    if pts.ndim != 2 or pts.shape[1] < 3 or rng.shape != (6,) or cap < 0:
        raise ValueError("filter_pad needs points (N, >=3), pc_range (6,) "
                         f"and cap >= 0; got {pts.shape}, {rng.shape}, {cap}")
    out = np.zeros((cap, pts.shape[1]), np.float32)
    mask = np.zeros((cap,), bool)
    library().pointio_filter_pad(
        _ptr(pts), pts.shape[0], pts.shape[1], _ptr(rng), cap, int(shuffle),
        int(seed) % (1 << 64), _ptr(out), _ptr(mask, ctypes.c_uint8))
    return out, mask


def transform_points_fast(points: np.ndarray, rot: np.ndarray,
                          trans: np.ndarray) -> np.ndarray:
    """A fresh array with xyz' = R @ xyz + t and the other channels as they
    are."""
    if route() == "numpy":
        points = points.copy()
        points[:, :3] = points[:, :3] @ np.asarray(rot).T + np.asarray(trans)
        return points
    out = np.array(points, np.float32, order="C", copy=True)
    r = np.ascontiguousarray(rot, np.float32)
    t = np.ascontiguousarray(trans, np.float32)
    if out.ndim != 2 or out.shape[1] < 3 or r.size != 9 or t.size != 3:
        raise ValueError("transform_points needs points (N, >=3), rot "
                         f"(3, 3), trans (3,); got {out.shape}, {r.shape}, "
                         f"{t.shape}")
    library().pointio_transform(_ptr(out), out.shape[0], out.shape[1],
                                _ptr(r), _ptr(t))
    return out
