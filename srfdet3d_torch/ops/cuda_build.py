"""Build and load the port's CUDA kernels.

Each kernel is one CUDA C++ source in `srfdet3d_torch/csrc/` with a plain C
interface; device code that two kernels share lives in a header
(`csrc/*.cuh`).  At first use it is compiled with nvcc for sm_90a into a
shared library under `build/kernels/` at the root of the checkout, named by
a hash of its source, the headers and the flags, and loaded with ctypes.
A library that is already built is loaded as it is.  `build_kernels` starts
one nvcc per source, all at once, and waits for them; `start_nvcc` and
`wait_nvcc` build one source from any directory with the same flags.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    """The library of kernel `name`, named by a hash of its source, the
    shared headers it may include (csrc/*.cuh) and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        src += header.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}_{digest[:16]}.so"


def start_nvcc(source: Path, out: Path) -> subprocess.Popen:
    """Start nvcc on one CUDA source (its headers in its own directory)
    with NVCC_FLAGS, into the shared library `out`."""
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(source)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def wait_nvcc(proc: subprocess.Popen, what: str) -> None:
    """Wait for a start_nvcc process; raise with nvcc's log on failure."""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {what}:\n{log}")


def _start_build(name: str):
    out = library_path(name)
    if out.exists():
        return None
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    return start_nvcc(CSRC / f"{name}.cu", tmp), tmp, out


def _finish_build(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    wait_nvcc(proc, f"{name}.cu")
    os.replace(tmp, out)


def build_kernels(names: Iterable[str]) -> float:
    """Build every named kernel in parallel; returns the seconds taken."""
    t0 = time.perf_counter()
    names = list(names)
    started = [_start_build(n) for n in names]
    for n, s in zip(names, started):
        _finish_build(n, s)
    return time.perf_counter() - t0


def load_library(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if need be, with
    each C entry's argument types declared (every entry returns int)."""
    lib = _loaded.get(name)
    if lib is None:
        _finish_build(name, _start_build(name))
        lib = ctypes.CDLL(str(library_path(name)))
        lib.kernel_error_string.restype = ctypes.c_char_p
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def check_device(what: str, device: torch.device) -> None:
    """Raise unless `device` is the CPU (the plain versions) or a card
    (the kernels): no other device has a route."""
    if device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{what}: no kernel for {device}")


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{what} failed to launch: {msg} ({rc})")
