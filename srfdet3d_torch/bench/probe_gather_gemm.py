"""What bounds the gather-GEMM kernels on the card: time variants of them.

    python3 -m srfdet3d_torch.bench.probe_gather_gemm

Needs one CUDA card and nvcc.  Copies srfdet3d_torch/csrc into
build/probe/<variant>/, edits the copied headers (each edit a regular
expression that must match exactly once), builds the variants in parallel
with cuda_build's flags and times each at the flagship's four subm shapes
(rows, channels and hits a row of stages 0-3; batch 1 for the forward,
batch 2 for dW) on synthetic rulebooks whose neighbours lie within 300
rows:

- forward (gather_conv.cu): `base`; `no_mma`, without the MMAs (the
  gathers, W loads and barriers alone; its output is wrong by design);
  `one_term`, one TF32 product instead of three (also wrong, by about
  2^-11); `stages_2` and `stages_4`, another cp.async ring depth;
- dW (conv_bwd_dw_f32): `base` at DW_CHUNK 1024 and 2048.

Prints one JSON line per shape, then the card's name and power limit.  The
probe is for reading where the time goes; chip_smoke.py holds the kernels
against their plain versions.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from srfdet3d_torch.ops import cuda_build

ROOT = Path(__file__).resolve().parents[2]
# the three products of one 8-deep step in tc::mma_stage
MMA3 = (r"mma\(d,\s*al,\s*bh\[j\]\);\s*mma\(d,\s*ah,\s*bl\[j\]\);"
        r"\s*mma\(d,\s*ah,\s*bh\[j\]\);")
STAGES = r"kStages\s*=\s*3;"
FORWARD = {
    "base": [],
    "no_mma": [(MMA3, "")],
    "one_term": [(MMA3, "mma(d, ah, bh[j]);")],
    "stages_2": [(STAGES, "kStages = 2;")],
    "stages_4": [(STAGES, "kStages = 4;")],
}
# (rows, channels, hits a row) of the flagship's subm stages 0-3
SHAPES = ((120000, 16, 1.0), (60000, 32, 5.4), (30000, 64, 12.9),
          (15000, 128, 22.2))
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def build(source: str, variants, entry: str, argtypes):
    """Build one library per variant; {name: C function}."""
    procs = {}
    for name, subs in variants.items():
        out = ROOT / "build" / "probe" / f"{source}_{name}"
        shutil.rmtree(out, ignore_errors=True)
        shutil.copytree(cuda_build.CSRC, out)
        header = out / "gather_gemm.cuh"
        text = header.read_text()
        for pattern, repl in subs:
            text, hits = re.subn(pattern, repl, text)
            if hits != 1:
                raise SystemExit(f"{name}: {pattern!r} matched {hits} times "
                                 f"in gather_gemm.cuh")
        header.write_text(text)
        procs[name] = (out / "lib.so", cuda_build.start_nvcc(
            out / f"{source}.cu", out / "lib.so"))
    fns = {}
    for name, (lib, proc) in procs.items():
        cuda_build.wait_nvcc(proc, f"{source}.cu ({name})")
        fn = getattr(ctypes.CDLL(str(lib)), entry)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn
    return fns


def rulebook(rows: int, hits: float, gen) -> torch.Tensor:
    near = torch.arange(rows)[:, None] + torch.randint(
        -300, 301, (rows, 27), generator=gen)
    rb = near.clamp(0, rows - 1).int()
    rb[torch.rand(rows, 27, generator=gen) > hits / 27] = rows
    return rb.cuda()


def time_ms(fn, iters: int = 30) -> float:
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_gather_gemm: no CUDA device", file=sys.stderr)
        return 1
    fwd = build("gather_conv", FORWARD, "gather_conv_f32",
                [_P, _P, _P, _P, _I, _LL, _I, _I, _I, _P])
    dw = build("gather_conv_bwd", {"base": []}, "conv_bwd_dw_f32",
               [_P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _I, _P])["base"]
    gen = torch.Generator().manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for rows, c, hits in SHAPES:
        idx = rulebook(rows, hits, gen)
        feats = torch.randn(rows, c, generator=gen).cuda()
        w = (torch.randn(27, c, c, generator=gen) * 0.02).cuda()
        out = torch.empty(rows, c, device="cuda")
        flops = 2.0 * int((idx < rows).sum()) * c * c
        row = dict(probe="forward", rows=rows, channels=c, hits=hits,
                   tc_bound_ms=flops / (495e12 / 3) * 1e3)
        for name, fn in fwd.items():
            row[f"{name}_ms"] = time_ms(lambda: fn(
                feats.data_ptr(), idx.data_ptr(), w.data_ptr(),
                out.data_ptr(), rows, rows, 27, c, c, stream))
        print(json.dumps(row), flush=True)
        rows2 = 2 * rows
        rb = rulebook(rows2, hits, gen)
        f = torch.randn(rows2, c, generator=gen).cuda()
        g = torch.randn(rows2, c, generator=gen).cuda()
        dwt = torch.empty(27, c, c, device="cuda")
        row = dict(probe="dw", rows=rows2, channels=c, hits=hits,
                   tc_bound_ms=2.0 * int((rb < rows2).sum()) * c * c /
                   (495e12 / 3) * 1e3)
        for chunk in (1024, 2048):
            part = torch.empty(-(-rows2 // chunk) * 27 * c * c,
                               device="cuda")
            row[f"chunk_{chunk}_ms"] = time_ms(lambda: dw(
                f.data_ptr(), rb.data_ptr(), g.data_ptr(), part.data_ptr(),
                dwt.data_ptr(), rows2, rows2, 27, c, c, chunk, 0, stream))
        print(json.dumps(row), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
