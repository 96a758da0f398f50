"""What bounds the gather-GEMM kernels on the card: time variants of them.

    python3 -m srfdet3d_torch.bench.probe_gather_gemm [--part f32|bf16|all]

Needs one CUDA card and nvcc.  Copies srfdet3d_torch/csrc into
build/probe/<variant>/, edits the copied sources (each edit a regular
expression that must match exactly once), builds the variants in parallel
with cuda_build's flags and times each (CUDA events around back-to-back
calls of the C entry).

float32 (`--part f32`), at the flagship's four subm shapes (rows, channels
and hits a row of stages 0-3; batch 1 for the forward, batch 2 for dW) on
synthetic rulebooks whose neighbours lie within 300 rows:

- forward (gather_conv.cu): `base`; `no_mma`, without the MMAs (the
  gathers, W loads and barriers alone; its output is wrong by design);
  `one_term`, one TF32 product instead of three (also wrong, by about
  2^-11); `stages_2` and `stages_4`, another cp.async ring depth;
- dW (conv_bwd_dw_f32): `base` at DW_CHUNK 1024 and 2048.

bfloat16 (`--part bf16`; K1-bf16 and K4-bf16, gather_gemm_sm90.cuh and the
dW pass in gather_conv_bwd.cu), on the flagship encoder's own rulebooks
(chip_smoke.encoder_rulebooks on the seeded synthetic scene):

- forward (gather_conv_bf16) at the 9 conv shapes of a predict (batch 1):
  `base`; `no_mma` (the wgmma products left out: the gathers, weight boxes
  and barriers alone), `no_a` (no row gathers), `no_b` (no weight boxes),
  each wrong by design; `stages_2`, `stages_3`, `stages_4`, `stages_6`
  (ring depth at every column tile; base takes 2 at 16 columns, else 4);
  `rows_64`, `rows_128` (one or two consumer warpgroups at every
  column tile; base takes 64-row tiles at 16 and 128 columns, 128 at 32
  and 64); `step_16`, `step_32` (a step 16 or 32 deep instead of 64: one
  offset a step at Cin 16 or 32); `mma_sync`, the earlier bf16 kernel
  (mma.sync m16n8k16, commit 29fd5f7), built from build/probe/mma_sync_src/
  when that holds its gather_gemm.cuh and gather_conv.cu (`git show
  29fd5f7:srfdet3d_torch/csrc/<file>`), fed the transposed weights and Cin
  padded to 8 as its wrapper did (outside the timing);
- the dfeats gather (conv_bwd_dfeats_perm_bf16) and the dW pass
  (conv_bwd_dw_bf16, with its chunk-order sum) at the train step's 4
  strided convs (batch 2): `base`, `no_mma`, `scan_only` (the dW blocks'
  compaction scan and zero partials, no gather or product), `one_offset`
  (a dW block per offset, as the float32 pass, instead of 4 offsets on one
  scan), all at the wrapper's dW chunk (gather_conv_bwd.dw_chunk), and
  `base` at DW_CHUNK and twice DW_CHUNK rows a dW chunk;
- the HGMMA instructions of each bf16 kernel in the base libraries
  (cuobjdump -sass).

Prints one JSON line per shape and probe, then the card's name and power
limit.  The probe is for reading where the time goes; chip_smoke.py holds
the kernels against their plain versions.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from srfdet3d_torch.ops import cuda_build

ROOT = Path(__file__).resolve().parents[2]
MMA_SYNC_SRC = ROOT / "build" / "probe" / "mma_sync_src"
HEADER, SM90, BWD = "gather_gemm.cuh", "gather_gemm_sm90.cuh", \
    "gather_conv_bwd.cu"
# the three products of one 8-deep step in tc::mma_stage
MMA3 = (r"mma\(d,\s*al,\s*bh\[j\]\);\s*mma\(d,\s*ah,\s*bl\[j\]\);"
        r"\s*mma\(d,\s*ah,\s*bh\[j\]\);")
STAGES = r"kStages\s*=\s*3;"
FORWARD = {
    "base": [],
    "no_mma": [(HEADER, MMA3, "")],
    "one_term": [(HEADER, MMA3, "mma(d, ah, bh[j]);")],
    "stages_2": [(HEADER, STAGES, "kStages = 2;")],
    "stages_4": [(HEADER, STAGES, "kStages = 4;")],
}
# the wgmma of the bf16 gather-GEMM and of the bf16 dW pass
FWD_MMA = r"wgmma<BN, 0, kBmn \? 1 : 0>\(acc, da, db\);  // MMA"
DW_MMA = r"wgmma<TN, 1, 1>\(acc, da, db\);  // MMA"
ROWS = r"return bn == 32 \|\| bn == 64 \? 2 : 1;"
RING = r"return bn == 16 \? 2 : 4;"
A_COPIES = r"\{\n        const int it = it0 \+ \(q \* 8\) / cw;"
B_BYTES = r"mbar_expect_tx\(full, \(uint32_t\)\(per_step \* cw \* BN \* 2\)\);"
BF16_FORWARD = {
    "base": [],
    "no_mma": [(SM90, FWD_MMA, "")],
    "no_a": [(SM90, A_COPIES, "if (false) {\n        const int it = it0 + (q * 8) / cw;")],
    "no_b": [(SM90, B_BYTES, "mbar_arrive(full);"),
             (SM90, r"tma_load_3d\(Bs \+ a", "if (false) tma_load_3d(Bs + a"),
             (SM90, r"tma_load_3d\(Bs \+ i", "if (false) tma_load_3d(Bs + i")],
    "stages_2": [(SM90, RING, "return 2;")],
    "stages_3": [(SM90, RING, "return 3;")],
    "stages_4": [(SM90, RING, "return 4;")],
    "stages_6": [(SM90, RING, "return 6;")],
    "rows_64": [(SM90, ROWS, "return 1;")],
    "rows_128": [(SM90, ROWS, "return 2;")],
    "step_16": [(SM90, r"kStepK = 64;", "kStepK = 16;")],
    "step_32": [(SM90, r"kStepK = 64;", "kStepK = 32;")],
}
BF16_BWD = {
    "base": [],
    "no_mma": [(BWD, DW_MMA, "")],
    "scan_only": [(BWD, r"nhit\[jj\] = hits\[jj\];",
                   "nhit[jj] = 0 * hits[jj];")],
    "one_offset": [(BWD, r"kDwOffsets = 4;", "kDwOffsets = 1;")],
}
# (rows, channels, hits a row) of the flagship's subm stages 0-3
SHAPES = ((120000, 16, 1.0), (60000, 32, 5.4), (30000, 64, 12.9),
          (15000, 128, 22.2))
PEAK_BYTES, PEAK_BF16 = 3.35e12, 989e12
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
FWD_ARGS = [_P, _P, _P, _P, _I, _LL, _I, _I, _I, _P]
DFEATS_PERM_ARGS = [_P, _P, _P, _P, _P, _I, _LL, _I, _I, _I, _P]
DW_ARGS = [_P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _I, _P]


def start_builds(source: str, variants) -> dict:
    """Start one nvcc a variant; variants: {name: [(file, pattern,
    replacement), ...] edits of a copy of csrc, or the Path of another
    source directory to copy as it is}."""
    procs = {}
    for name, subs in variants.items():
        out = ROOT / "build" / "probe" / f"{source}_{name}"
        shutil.rmtree(out, ignore_errors=True)
        from_dir = isinstance(subs, Path)
        shutil.copytree(subs if from_dir else cuda_build.CSRC, out)
        for fname, pattern, repl in [] if from_dir else subs:
            path = out / fname
            text, hits = re.subn(pattern, repl, path.read_text())
            if hits != 1:
                raise SystemExit(f"{name}: {pattern!r} matched {hits} times "
                                 f"in {fname}")
            path.write_text(text)
        procs[name] = (out / "lib.so", cuda_build.start_nvcc(
            out / f"{source}.cu", out / "lib.so"))
    return procs


def finish_builds(source: str, procs: dict, entries: dict) -> dict:
    """Wait for start_builds' nvcc runs; {name: {entry: C function}}."""
    fns = {}
    for name, (lib, proc) in procs.items():
        cuda_build.wait_nvcc(proc, f"{source}.cu ({name})")
        dll = ctypes.CDLL(str(lib))
        fns[name] = {}
        for entry, argtypes in entries.items():
            fn = getattr(dll, entry)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            fns[name][entry] = fn
    return fns


def build(source: str, variants, entries: dict) -> dict:
    return finish_builds(source, start_builds(source, variants), entries)


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


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise SystemExit(f"{what}: CUDA error {rc}")


def probe_f32(stream) -> None:
    fwd = build("gather_conv", FORWARD, {"gather_conv_f32": FWD_ARGS})
    dw = build("gather_conv_bwd", {"base": []},
               {"conv_bwd_dw_f32": DW_ARGS})["base"]["conv_bwd_dw_f32"]
    gen = torch.Generator().manual_seed(0)
    for rows, c, hits in SHAPES:
        idx = rulebook(rows, hits, gen)
        feats = torch.randn(rows, c, generator=gen).cuda()
        w = (torch.randn(27, c, c, generator=gen) * 0.02).cuda()
        out = torch.empty(rows, c, device="cuda")
        flops = 2.0 * int((idx < rows).sum()) * c * c
        row = dict(probe="forward", rows=rows, channels=c, hits=hits,
                   tc_bound_ms=flops / (495e12 / 3) * 1e3)
        for name, lib in fwd.items():
            fn = lib["gather_conv_f32"]
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


def bf16_bound(nnz: int, n: int, m: int, k: int, cin: int, cout: int,
               products: int = 1) -> float:
    """chip_smoke.py's bf16 bound of one gather-GEMM (ms): bytes of the
    tables, weights, output and rulebook against flops at 989 TFLOP/s."""
    nbytes = 2.0 * (n * cin + k * cin * cout + m * cout) + 4.0 * m * k
    return max(nbytes / PEAK_BYTES, products * 2.0 * nnz * cin * cout /
               PEAK_BF16) * 1e3


def hgmma_counts(libs) -> dict:
    """{library: {kernel: HGMMA instructions}} from cuobjdump -sass."""
    out = {}
    for name, lib in libs.items():
        sass = subprocess.run(["cuobjdump", "-sass", str(lib)],
                              capture_output=True, text=True,
                              timeout=300).stdout
        counts, fn = {}, None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1)
            elif fn and "HGMMA" in line:
                counts[fn] = counts.get(fn, 0) + 1
        out[name] = counts
    return out


def probe_bf16(stream) -> None:
    import chip_smoke
    from srfdet3d_torch.configs import srfdet_voxel_nusc_L
    from srfdet3d_torch.ops import gather_conv_bwd as gcb
    variants = dict(BF16_FORWARD)
    if all((MMA_SYNC_SRC / f).exists() for f in (HEADER, "gather_conv.cu")):
        variants["mma_sync"] = MMA_SYNC_SRC
    fwd_procs = start_builds("gather_conv", variants)
    bwd_procs = start_builds("gather_conv_bwd", BF16_BWD)
    fwd = finish_builds("gather_conv", fwd_procs,
                        {"gather_conv_bf16": FWD_ARGS})
    bwd = finish_builds("gather_conv_bwd", bwd_procs,
                        {"conv_bwd_dfeats_perm_bf16": DFEATS_PERM_ARGS,
                         "conv_bwd_dw_bf16": DW_ARGS})
    base_libs = {f"{src}_base": ROOT / "build" / "probe" / f"{src}_base" /
                 "lib.so" for src in ("gather_conv", "gather_conv_bwd")}
    print(json.dumps(dict(probe="hgmma", **hgmma_counts(base_libs))),
          flush=True)
    cfg = srfdet_voxel_nusc_L()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    bf = torch.bfloat16
    with torch.no_grad():
        cases, _ = chip_smoke.encoder_rulebooks(
            cfg, chip_smoke.synthetic_batch(cfg, 1, seed=0), dev)
    for name, n, idx, cin, cout, per_predict in cases:
        m, k = idx.shape
        feats = torch.randn(n, cin, generator=gen).to(dev, bf)
        w = (torch.randn(k, cin, cout, generator=gen) /
             math.sqrt(k * cin)).to(dev, bf)
        out = torch.empty(m, cout, device=dev, dtype=bf)
        nnz = int((idx < n).sum())
        row = dict(probe="bf16_forward", conv=name, n=n, m=m, k=k, cin=cin,
                   cout=cout, launches_per_predict=per_predict, nnz=nnz,
                   bound_ms=bf16_bound(nnz, n, m, k, cin, cout))
        for var, lib in fwd.items():
            fn = lib["gather_conv_bf16"]
            f, wv, c = feats, w, cin
            if var == "mma_sync":  # its wrapper's pad and transpose
                f = torch.nn.functional.pad(feats, (0, -cin % 8))
                wv = torch.nn.functional.pad(w.transpose(1, 2),
                                             (0, -cin % 8)).contiguous()
                c = f.shape[1]
            check(fn(f.data_ptr(), idx.data_ptr(), wv.data_ptr(),
                     out.data_ptr(), n, m, k, c, cout, stream), var)
            row[f"{var}_ms"] = time_ms(lambda: fn(
                f.data_ptr(), idx.data_ptr(), wv.data_ptr(), out.data_ptr(),
                n, m, k, c, cout, stream))
        print(json.dumps(row), flush=True)
    del cases
    with torch.no_grad():
        cases, _ = chip_smoke.encoder_rulebooks(
            cfg, chip_smoke.synthetic_batch(cfg, 2, seed=0), dev)
    for name, n, idx, cin, cout, per_step in cases:
        if name == "conv_input" or name.endswith("_subm"):
            continue
        m, k = idx.shape
        feats = torch.randn(n, cin, generator=gen).to(dev, bf)
        w = (torch.randn(k, cin, cout, generator=gen) /
             math.sqrt(k * cin)).to(dev, bf)
        g = torch.randn(m, cout, generator=gen).to(dev, bf)
        rev, perm = gcb.strided_prep(idx, n)
        dfeats = torch.empty(n, cin, device=dev, dtype=bf)
        chunk = gcb.dw_chunk(True, cin, cout, k)   # the wrapper's
        part = torch.empty(-(-n // gcb.DW_CHUNK) * k * cin * cout,
                           device=dev)
        dw = torch.empty(k, cin, cout, device=dev, dtype=bf)
        nnz = int((idx < n).sum())
        row = dict(probe="bf16_bwd", conv=name, n=n, m=m, k=k, cin=cin,
                   cout=cout, launches_per_step=per_step, nnz=nnz,
                   dfeats_bound_ms=bf16_bound(nnz, m, n, k, cout, cin),
                   dw_bound_ms=bf16_bound(nnz, n, m, k, cin, cout))
        for var, lib in bwd.items():
            fd, fw = lib["conv_bwd_dfeats_perm_bf16"], lib["conv_bwd_dw_bf16"]
            args_d = (g.data_ptr(), rev.data_ptr(), perm.data_ptr(),
                      w.data_ptr(), dfeats.data_ptr(), m, n, k, cout, cin,
                      stream)
            args_w = (feats.data_ptr(), rev.data_ptr(), g.data_ptr(),
                      part.data_ptr(), dw.data_ptr(), n, m, k, cin, cout,
                      chunk, 0, stream)
            check(fd(*args_d), f"{var} dfeats")
            check(fw(*args_w), f"{var} dW")
            row[f"{var}_dfeats_ms"] = time_ms(lambda: fd(*args_d))
            row[f"{var}_dw_ms"] = time_ms(lambda: fw(*args_w))
            if var == "base":  # both chunk sizes, whichever the wrapper picks
                row["dw_chunk"] = chunk
                for rows_a in (gcb.DW_CHUNK, 2 * gcb.DW_CHUNK):
                    args_c = args_w[:10] + (rows_a,) + args_w[11:]
                    check(fw(*args_c), f"base dW, chunk {rows_a}")
                    row[f"base_dw_chunk_{rows_a}_ms"] = time_ms(
                        lambda: fw(*args_c))
        print(json.dumps(row), flush=True)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--part", choices=("f32", "bf16", "all"),
                        default="all")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("probe_gather_gemm: no CUDA device", file=sys.stderr)
        return 1
    stream = torch.cuda.current_stream().cuda_stream
    if args.part in ("f32", "all"):
        probe_f32(stream)
    if args.part in ("bf16", "all"):
        probe_bf16(stream)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
