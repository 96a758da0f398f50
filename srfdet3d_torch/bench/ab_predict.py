"""Flagship predict of two checkouts, alternated: parent against change.

    python3 -m srfdet3d_torch.bench.ab_predict --parent DIR [--change DIR]
        [--pairs 10] [--out FILE]

Needs one CUDA card.  Each run is a fresh process in one checkout's root
(its own `srfdet3d_torch` and `chip_smoke.py`), so each tree runs its own
kernels and the host and allocator start cold each time.  Runs go in
blocks of parent, change, change, parent until each tree has run `pairs`
times.  A run builds the tree's kernels (cached under its build/), makes
`srfdet_voxel_nusc_L` at full width with seed-0 weights and
chip_smoke.synthetic_batch(cfg, 1, seed=0), predicts 5 times to warm up,
times `predicts` more (host ms, each ended by a synchronize), then
profiles 3 predicts behind a spin of the card: the device ms a predict of
the gather-GEMM kernels (K1's names in either tree) and of every other
kernel, which the two trees share unchanged (the four largest by name).

Prints one JSON line per run, then a summary: per tree the median of the
runs' p50s and of each device sum, and per pair (the i-th run of each
tree) change - parent, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

GATHER_GEMM_KERNELS = ("gather_gemm::kernel", "dw_partial_kernel",
                       "dw_reduce_kernel")
# torch.cuda._sleep's kernel (spin_kernel), which fills the card at a
# session's start so that the session sees every launch after it
SPIN_CYCLES = 20_000_000


def run_one(predicts: int) -> dict:
    """One run in the current checkout (its root first on sys.path)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    import srfdet3d_torch
    from srfdet3d_torch.configs import srfdet_voxel_nusc_L
    from srfdet3d_torch.models.detector import SRFDet
    from srfdet3d_torch.ops import cuda_build
    cuda_build.build_kernels(["gather_conv", "eqmatch", "gather_conv_bwd",
                              "roi_scatter", "rulebook_lookup"])
    cfg = srfdet_voxel_nusc_L()
    model = SRFDet(cfg, device="cuda", seed=0)
    batch = {k: v.cuda() for k, v in
             chip_smoke.synthetic_batch(cfg, 1, seed=0).items()}
    for _ in range(5):
        model.predict(batch)
    times = []
    for _ in range(predicts):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.predict(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    profiled = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(SPIN_CYCLES)
        torch.cuda.synchronize()
        for _ in range(profiled):
            model.predict(batch)
        torch.cuda.synchronize()
    gemm, other = 0.0, []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA or \
                "spin" in e.key.lower() or "sleep" in e.key.lower():
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if any(name in e.key for name in GATHER_GEMM_KERNELS):
            gemm += us
        else:
            other.append((us / 1e3 / profiled, e.key[:60]))
    other.sort(reverse=True)
    return dict(package=str(Path(srfdet3d_torch.__file__).parent),
                p50_ms=statistics.median(times), min_ms=min(times),
                runs=len(times), gather_gemm_device_ms=gemm / 1e3 / profiled,
                other_device_ms=sum(ms for ms, _ in other),
                top_other=other[:4])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--change", type=Path,
                    default=Path(__file__).resolve().parents[2])
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--predicts", type=int, default=30)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(run_one(args.predicts)), flush=True)
        return 0
    import torch
    if args.parent is None:
        ap.error("--parent is required")
    if not torch.cuda.is_available():
        print("ab_predict: no CUDA device", file=sys.stderr)
        return 1
    trees = {"parent": args.parent.resolve(), "change": args.change.resolve()}
    order = []
    while len(order) < 2 * args.pairs:
        order += ["parent", "change", "change", "parent"]
    order = order[:2 * args.pairs]
    runs = {"parent": [], "change": []}
    out = args.out.open("w") if args.out else None
    for i, which in enumerate(order):
        tree = trees[which]
        # this file run by its path in the tree's root, with the tree
        # first on the import path: the tree's package and chip_smoke.py
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--child",
             "--predicts", str(args.predicts)],
            cwd=tree, env={**os.environ, "PYTHONPATH": str(tree)},
            capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"run {i} ({which}) failed:\n"
                             f"{proc.stdout}\n{proc.stderr}")
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        if not row["package"].startswith(str(tree)):
            raise SystemExit(f"run {i} imported {row['package']}, not "
                             f"{tree}'s package")
        row.update(run=i, tree=which)
        runs[which].append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
    keys = ("p50_ms", "gather_gemm_device_ms", "other_device_ms")
    summary = dict(
        pairs=args.pairs,
        median={w: {k: statistics.median(r[k] for r in rs) for k in keys}
                for w, rs in runs.items()},
        change_minus_parent={k: [c[k] - p[k] for p, c in
                                 zip(runs["parent"], runs["change"])]
                             for k in keys})
    summary["change_slower_p50"] = sum(
        d > 0 for d in summary["change_minus_parent"]["p50_ms"])
    print(json.dumps(summary), flush=True)
    if out:
        out.write(json.dumps(summary) + "\n")
        out.close()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
