"""The flagship's learning check at several learning rates.

    python3 -m srfdet3d_torch.bench.learn_sweep [--lr 0.0002 0.001]
        [--warmup 20] [--steps 300] [--per-box 200 400] [--sweeps 0 2]
        [--seed 3 4] [--repeat 6]

Needs one CUDA card; run from the root of a checkout (it imports that
checkout's chip_smoke.py).  Builds the kernels, then runs chip_smoke's
flagship_learn (under deterministic cuDNN) `--repeat` times per root
(sweeps, planted points a box, seed: each chip_smoke.LEARN_ROOT's where
not given) and learning rate, in this process, on a fresh root each (the
phase as chip_smoke runs it: --lr 0.001 --steps 400):
`srfdet_voxel_nusc_L` at full width trained on two planted nuScenes
frames through the port's dataset, loader and train_step, scored by the
test CLI before and after.  Each run prints chip_smoke's lines
(the loss every 25 steps, then the phase line with both mAPs, NDS, the
top box's BEV error, step p50 and peak GB) and whether it met the bar;
a run that misses the bar does not stop the sweep.  Last, the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import tempfile


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--lr", type=float, nargs="+", default=[2e-4, 1e-3])
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--per-box", type=int, nargs="+", default=None)
    ap.add_argument("--sweeps", type=int, nargs="+", default=None)
    ap.add_argument("--seed", type=int, nargs="+", default=None)
    ap.add_argument("--repeat", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import torch
    import chip_smoke
    from srfdet3d_torch import set_backend_flags
    from srfdet3d_torch.ops import cuda_build
    if not torch.cuda.is_available():
        raise SystemExit("learn_sweep needs a CUDA card")
    set_backend_flags()
    cuda_build.build_kernels(["gather_conv", "eqmatch", "gather_conv_bwd",
                              "roi_scatter", "rulebook_lookup"])
    smi = chip_smoke.nvidia_smi()
    base = chip_smoke.LEARN_ROOT
    roots = itertools.product(args.sweeps or [base["sweeps"]],
                              args.per_box or [base["per_box"]],
                              args.seed or [base["seed"]])
    runs = itertools.product(roots, args.lr, range(args.repeat))
    for (sweeps, per_box, seed), lr, run in runs:
        options = (f"optim.lr={lr}", f"optim.warmup_iters={args.warmup}")
        planted = dict(base, sweeps=sweeps, per_box=per_box, seed=seed)
        tag = f"learn_lr{lr:g}_sweeps{sweeps}_box{per_box}_seed{seed}" \
            f"_run{run}"
        with tempfile.TemporaryDirectory() as tmp:
            try:
                chip_smoke.flagship_learn(smi, tmp, options, args.steps,
                                          phase=tag, planted=planted)
                passed = True
            except AssertionError as e:
                print(e, flush=True)
                passed = False
        print(json.dumps({"lr": lr, "sweeps": sweeps, "per_box": per_box,
                          "seed": seed, "steps": args.steps, "run": run,
                          "passed": passed}), flush=True)
        chip_smoke.free_cache()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
