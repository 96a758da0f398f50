"""chip_smoke.py's host-side phases alone, on freshly written data roots.

    python3 -m srfdet3d_torch.bench.host_phases

Needs one CUDA card; run from the root of a checkout (it imports that
checkout's chip_smoke.py).  Builds the CUDA kernels and the C++ point
route (timing the latter), writes chip_smoke's nuScenes and KITTI data
roots (DATA_ROOTS) under a temporary directory, then runs `data_route`,
`data_step_profile` and `raw_tree_train` and one `flagship_learn`, each
printing chip_smoke's JSON line and its seconds; a flagship_learn that
misses its bar is reported, not raised.  Last, the card's name and power
limit.  ~5 min on an H100.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import torch
    import chip_smoke as cs
    from srfdet3d_torch import set_backend_flags
    from srfdet3d_torch.data import native, synthetic_root
    from srfdet3d_torch.ops import cuda_build
    if not torch.cuda.is_available():
        raise SystemExit("host_phases needs a CUDA card")
    set_backend_flags()
    smi = cs.nvidia_smi()
    cuda_build.build_kernels(["gather_conv", "eqmatch", "gather_conv_bwd",
                              "roi_scatter", "rulebook_lookup"])
    built = not native.library_path().exists()
    t0 = time.perf_counter()
    native.build()
    build_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        roots = {"nus": synthetic_root.write_nuscenes_root(
                     os.path.join(tmp, "nus"), **cs.DATA_ROOTS["nus"]),
                 "kitti": synthetic_root.write_kitti_root(
                     os.path.join(tmp, "kitti"), **cs.DATA_ROOTS["kitti"])}
        for fn, args in ((cs.data_route, (smi, roots, build_s, built)),
                         (cs.data_step_profile, (smi, roots, tmp)),
                         (cs.raw_tree_train, (smi, tmp))):
            t0 = time.perf_counter()
            fn(*args)
            print(fn.__name__, "s", time.perf_counter() - t0, flush=True)
        t0 = time.perf_counter()
        try:
            cs.flagship_learn(smi, tmp)
        except AssertionError as e:
            print(e, flush=True)
        print("flagship_learn s", time.perf_counter() - t0, flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
