"""The readings that set a cell's limits, on the card at the cell's own
size.  By default the lower-precision control: the plain reference put in
the system's place and computed with TF32 on (the configs are float32
with TF32 off), checked by the same comparison as a run of the system
(compare.py) against the float32 reference.  Its readings, and a planted
fault's (`--fault`), set the upper end of each limit; sound runs of the
system set the lower end (`--system`: the window's call without the
window, every pool frame checked, or a run's checked steps; run.py's own
runs count too).

    python3 benchmark/calibrate.py --workload <name> --seeds <n> [<n> ...]
        [--system | --fault k3_dw | --fault k4_dw | --fault half_batch]

prints one JSON line of readings a seed.  Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def control_predict(doc, traffic, seed, dev):
    """Every pool frame served once by the TF32 reference (its head
    outputs and its decoded answer), then the float32 reference's check."""
    from benchmark import cells, compare, scene
    pool = scene.make_pool(traffic, doc, seed, dev)
    ctl_cfg, ctl = compare.reference(doc, seed, dev, tf32=True)
    sampled = []
    with torch.no_grad():
        for idx, batch in enumerate(pool):
            out = ctl(cells.to_device(batch, cells.INPUT_KEYS, dev))
            ans = {k: v.cpu() for k, v in compare.decode(
                ctl_cfg, out[0][-1], out[1][-1]).items()}
            sampled.append((idx, out, ans))
        del ctl
        ref_cfg, ref = compare.reference(doc, seed, dev, tf32=False)
        ref_out = {i: ref(cells.to_device(b, cells.INPUT_KEYS, dev))
                   for i, b in enumerate(pool)}
    return compare.served_readings(sampled, ref_out, ref_cfg)


def control_train(doc, traffic, seed, dev):
    """The TF32 reference's checked steps in the system's place, then the
    float32 reference's, following them (their states and decisions)."""
    from benchmark import cells, compare, scene
    pool = scene.make_pool(traffic, doc, seed, dev)
    ctl = compare.reference_steps(doc, seed, pool, dev, cells.CHECKED_STEPS,
                                  None, tf32=True)
    gc.collect()
    ref = compare.reference_steps(doc, seed, pool, dev, cells.CHECKED_STEPS,
                                  ctl, tf32=False)
    return named(compare.train_readings(ctl, ref), ctl)


def system_predict(doc, traffic, seed, dev):
    """The system serving every pool frame once through the window's call,
    each frame checked, then the float32 reference's check: a sound
    run's readings without a window."""
    from benchmark import cells, compare, port, scene
    pool = scene.make_pool(traffic, doc, seed, dev)
    net = port.model(port.config(doc), seed, dev)
    cell = cells.PredictCell(net, pool, dev, seed, 1.0)
    for i in range(len(pool)):
        cell.serve_window_frame(i)
    cell.close()
    del net
    gc.collect()
    torch.cuda.empty_cache()
    ref_cfg, ref = compare.reference(doc, seed, dev)
    return compare.predict_readings(cell, ref_cfg, ref)[0]


def system_train(doc, traffic, seed, dev):
    """The system's checked steps (TrainCell.warm, as a run's set-up makes
    them), then the float32 reference following them."""
    from benchmark import cells, compare, port, scene
    pool = scene.make_pool(traffic, doc, seed, dev)
    cfg = port.config(doc)
    cell = cells.TrainCell(cfg, port.model(cfg, seed, dev), pool, dev, seed)
    cell.warm()
    rec = cell.record
    cell.close()
    del cell
    gc.collect()
    torch.cuda.empty_cache()
    ref = compare.reference_steps(doc, seed, pool, dev, cells.CHECKED_STEPS,
                                  rec)
    return named(compare.train_readings(rec, ref), rec)


def named(readings, rec):
    """The worst leaves' names beside their indices."""
    for k in [k for k in readings if k.startswith("grad_worst_leaf.")]:
        readings[k.replace("leaf", "name")] = rec["names"][int(readings[k])]
    return readings


def dw_halved(attr: str):
    """A fault planted in the system: a sparse conv backward (K3
    `subm_conv_bwd`, K4 `strided_conv_bwd`) returns half its weight
    gradient, as a split reduction that keeps half its partial sums
    would."""
    from srfdet3d_torch.ops import sparse_conv
    bwd = getattr(sparse_conv, attr)

    def halved(*args, **kwargs):
        dfeats, dw = bwd(*args, **kwargs)
        return dfeats, dw * 0.5
    setattr(sparse_conv, attr, halved)
    return lambda: setattr(sparse_conv, attr, bwd)


def half_batch():
    """A fault planted in the system: each step runs on the first half of
    its batch's rows, the mean taken over them."""
    from benchmark import port
    step = port.train_step

    def half(net, opt, batch, gen):
        b = batch["points"].shape[0]
        return step(net, opt, {k: v[: b // 2] for k, v in batch.items()},
                    gen)
    port.train_step = half
    return lambda: setattr(port, "train_step", step)


FAULTS = {"k3_dw": lambda: dw_halved("subm_conv_bwd"),
          "k4_dw": lambda: dw_halved("strided_conv_bwd"),
          "half_batch": half_batch}


def held(readings, limits):
    """The limits of the numbers a control reads: the reference in the
    system's place makes no kernel call to probe (k3_dw_gap, k4_dw_gap),
    so the control is held to the others."""
    return {k: v for k, v in limits.items()
            if k in readings or not k.endswith("_dw_gap")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--system", action="store_true",
                    help="read sound runs of the system instead")
    ap.add_argument("--fault", choices=sorted(FAULTS), default=None,
                    help="read the system with a planted fault instead")
    args = ap.parse_args(argv)
    from benchmark import port
    from benchmark.registry import Registry
    reg = Registry(ROOT)
    cell = reg.cell(args.workload)
    doc, traffic = reg.config(cell), reg.traffic(cell)
    dev = torch.device("cuda")
    predict = traffic["mode"] == "predict"
    if args.system or args.fault:
        port.build_kernels()
        fn = system_predict if predict else system_train
        what = args.fault or "system"
    else:
        fn = control_predict if predict else control_train
        what = "tf32"
    undo = FAULTS[args.fault]() if args.fault else None
    try:
        for seed in args.seeds:
            t = time.perf_counter()
            readings = fn(doc, traffic, seed, dev)
            print(json.dumps({"workload": args.workload, "control": what,
                              "seed": seed, "s": time.perf_counter() - t,
                              "readings": readings}), flush=True)
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        if undo is not None:
            undo()
    return 0


if __name__ == "__main__":
    sys.exit(main())
