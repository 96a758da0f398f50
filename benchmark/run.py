"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA cards.  The
cell (BENCHMARK.json) names its configuration and traffic mix; set-up
imports the system (`srfdet3d_torch`), builds or finds its kernels under
build/kernels, makes the weights on the card from the seed, makes the
pool of inputs on the card and keeps it pinned on the host, and warms the
cell's shapes; then the window runs for `--seconds`.  With `--trace 0` the
result's metrics are the cell's end-to-end metrics; with `--trace 1` the
window's last TRACE_SECONDS run under torch.profiler with the benchmark's
spans (the part before them, untraced, gives the time a frame or step
takes without the profiler), and the metrics are the cell's per-layer
ones.  After
the window, with the system's state freed, the plain reference checks
what the window produced (compare.py) against the cell's limits
(benchmark/limits/<cell>.json).  The last line of standard output is the
result (one JSON object); the numbers compared, each beside its limit, are
the last lines of standard error and the result's last key.

Exits non-zero with no result when there is no CUDA card or fewer than
the cell asks for, when the system is absent, and when JAX, jaxlib, flax,
optax or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# a traced window is at most this long: its trace is reduced in the run
TRACE_SECONDS = 5.0
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "srfdet3d_tpu")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Context:
    """What the per-layer readers read (benchmark/metrics/*.py): the
    traced part of the window (`trace`, its `frames`, each frame's NMS
    sweeps and sparse convs) and the untraced part before it
    (`plain_frames` frames or steps in `plain_s` seconds, their model
    `flops`), which gives the time a frame or step takes without the
    profiler's cost on the host."""

    def __init__(self, mode, trace, frames, nms_sweeps, convs,
                 plain_frames, plain_s, flops):
        self.mode, self.trace, self.frames = mode, trace, frames
        self.nms_sweeps, self.convs = nms_sweeps, convs
        self.plain_frames, self.plain_s, self.flops = (plain_frames,
                                                       plain_s, flops)


def run(workload: str, seed: int, seconds: float, trace: bool,
        registry=None, device: str = "cuda", tweak=None) -> dict:
    """One run of a cell; returns the result object.  `device` "cpu" and
    `tweak(cfg_doc, traffic)` serve the CPU tests alone (a tiny config on
    the plain versions); a measured run is on the card."""
    import torch

    from benchmark import cells, compare, port, scene
    from benchmark.registry import Registry
    reg = registry or Registry(ROOT)
    cell = reg.cell(workload)
    doc, traffic = reg.config(cell), reg.traffic(cell)
    limits = reg.limits(cell)
    if tweak is not None:
        tweak(doc, traffic)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    mode = traffic["mode"]
    parts = {}

    port.system()
    t = time.perf_counter()
    if on_card:
        parts["kernels_s"] = port.build_kernels()
    cfg = port.config(doc)
    t = time.perf_counter()
    net = port.model(cfg, seed, dev)
    parts["model_s"] = time.perf_counter() - t
    t = time.perf_counter()
    pool = scene.make_pool(traffic, doc, seed, dev)
    parts["pool_s"] = time.perf_counter() - t
    if mode == "predict":
        cell_run = cells.PredictCell(net, pool, dev, seed,
                                     traffic["check_share"])
    else:
        cell_run = cells.TrainCell(cfg, net, pool, dev, seed)
    t = time.perf_counter()
    cell_run.warm()
    if on_card:
        torch.cuda.synchronize()
    parts["warm_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - T_START
    setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    # the window allocates and frees tensors only: no cycles for the
    # collector to find, and none of its pauses in the timings
    gc.collect()
    gc.freeze()
    gc.disable()
    tr = None
    sweeps = []
    if trace:
        from benchmark import trace as tracing
        # the window's untraced part first: the time a frame or step
        # takes without the profiler, which slows the host
        untraced = cell_run.window(max(seconds - TRACE_SECONDS, 0.5 * seconds))
        stages = port.modules(net)
        spans = tracing.Spans(stages, wrap=port.k3_call())
        win = {}

        def on_frame():
            if mode == "predict":
                sweeps.append(port.nms_sweeps())

        def body():
            win.update(cell_run.window(min(seconds, TRACE_SECONDS),
                                       on_frame))
        try:
            if on_card:
                tr = tracing.profile(body)
            else:
                body()
        finally:
            spans.close()
    else:
        win = cell_run.window(seconds)
    gc.enable()
    window_peak = torch.cuda.max_memory_allocated() if on_card else 0
    frames = win["frames"] + (untraced["frames"] if trace else 0)
    e2e = cell_run.e2e(win)
    e2e["peak_mem_gib"] = window_peak / 2 ** 30
    e2e["setup_s"] = setup_s

    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {bad}")
        raise SystemExit(3)

    # the check: the system's state freed first, then the reference
    record = getattr(cell_run, "record", None)
    cell_run.close()
    del net
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    flops, convs = [], []
    t = time.perf_counter()
    if mode == "predict":
        ref_cfg, ref_net = compare.reference(doc, seed, dev)
        readings, per_entry = compare.predict_readings(
            cell_run, ref_cfg, ref_net, count=trace)
        if trace:
            # each window part serves the pool from its first entry
            flops = [per_entry[i % len(pool)][0]
                     for i in range(untraced["frames"])]
            convs = [per_entry[i % len(pool)][1]
                     for i in range(win["frames"])]
    else:
        ref_run = compare.reference_steps(doc, seed, pool, dev,
                                          cells.CHECKED_STEPS, record,
                                          count=trace)
        readings = compare.train_readings(record, ref_run)
        if trace and ref_run["followed"]:
            # the steps go on from the checked ones through the pool;
            # the reference's step s ran pool entry s
            first = cells.CHECKED_STEPS
            flops = [ref_run["flops"][(first + j) % len(pool)]
                     for j in range(untraced["frames"])]
            convs = [ref_run["convs"][(first + untraced["frames"] + j) %
                                      len(pool)]
                     for j in range(win["frames"])]
    parts["check_s"] = time.perf_counter() - t
    correct, rows = compare.judge(readings, limits)
    wrong = readings.get("answers_wrong", 0.0)
    failed = int(wrong) if math.isfinite(wrong) else frames

    result = {"correct": bool(correct), "attempted": frames,
              "failed": failed if mode == "predict" else
              (0 if correct else frames)}
    if trace:
        ctx = Context(mode, tr, win["frames"], sweeps, convs,
                      untraced["frames"], untraced["window_s"], flops)
        metrics = {}
        for m in reg.per_layer(cell):
            val = reg.reader(m["name"])(ctx) if tr is not None else None
            if val is not None:
                metrics[m["name"]] = {"value": float(val), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(e2e[m["name"]]),
                               "unit": m["unit"]}
                   for m in reg.end_to_end(cell)}
    result["metrics"] = metrics
    result["device"] = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": int(cell["chips"]),
        "memory_peak_bytes": int(max(setup_peak, window_peak))}
    if tr is not None:
        result["device"]["busy_s"] = tr.busy_s()
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    result["check"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    log(json.dumps({"setup_parts_s": parts, "window_s": win["window_s"],
                    "frames": win["frames"],
                    "untraced": ({k: untraced[k] for k in ("frames", "window_s")}
                                 if trace else None),
                    "readings": readings,
                    "card": power_limit() if on_card else "cpu",
                    "e2e": e2e}))
    for n, v, lim in rows:
        log(f"check {n} {v!r} limit {lim!r}")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    # load from one process with few threads: the host's dispatch is one
    # Python thread; keep it on two cores of its own, and torch's CPU
    # pool (which the card's path does not use) at one thread
    cores = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, cores[-2:])
    import torch
    torch.set_num_threads(1)
    from benchmark.registry import Registry
    need = Registry(ROOT).cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        log(f"{args.workload} needs {need} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run(args.workload, args.seed, args.seconds, bool(args.trace))
    # once more before the result: the reference and the metric readers
    # are loaded after the window
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {bad}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
