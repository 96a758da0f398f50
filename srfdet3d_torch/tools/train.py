"""Training CLI of the port (the JAX package's `tools/train.py`).

Usage:
  python -m srfdet3d_torch.tools.train <config_name> [--work-dir DIR]
      [--resume-from CKPT] [--load-from CKPT] [--epochs N]
      [--batch-size B] [--seed S] [--synthetic] [--data-root PATH]
      [--ann-file PATH] [--db-info PKL] [--no-cbgs] [--debug-nans]
      [--device DEV] [--cfg-options k=v ...]

config_name is one of srfdet3d_torch.configs.CONFIGS.  --synthetic trains
on generated scenes (no dataset needed).  --cfg-options takes dotted keys
into the frozen config dataclasses, e.g. optim.lr=1e-4
optim.accum_steps=2.  --device defaults to cuda; pass cpu to run the
plain versions of the kernels on the CPU.  --debug-nans turns on
autograd's anomaly detection (a NaN made in a backward raises there) and
raises FloatingPointError at the first step whose loss is not finite.

Checkpoints go to <work-dir>/<config>/epoch_<n>.pt; a first SIGTERM or
SIGINT saves preempt_<step>.pt after the step in flight and exits, and
--resume-from that file continues mid-epoch at the same batch.

Data-parallel training runs one process per card (dist_train.sh, which
starts them with torchrun; or one process a host with SRFDET_COORD_ADDR,
SRFDET_NUM_HOSTS and SRFDET_HOST_ID as for the JAX package).  Each rank
runs on cuda:LOCAL_RANK unless --device names one, joins the group
(`parallel.mesh.init_from_env`: NCCL on CUDA, gloo on the CPU,
SRFDET_DIST_BACKEND overrides), starts from rank 0's weights and
optimizer state, and trains on its rows of the same seeded global batch
(`shard_rows`).  The global batch is --batch-size, or the config's
batch_size_per_device times the ranks, cut to a multiple of ranks x
accum_steps.  Rank 0 alone writes config.json, env.json, the log lines
and the checkpoints, then every rank meets it at a barrier; the ranks
agree on a preemption signal after every step, so a signal that reaches
one rank stops them all at the same step.  --eval-interval is skipped
with more than one rank, as in the JAX CLI: evaluate the checkpoints
with dist_test.sh.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import signal
import statistics
import sys
import time
from typing import Dict, List, Optional

import torch

from ..parallel import mesh


def apply_cfg_options(cfg, options):
    """Dotted-key overrides into nested frozen dataclasses."""
    for opt in options or []:
        key, _, raw = opt.partition("=")
        try:
            val = json.loads(raw)
        except json.JSONDecodeError:
            val = raw
        parts = key.split(".")
        objs = [cfg]
        for p in parts[:-1]:
            objs.append(getattr(objs[-1], p))
        new_leaf = val                      # rebuild from the leaf outwards
        for depth in range(len(parts) - 1, -1, -1):
            new_leaf = dataclasses.replace(
                objs[depth], **{parts[depth]: new_leaf})
        cfg = new_leaf
    return cfg


# per-class paste counts (cfg ObjectSample sample_groups,
# srfdet_voxel_nusc_L.py:229-240)
NUS_GROUPS = dict(car=2, truck=3, construction_vehicle=7, bus=4, trailer=6,
                  barrier=2, motorcycle=6, bicycle=6, pedestrian=2,
                  traffic_cone=2)
KITTI_GROUPS = dict(Car=12, Pedestrian=6, Cyclist=6)
# filter_by_min_points: nuScenes uses 5 for every class
# (srfdet_voxel_nusc_L.py:217-227); KITTI 5/10/10 (srfdet_voxel_kitti_L.py:230)
KITTI_MIN_POINTS = dict(Car=5, Pedestrian=10, Cyclist=10)


def dataset_class(cfg):
    from ..data import KittiDataset, NuScenesDataset, WaymoDataset
    return {"nuscenes": NuScenesDataset, "kitti": KittiDataset,
            "waymo": WaymoDataset}[cfg.dataset]


def db_sampler(cfg, db_info: str, data_root: str):
    """The GT-database paste augmentation with the reference configs'
    sample groups and minimum points."""
    from ..data import DBSampler
    nus = cfg.dataset == "nuscenes"
    return DBSampler(
        info_path=db_info, data_root=data_root, classes=cfg.class_names,
        sample_groups=NUS_GROUPS if nus else KITTI_GROUPS,
        min_points=({c: 5 for c in cfg.class_names} if nus
                    else KITTI_MIN_POINTS),
        points_load_dim=cfg.points_dim,
        points_use_dim=tuple(range(cfg.points_dim)))


def train_dataset(cfg, data_root: str, ann_file: Optional[str] = None,
                  db_info: Optional[str] = None, seed: int = 0,
                  cbgs: bool = True):
    """The train split as the CLI reads it: the config's dataset class on
    <data_root>/<dataset>_infos_train.pkl (or ann_file), the GT-database
    paste with db_info, and CBGS on nuScenes unless cbgs is False."""
    from ..data import CBGSWrapper
    sampler = db_sampler(cfg, db_info, data_root) if db_info else None
    ann = ann_file or os.path.join(data_root,
                                   f"{cfg.dataset}_infos_train.pkl")
    dataset = dataset_class(cfg)(cfg, info_path=ann, data_root=data_root,
                                 seed=seed, db_sampler=sampler)
    if cfg.dataset == "nuscenes" and cbgs:
        dataset = CBGSWrapper(dataset)
    return dataset


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("config")
    ap.add_argument("--work-dir", default="work_dirs")
    ap.add_argument("--resume-from", default=None)
    ap.add_argument("--load-from", default=None)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--synthetic-length", type=int, default=32)
    ap.add_argument("--data-root", default="data/nuscenes")
    ap.add_argument("--ann-file", default=None)
    ap.add_argument("--db-info", default=None,
                    help="GT-database pickle for ObjectSample paste "
                         "augmentation (e.g. nuscenes_dbinfos_train.pkl)")
    ap.add_argument("--log-interval", type=int, default=50)
    ap.add_argument("--ckpt-interval", type=int, default=1)
    ap.add_argument("--eval-interval", type=int, default=0,
                    help="run validation eval every N epochs (mmcv "
                         "EvalHook); 0 = off")
    ap.add_argument("--no-cbgs", action="store_true")
    ap.add_argument("--debug-nans", action="store_true",
                    help="autograd anomaly detection (the reference's "
                         "set_detect_anomaly, train.py:317) and a finite "
                         "check of every step's loss; both raise")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--cfg-options", nargs="*", default=None)
    return ap


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv: Optional[List[str]] = None) -> Dict:
    """Train; returns the run's record: the trained model and its
    optimizer, the first and last step, the last checkpoint and the ms of
    its saves, whether a signal preempted the run, the last step's
    metrics, and per step the host ms spent waiting for the loader and the
    ms of the step itself (ending in a device sync)."""
    args = build_parser().parse_args(argv)
    dev = mesh.rank_device(args.device)
    joined = mesh.init_from_env(dev)
    try:
        return _train(args, argv, dev)
    finally:
        if joined:
            mesh.shutdown()


def _train(args, argv, dev: torch.device) -> Dict:
    from ..configs import get_config
    from ..data import SyntheticDataset, data_loader
    from ..models.detector import SRFDet
    from ..train.trainer import (make_lr_schedule, make_optimizer,
                                 step_generator, train_step)
    from ..utils.checkpoint import (load_pretrained, restore_checkpoint,
                                    save_checkpoint)
    from ..utils.logging import MetricLogger

    cfg = apply_cfg_options(get_config(args.config), args.cfg_options)
    epochs = args.epochs or cfg.optim.epochs
    rank, world = mesh.rank(), mesh.world()
    main_rank = rank == 0
    work_dir = os.path.join(args.work_dir, cfg.name)
    if main_rank:
        os.makedirs(work_dir, exist_ok=True)
        # reproducibility capture (reference train.py:174-212: cfg.dump +
        # collect_env + seed/exp meta)
        with open(os.path.join(work_dir, "config.json"), "w") as f:
            json.dump(dataclasses.asdict(cfg), f, indent=1, default=str)
        with open(os.path.join(work_dir, "env.json"), "w") as f:
            json.dump({"torch": torch.__version__,
                       "cuda": torch.version.cuda, "device": str(dev),
                       "device_name": (torch.cuda.get_device_name(dev)
                                       if dev.type == "cuda" else "cpu"),
                       "world_size": world,
                       "backend": (torch.distributed.get_backend()
                                   if mesh.active() else None),
                       "seed": args.seed, "argv": sys.argv if argv is None
                       else list(argv)}, f, indent=1)
    mesh.barrier()

    batch_size = args.batch_size or cfg.optim.batch_size_per_device * world
    # every microbatch of an accumulation step takes batch / accum rows of
    # every rank (JAX tools/train.py:117-122)
    quantum = world * max(cfg.optim.accum_steps, 1)
    batch_size = max(batch_size - batch_size % quantum, quantum)

    if args.synthetic:
        dataset = SyntheticDataset(cfg, length=args.synthetic_length,
                                   seed=args.seed)
    else:
        dataset = train_dataset(cfg, args.data_root, args.ann_file,
                                args.db_info, args.seed,
                                cbgs=not args.no_cbgs)

    steps_per_epoch = max(len(dataset) // batch_size, 1)
    total_steps = steps_per_epoch * epochs
    if main_rank:
        print(f"config={cfg.name} device={dev} ranks={world} "
              f"batch={batch_size} steps/epoch={steps_per_epoch} "
              f"epochs={epochs}", flush=True)

    model = SRFDet(cfg, device=dev, seed=args.seed)
    opt = make_optimizer(model, cfg, total_steps)
    schedule = make_lr_schedule(cfg.optim, total_steps)
    if args.load_from:
        # parameters AND BN running statistics (frozen-BN fine-tuning
        # keeps the pretrained ones)
        load_pretrained(model, args.load_from)
    host_step = 0
    if args.resume_from:
        # every rank reads the same file
        host_step = restore_checkpoint(args.resume_from, model, opt)
        if main_rank:
            print(f"resumed from {args.resume_from} @ step {host_step}",
                  flush=True)
    # every rank starts from rank 0's weights and moments, bit for bit
    mesh.broadcast_module(model)
    mesh.broadcast_tensors([opt.mu, opt.nu])
    logger = MetricLogger(args.log_interval)

    val_dataset = None
    if args.eval_interval > 0 and world > 1:
        if main_rank:
            print("eval-interval: skipped with more than one rank; "
                  "evaluate the checkpoints with dist_test.sh", flush=True)
    elif args.eval_interval > 0:
        if args.synthetic:
            val_dataset = SyntheticDataset(
                cfg, length=max(args.synthetic_length // 4, 2),
                seed=args.seed + 999, augment=False)
        else:
            val_dataset = dataset_class(cfg)(
                cfg, info_path=os.path.join(
                    args.data_root, f"{cfg.dataset}_infos_val.pkl"),
                data_root=args.data_root, test_mode=False, augment=False)

    record = {"config": cfg.name, "model": model, "opt": opt,
              "batch_size": batch_size,
              "steps_per_epoch": steps_per_epoch, "first_step": host_step,
              "wait_ms": [], "step_ms": [], "save_ms": [],
              "checkpoint": None, "preempted": False, "metrics": {}}

    # preemption-safe shutdown: the FIRST SIGTERM/SIGINT sets a flag
    # checked after every step, batch fetch, checkpoint and eval; the loop
    # saves preempt_<step>.pt and returns, so --resume-from continues on
    # the next allocation.  The handler restores the default disposition,
    # so a SECOND signal terminates at once.
    preempted = {"sig": None}

    def _on_preempt(signum, frame):
        preempted["sig"] = signum
        signal.signal(signum, signal.SIG_DFL)

    def save(name: str, meta: Dict) -> str:
        """Rank 0 writes; every rank waits for the file."""
        path = os.path.join(work_dir, name)
        t0 = time.perf_counter()
        if main_rank:
            save_checkpoint(path, model, opt, step=host_step, meta=meta)
            record["save_ms"].append((time.perf_counter() - t0) * 1e3)
        mesh.barrier()
        record["checkpoint"] = path
        return path

    def preempt_save() -> bool:
        # a signal may reach one rank only: every rank asks them all here
        if not mesh.any_rank(preempted["sig"] is not None):
            return False
        path = save(f"preempt_{host_step}.pt", {
            "config": cfg.name, "classes": cfg.class_names,
            "step": host_step, "preempted": True})
        if main_rank:
            sig = preempted["sig"] if world == 1 else (
                f"{preempted['sig']} on rank 0" if preempted["sig"]
                else "on another rank")
            print(f"preemption signal {sig}: saved {path}", flush=True)
        record["preempted"] = True
        return True

    previous = {sig: signal.signal(sig, _on_preempt)
                for sig in (signal.SIGTERM, signal.SIGINT)}
    anomaly = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(anomaly or args.debug_nans)
    last: Dict[str, torch.Tensor] = {}
    try:
        start_epoch = host_step // steps_per_epoch
        for epoch in range(start_epoch, epochs):
            dataset.epoch = epoch             # vary per-index aug draws
            # mid-epoch resume: the loader's order is seed-deterministic
            # per epoch, so the host_step-offset batch continues where
            # training left off; skipped samples are never materialized
            skip = max(host_step - epoch * steps_per_epoch, 0)
            batches = data_loader(dataset, batch_size, shuffle=True,
                                  seed=args.seed + epoch,
                                  skip_batches=skip,
                                  shard=((rank, world) if mesh.active()
                                         else None))
            t0 = time.perf_counter()
            for batch in batches:
                t1 = time.perf_counter()
                if preempt_save():           # signal during a data stall
                    return record
                metrics = train_step(
                    model, opt, {k: torch.from_numpy(v)
                                 for k, v in batch.items()},
                    step_generator(model, args.seed, host_step))
                _sync(dev)
                t2 = time.perf_counter()
                if args.debug_nans and not torch.isfinite(metrics["loss"]):
                    raise FloatingPointError(
                        f"step {host_step}: loss {float(metrics['loss'])}")
                last = metrics
                record["wait_ms"].append((t1 - t0) * 1e3)
                record["step_ms"].append((t2 - t1) * 1e3)
                host_step += 1
                if main_rank and host_step % args.log_interval == 0:
                    logger.log(host_step,
                               {k: float(v) for k, v in metrics.items()},
                               lr=schedule(host_step))
                if preempt_save():
                    return record
                t0 = time.perf_counter()
            if (epoch + 1) % args.ckpt_interval == 0 or epoch == epochs - 1:
                path = save(f"epoch_{epoch + 1}.pt", {
                    "config": cfg.name, "classes": cfg.class_names,
                    "epoch": epoch + 1, "step": host_step})
                if main_rank:
                    print(f"saved {path}", flush=True)
            if preempt_save():
                return record
            if val_dataset is not None and \
                    (epoch + 1) % args.eval_interval == 0:
                from .test import run_inference_eval
                res = run_inference_eval(cfg, val_dataset, model,
                                         batch_size=1, device=dev)
                logger.log_eval(host_step, {k: v for k, v in res.items()
                                            if not isinstance(v, dict)})
                if preempt_save():           # signal during the eval pass
                    return record
    finally:
        torch.autograd.set_detect_anomaly(anomaly)
        for sig, handler in previous.items():
            signal.signal(sig, handler)
        record["last_step"] = host_step
        record["metrics"] = {k: float(v) for k, v in last.items()}
    who = f"rank {rank}: " if world > 1 else ""
    if record["step_ms"]:
        wait, step = record["wait_ms"], record["step_ms"]
        print(f"{who}training done: {len(step)} steps, step p50 "
              f"{statistics.median(step):.1f} ms, loader wait "
              f"{sum(wait) / (sum(wait) + sum(step)):.3f} of the loop",
              flush=True)
    else:
        print(f"{who}training done", flush=True)
    return record


if __name__ == "__main__":
    main()
