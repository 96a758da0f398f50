"""Where the data-parallel step's differences and costs come from.

    python3 -m srfdet3d_torch.bench.ddp_probe
        [--parts decisions localize softmax world1 lc]

Needs one CUDA card; run from the root of a checkout (it imports that
checkout's chip_smoke.py).  Builds the kernels, then, in this process:

- `decisions`: the flagship (`srfdet_voxel_nusc_L`, dropout off) at batch
  4, one train step from the seeded weights, then one step on weights x
  (1 + 1e-7 N) for two noise seeds: how many of the step's discrete
  decisions flipped (chip_smoke.Decisions: ReLU masks, RoI levels,
  sample corners, OTA matches, box extremes, clipped centers) and how
  far the grads moved (|g - g_ref| /
  |g_ref|, the worst leaf over its largest grad); the same steps playing
  back the seeded run's decisions: all of them, the ReLU masks alone, all
  but the ReLU masks, and all of them at noise 1e-9, 1e-8 and 1e-6; a
  rerun of the seeded step (the card's float atomics);
- `localize`: the seeded step and a played-back noise step, every
  module's output gradient and the proposals', RoIs' and pooled
  features' gradients fingerprinted (localize_part): where the two
  part, in backward order;
- `softmax`: the DPG's mixture softmax and the sigmoid of its centers in
  the seeded step and a played-back noise step: their inputs, their
  backward in float32 against float64, and how far the noise moves
  their inputs, cotangents and backward (softmax_part);
- `world1`: the flagship at batch 2, 5 timed steps after one warm-up
  with no group, in an NCCL group of one, in that group with the
  earlier synced BatchNorm2d (six elementwise ops under autograd, kept
  here to compare), and with no group again: p50, peak, and one profiled
  step each (device time, the top kernels);
- `lc`: `srfdet_voxel_r50_LC` at its batch a card, 3 steps in an NCCL
  group of one, then 3 with no group, each from a fresh model: step ms
  and peak GB (the group's run first, so its first step searches cuDNN's
  algorithms).

Each part prints JSON lines; last, the card's name and power limit.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import statistics
import sys
import time


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def perturb_weights(model, eps: float, seed: int) -> None:
    """Every parameter times (1 + eps N(0, 1)), seeded."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1 + eps * torch.randn(p.shape, device=p.device,
                                         generator=g))


def decisions_part(cs) -> None:
    import torch
    from srfdet3d_torch.models.detector import SRFDet
    from srfdet3d_torch.train.trainer import make_optimizer
    cfg = cs.ddp_config()
    batch = {k: v.cuda() for k, v in cs.ddp_batch(cfg).items()}

    def step(seed=None, replay=None, eps=1e-7):
        model = SRFDet(cfg, device="cuda", seed=0)
        if seed is not None:
            perturb_weights(model, eps, seed)
        opt = make_optimizer(model, cfg, total_steps=1000)
        row = cs.ddp_steps(model, opt, batch, cs.train_launches(model),
                           keep_grads=True, steps=1,
                           replay=None if replay is None else [replay])[0]
        names = [n for n, p in model.named_parameters()
                 if any(p is q for q in opt.params)]
        sizes = [p.numel() for p in opt.params]
        del model, opt
        cs.free_cache()
        return row, names, sizes

    ref, names, sizes = step()
    played = ref["decisions"]

    def against(tag, row):
        rel, worst, leaf = cs.grad_errors(row["grads"], ref["grads"], sizes,
                                          names)
        _emit(dict(part="decisions", run=tag, grad_rel=rel,
                   worst_leaf_err=worst, worst_leaf=leaf,
                   grad_norm_rel=abs(row["metrics"]["grad_norm"] /
                                     ref["metrics"]["grad_norm"] - 1),
                   loss_rel=abs(row["metrics"]["loss"] /
                                ref["metrics"]["loss"] - 1),
                   flips=cs.decision_flips(row["decisions"], played)))

    against("rerun", step()[0])
    for seed in (1, 2):
        against(f"noise{seed}", step(seed)[0])
        against(f"noise{seed}_play_all", step(seed, played)[0])
    for kinds in (("relu",), ("level", "corners", "ota")):
        against("noise1_play_" + "_".join(kinds),
                step(1, {k: played[k] for k in kinds})[0])
    # is what remains with every decision played back linear in the noise
    for eps in (1e-9, 1e-8, 1e-6):
        against(f"noise1_{eps:g}_play_all", step(1, played, eps)[0])


def localize_part(cs) -> None:
    """Where the played-back noise step's grads leave the seeded step's:
    every module's output gradient, and the gradients of the proposals
    and of each iteration's RoIs and pooled features, fingerprinted by
    their norm and four seeded random projections, in backward order,
    for the seeded step and one step on weights x (1 + 1e-7 N) that plays
    back its decisions; prints every proposal, RoI and pooled gradient
    and the modules whose estimated relative difference passes 1e-3,
    the first 80."""
    import torch
    from srfdet3d_torch.models.detector import SRFDet
    from srfdet3d_torch.train.trainer import make_optimizer
    cfg = cs.ddp_config()
    batch = {k: v.cuda() for k, v in cs.ddp_batch(cfg).items()}

    def step(seed=None, replay=None):
        from srfdet3d_torch.models import head as head_mod
        model = SRFDet(cfg, device="cuda", seed=0)
        if seed is not None:
            perturb_weights(model, 1e-7, seed)
        prints, seen = [], {}

        def fingerprint(name, g):
            k = seen.get(name, 0)
            seen[name] = k + 1
            gen = torch.Generator(device=g.device).manual_seed(
                hash((name, k)) % (2 ** 31))
            r = torch.randn((4,) + tuple(g.shape), device=g.device,
                            generator=gen)
            proj = (r * g.detach().float()).flatten(1).sum(1)
            prints.append(((name, k), float(g.norm()), proj.cpu().tolist()))

        def hook(name):
            def fn(mod, grad_in, grad_out):
                g = grad_out[0] if grad_out else None
                if isinstance(g, torch.Tensor):
                    fingerprint(name, g)
            return fn

        def watch(name, t):
            if isinstance(t, torch.Tensor) and t.requires_grad:
                t.register_hook(lambda g: fingerprint(name, g))
            return t
        # the functions between the DPG and the heads' modules: the
        # proposals, and the RoIs and pooled features of every iteration
        init_plain = head_mod.SRFDetHead.init_proposals
        align_plain = head_mod.multilevel_roi_align

        def init_watched(mod, *args, **kwargs):
            boxes, prop = init_plain(mod, *args, **kwargs)
            return watch("init.boxes", boxes), watch("init.prop", prop)

        def align_watched(feats, rois, *args, **kwargs):
            watch("roi_align.rois", rois)
            return watch("roi_align.out", align_plain(feats, rois, *args,
                                                      **kwargs))
        head_mod.SRFDetHead.init_proposals = init_watched
        head_mod.multilevel_roi_align = align_watched
        handles = [m.register_full_backward_hook(hook(n))
                   for n, m in model.named_modules() if n]
        opt = make_optimizer(model, cfg, total_steps=1000)
        try:
            row = cs.ddp_steps(model, opt, batch, cs.train_launches(model),
                               keep_grads=False, steps=1,
                               replay=None if replay is None else [replay])[0]
        finally:
            for h in handles:
                h.remove()
            head_mod.SRFDetHead.init_proposals = init_plain
            head_mod.multilevel_roi_align = align_plain
        del model, opt
        cs.free_cache()
        return row, prints

    ref, ref_prints = step()
    _, noisy = step(1, ref["decisions"])
    shown = 0
    for (key, norm, proj), (key2, _, proj2) in zip(ref_prints, noisy):
        if key != key2:
            _emit(dict(part="localize", order_differs=[key, key2]))
            break
        rel = (sum((a - b) ** 2 for a, b in zip(proj, proj2)) / 4) ** 0.5 \
            / max(norm, 1e-30)
        watched = key[0].startswith(("init.", "roi_align."))
        if (watched or rel > 1e-3) and shown < 80:
            shown += 1
            _emit(dict(part="localize", module=key[0], call=key[1],
                       rel=rel, norm=norm))


def softmax_part(cs) -> None:
    """The DPG's mixture (SRFDetHead.init_proposals: the softmax over the
    num_dpg_exp experts, then the sigmoid of the proposals' centers) in
    the seeded flagship step at batch 4 and in one on weights x (1 + 1e-7
    N) that plays back its decisions.  For each of the two functions: its
    inputs' size, its backward on the seeded step's own cotangent in
    float32 against float64, how far the noise moved its inputs and its
    cotangent, and how far the noise step's backward (its own inputs and
    cotangent, float32) lies from the seeded one's."""
    import torch
    from srfdet3d_torch.models.detector import SRFDet
    from srfdet3d_torch.train.trainer import make_optimizer
    cfg = cs.ddp_config()
    batch = {k: v.cuda() for k, v in cs.ddp_batch(cfg).items()}
    fns = dict(softmax=torch.softmax, sigmoid=torch.sigmoid)

    def run(seed=None, replay=None):
        model = SRFDet(cfg, device="cuda", seed=0)
        if seed is not None:
            perturb_weights(model, 1e-7, seed)
        n_exp, n_p = model.bbox_head.num_dpg_exp, cfg.head.num_proposals
        seen = {}

        def keep(name, x, out):
            if name not in seen:
                seen[name] = [x.detach().clone(), None]
                out.register_hook(
                    lambda g: seen[name].__setitem__(1, g.clone()))
            return out

        def softmax(x, dim=None, **kwargs):
            out = fns["softmax"](x, dim=dim, **kwargs)
            if dim == 1 and x.ndim == 3 and x.shape[1] == n_exp:
                keep("softmax", x, out)
            return out

        def sigmoid(x, *args, **kwargs):
            out = fns["sigmoid"](x, *args, **kwargs)
            if x.ndim == 3 and x.shape[1:] == (n_p, 3) and x.requires_grad:
                keep("sigmoid", x, out)
            return out
        torch.softmax, torch.sigmoid = softmax, sigmoid
        opt = make_optimizer(model, cfg, total_steps=1000)
        try:
            row = cs.ddp_steps(model, opt, batch, cs.train_launches(model),
                               keep_grads=False, steps=1,
                               replay=None if replay is None else [replay])
        finally:
            torch.softmax, torch.sigmoid = fns["softmax"], fns["sigmoid"]
        del model, opt
        cs.free_cache()
        return row[0], seen

    def backward(name, x, g, dt):
        x = x.to(dt).requires_grad_(True)
        y = fns[name](x, dim=1) if name == "softmax" else fns[name](x)
        return torch.autograd.grad(y, x, g.to(dt))[0].double()

    def rel(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm())

    row, ref = run()
    _, noisy = run(1, row["decisions"])
    for name in fns:
        (x, g), (x1, g1) = ref[name], noisy[name]
        g64 = backward(name, x, g, torch.float64)
        _emit(dict(part="softmax", fn=name,
                   inputs_abs_max=float(x.abs().max()),
                   grad_f32_vs_f64_rel=rel(backward(name, x, g,
                                                    torch.float32), g64),
                   noise_inputs_abs_max=float((x1 - x).abs().max()),
                   noise_inputs_rel=rel(x1, x),
                   noise_cotangent_rel=rel(g1, g),
                   noise_grad_rel=rel(backward(name, x1, g1, torch.float32),
                                      backward(name, x, g, torch.float32))))


def _old_synced_forward(self, x):
    """The earlier train-mode BatchNorm2d under a group: the statistics and
    the normalization as elementwise ops under autograd."""
    import torch
    from srfdet3d_torch.parallel import mesh
    if not self.training:
        return torch.nn.BatchNorm2d.forward(self, x)
    red = (0, 2, 3)
    local = torch.stack([x.mean(red), (x * x).mean(red)])
    mean, mean2 = mesh.all_reduce_sum(local) / mesh.world()
    var = (mean2 - mean * mean).clamp_min(0.0)
    with torch.no_grad():
        m = self.momentum
        self.running_mean.mul_(1 - m).add_(m * mean)
        self.running_var.mul_(1 - m).add_(m * var)
        self.num_batches_tracked.add_(1)
    shape = (1, -1, 1, 1)
    y = (x - mean.view(shape)) * torch.rsqrt(var + self.eps).view(shape)
    return y * self.weight.view(shape) + self.bias.view(shape)


def _nccl_group():
    import torch.distributed as dist
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
        world_size=1, rank=0, timeout=datetime.timedelta(seconds=120))


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _timed_steps(cs, cfg, batch, steps, profile=False, prepare=None):
    """A fresh seeded model's `steps` train steps (the first a warm-up):
    per-step ms, peak GB, and with profile the device time and top
    kernels of one more step."""
    import torch
    from srfdet3d_torch.models.detector import SRFDet
    from srfdet3d_torch.train.trainer import make_optimizer, train_step
    model = SRFDet(cfg, device="cuda", seed=0)
    if prepare is not None:
        prepare(model)
    opt = make_optimizer(model, cfg, total_steps=1000)
    want = cs.train_launches(model)
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(steps):
        cs.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_step(model, opt, batch, gen)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        cs.check_launches("ddp_probe", cs.read_counts(), want, 1)
    out = dict(step_ms=ms, p50_ms=statistics.median(ms[1:]),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    if profile:
        from torch.profiler import ProfilerActivity, profile as prof
        with prof(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as p:
            train_step(model, opt, batch, gen)
            torch.cuda.synchronize()
        dev = []
        for e in p.key_averages():
            t = getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0)) / 1e3
            if t > 0:
                dev.append((e.key, t, e.count))
        dev.sort(key=lambda d: -d[1])
        out.update(device_ms=sum(d[1] for d in dev),
                   top=[dict(name=k[:80], ms=v, calls=c)
                        for k, v, c in dev[:12]])
    del model, opt
    cs.free_cache()
    return out


def world1_part(cs) -> None:
    import torch
    import torch.distributed as dist
    from srfdet3d_torch.configs import srfdet_voxel_nusc_L
    from srfdet3d_torch.models import layers
    cfg = srfdet_voxel_nusc_L()
    batch = {k: v.cuda() for k, v in
             cs.synthetic_batch(cfg, 2, seed=0, with_gt=True).items()}
    new_forward = layers.BatchNorm2d.forward
    for run in ("no_group", "nccl_world1", "nccl_world1_old_bn2d",
                "no_group_again"):
        if run.startswith("nccl"):
            _nccl_group()
        if run.endswith("old_bn2d"):
            layers.BatchNorm2d.forward = _old_synced_forward
        try:
            out = _timed_steps(cs, cfg, batch, 6, profile=True)
        finally:
            layers.BatchNorm2d.forward = new_forward
            if dist.is_initialized():
                dist.destroy_process_group()
        _emit(dict(part="world1", run=run, batch=2, **out))


def lc_part(cs) -> None:
    import torch.distributed as dist
    from srfdet3d_torch.configs import CONFIGS
    cfg = CONFIGS["srfdet_voxel_r50_LC"]()
    b = cfg.optim.batch_size_per_device
    batch = {k: v.cuda() for k, v in cs.train_batch(cfg, b).items()}
    for run in ("nccl_world1", "no_group"):
        if run.startswith("nccl"):
            _nccl_group()
        try:
            out = _timed_steps(cs, cfg, batch, 3,
                               prepare=cs.seed_dcn_offsets)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        _emit(dict(part="lc", run=run, config=cfg.name, batch=b, **out))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--parts", nargs="+",
                    default=["decisions", "localize", "softmax", "world1",
                             "lc"])
    args = ap.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    import torch
    if not torch.cuda.is_available():
        print("ddp_probe: no CUDA device", file=sys.stderr)
        return 1
    from srfdet3d_torch import set_backend_flags
    from srfdet3d_torch.ops import cuda_build
    set_backend_flags()
    cuda_build.build_kernels(["gather_conv", "eqmatch", "gather_conv_bwd",
                              "roi_scatter", "rulebook_lookup"])
    parts = dict(decisions=decisions_part, localize=localize_part,
                 softmax=softmax_part,
                 world1=world1_part, lc=lc_part)
    for name in args.parts:
        t0 = time.perf_counter()
        parts[name](cs)
        _emit(dict(part=name, seconds=time.perf_counter() - t0))
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
