"""Smoke test of the PyTorch port on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: the five CUDA kernels' sources in srfdet3d_torch/csrc, in
   parallel;
3. gather_conv (K1) against its plain version on real flagship rulebooks,
   at every conv shape of the sparse encoder, and on srfdet_voxel_kitti_L's
   bitmap rulebooks at its conv shapes (Cin 4, 16/32/64, conv_out
   64 -> 128); per conv the time a launch (back-to-back events, which
   include the wrapper's host path) and the bound of the 3xTF32 work the
   kernel does (bound_ms, also printed as tc_bound_ms: flops at 165
   TFLOP/s against HBM's bytes), with simt_bound_ms (flops at the f32
   CUDA-core rate, the bound of the earlier SIMT kernels) beside it; the
   kernel-only device time comes in phase 13;
4. eqmatch (K2) against subm_rulebook_bitmap at the 4 flagship stages,
   exact;
5. conv_bwd (K3 subm, K4 strided) against their plain versions on the
   flagship train step's rulebooks (batch 2), at every conv shape, with
   the same times and bounds as K1; K4 also holds its reverse rulebook and
   row grouping (strided_prep, on the card) exactly against the plain
   versions and reports their time (prep_ms), the host time of a wrapper
   call (host_ms: the enqueue, the wrapper never waits on the card) and
   the dfeats tiles' offset steps, grouped and in voxel order, against
   the hits' least;
6. roi_bwd (K5) against index_add_ at the flagship head's geometry (batch
   2 x 900 RoIs, four levels at C 128, patch 32, 64 fallback slots), with
   the global atomics a launch before the window sums (one a live corner
   sample and channel) and after (one a distinct live cell and channel),
   and the max difference of two launches (atomic order); then sync_free:
   one K4 and one K5 backward under torch.cuda.set_sync_debug_mode("error")
   (a host sync raises), their results equal to the checked ones;
7. rulebook_lookup (K6) against its plain version, exact, at every lookup
   of the table-backend encoder of srfdet_voxel_kitti_L (65,536 voxel
   slots) and of the flagship (120k voxel slots), walking the rulebooks
   only;
8. flagship srfdet_voxel_nusc_L predict at full width, batch 1, on a
   synthetic scene and seeded random weights: launch counts, finite
   outputs, p50 latency, valid boxes, peak memory; plus decode_boxes with
   score_thr=0 so NMS sees its full 900 x 10 load; then the same predict
   split at its layer boundaries (time and peak memory of each part);
9. srfdet_voxel_kitti_L predict at full width, batch 1, the same way, once
   on its shipped bitmap backend and once with middle.rulebook="table";
10. flagship train step at full width, batch 2 with synthetic GT, dropout
   as configured: launch counts of all five kernels, finite losses, a
   finite grad for every parameter and every parameter moved, step p50,
   peak memory, the step split into forward, loss + OTA, backward and
   optimizer, and one step under torch.profiler (device busy time and
   share, the kernels that took most of it);
11. tiny predicts (tiny_test_config; tiny_kitti_test_config and
   tiny_test_config with middle.rulebook="table"), and 12. two tiny train
   steps, with the kernels on the card against the same weights on the CPU
   with the plain versions;
13. gather_gemm device times of every K1 conv (flagship and KITTI) and
   every K3 / K4 conv, one line each: the kernels' own device time from
   torch.profiler (kernel_device_ms; for K4 with its preparation kernels,
   and their share as prep_device_ms), and K5's (roi_bwd_device),
   measured after every end-to-end phase;
14. the `kernels` line: per kernel, launches (per flagship predict for K1
   and K2, per flagship train step for K3-K5, per KITTI table predict for
   K6), max error against the plain version, and times per predict or per
   train step (kernel, plain version, bound, one PyTorch library call);
   the gather-GEMM kernels K1, K3 and K4 also carry tc_bound_ms (equal
   to their bound_ms), simt_bound_ms and device_ms (profiler), K5
   device_ms.

The second-to-last line is nvidia-smi's name and power limit; the last line
is {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and float32
# CUDA-core flop/s, the bound of a float32 kernel without tensor cores;
# the 3xTF32 rate, three TF32 tensor-core products (495 TFLOP/s) for each
# f32-faithful one, bounds the gather-GEMM kernels K1, K3 and K4
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_3XTF32 = 495e12 / 3
# the gather-GEMM kernels' own device code, by name in a profiler trace;
# the strided backward (K4) also runs its preparation kernels (reverse
# rulebook, row grouping: 5 launches), K5 its one kernel
GATHER_GEMM_KERNELS = ("gather_gemm::kernel", "dw_partial_kernel",
                       "dw_reduce_kernel")
STRIDED_PREP_KERNELS = ("strided_prep",)
STRIDED_PREP_LAUNCHES = 5
ROI_SCATTER_KERNELS = ("roi_scatter_kernel",)
# cycles of torch.cuda._sleep that keep the card busy (~10 ms) at a
# profiler session's start, so that the session sees every launch after it
SPIN_CYCLES = 20_000_000
# every kernel against its plain version: rtol + atol * sqrt(terms summed
# into an output element); the kernel sums in another order than the plain
# version (K5 with atomics, in an order that changes from run to run), so
# float32 rounding differs by a few ulps per term
RTOL, ATOL = 1e-5, 1e-5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def synthetic_batch(cfg, b: int = 1, seed: int = 0, with_gt: bool = False):
    """The JAX package's synthetic scene (__graft_entry__._synthetic_batch):
    half of points_cap real, uniform in pc_range, seeded; with_gt adds
    gt_cap GT boxes of which the first 8 are valid."""
    rng = np.random.default_rng(seed)
    p = cfg.points_cap
    pts = np.zeros((b, p, cfg.points_dim), np.float32)
    n = p // 2
    lo, hi = cfg.pc_range[:3], cfg.pc_range[3:6]
    for d in range(3):
        pts[:, :n, d] = rng.uniform(lo[d], hi[d], (b, n))
    pts[:, :n, 3:] = rng.uniform(0, 1, (b, n, cfg.points_dim - 3))
    mask = np.zeros((b, p), bool)
    mask[:, :n] = True
    batch = {"points": pts, "points_mask": mask}
    if with_gt:
        g = cfg.gt_cap
        gt = np.zeros((b, g, 9 if cfg.head.code_size == 10 else 7),
                      np.float32)
        gt[..., 0] = rng.uniform(lo[0] * 0.8, hi[0] * 0.8, (b, g))
        gt[..., 1] = rng.uniform(lo[1] * 0.8, hi[1] * 0.8, (b, g))
        gt[..., 2] = rng.uniform(lo[2] * 0.5, hi[2] * 0.5, (b, g))
        gt[..., 3:6] = rng.uniform(0.5, 4.0, (b, g, 3))
        gt[..., 6] = rng.uniform(-np.pi, np.pi, (b, g))
        batch["gt_labels"] = rng.integers(0, cfg.num_classes,
                                          (b, g)).astype(np.int32)
        gmask = np.zeros((b, g), bool)
        gmask[:, :min(8, g)] = True
        batch["gt_boxes"], batch["gt_mask"] = gt, gmask
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def encoder_rulebooks(cfg, batch, dev):
    """Walk the encoder's bitmap rulebooks on the card for the batch's B
    samples, in the encoder's run order (either layout: basicblock or
    conv_module).  Returns the gather_conv cases [(name, rows N, rulebook
    (M, K), Cin, Cout, launches per forward)], the subm convs of one level
    of the same widths merged into one case, and the eq-match cases
    [(level, ColumnSet, vcol, vz, vyx, mask)], one per subm level.  Names
    count levels: down{i} leaves level i, stage{i}_subm runs on it."""
    from srfdet3d_torch.models.sparse_encoder import BitmapRulebooks
    from srfdet3d_torch.ops.voxelize import voxelize_points_batched
    spec = cfg.voxelization
    m = cfg.middle
    vox = voxelize_points_batched(batch["points"].to(dev),
                                  batch["points_mask"].to(dev), spec)
    rb = BitmapRulebooks(vox.voxel_coords, vox.voxel_mask,
                         spec.sparse_shape)
    conv, subm = [], []

    def stage_subm(i):
        subm.append((i, rb.cs, rb.vcol, rb.vz, rb.vyx, rb.mask))
        return rb.subm().reshape(-1, 27)

    def add_subm(level, cin, cout, count):
        name = f"stage{level}_subm"
        last = conv[-1]
        if last[0] == name and last[3:5] == (cin, cout):
            conv[-1] = last[:5] + (last[5] + count,)
        else:
            conv.append((name, rows, gidx, cin, cout, count))

    b = batch["points"].shape[0]
    rows = b * spec.max_voxels
    gidx = stage_subm(0)
    conv.append(("conv_input", rows, gidx, m.in_channels, m.base_channels, 1))
    cin, level = m.base_channels, 0
    basic = m.block_type == "basicblock"
    n_stages = len(m.encoder_channels)
    for i, blocks in enumerate(m.encoder_channels):
        for j, out_ch in enumerate(blocks):
            if basic:
                is_down = j == len(blocks) - 1 and i != n_stages - 1
            else:
                is_down = i != 0 and j == 0
            if is_down:
                pad = m.encoder_paddings[i][j]
                down = rb.downsample(pad, m.capacities[level]).reshape(-1, 27)
                conv.append((f"down{level}", rows, down, cin, out_ch, 1))
                rows = b * m.capacities[level]
                level += 1
                gidx = stage_subm(level)
            else:
                add_subm(level, cin, out_ch, 2 if basic else 1)
            cin = out_ch
    out = rb.convout(m.capacities[-1]).reshape(-1, 3)
    conv.append(("conv_out", rows, out, cin, m.output_channels, 1))
    return conv, subm


def kernel_device_ms(fn, per_call: int, iters: int = 10, tries: int = 3,
                     names=GATHER_GEMM_KERNELS):
    """The named kernels' own device ms (default GATHER_GEMM_KERNELS) a
    call of fn, from torch.profiler key_averages over `iters` calls; unlike
    a back-to-back event timing it leaves out the wrapper's host path.  A
    session may miss the launches at its start, so each starts with a spin
    of the card and counts only if it saw per_call of those kernels a call;
    None when none of `tries` sessions did."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        own, seen = 0.0, 0
        for e in prof.key_averages():
            if getattr(e, "device_type", None) != DeviceType.CUDA or \
                    not any(name in e.key for name in names):
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0.0)
            own += us
            seen += e.count
        if seen == per_call * iters:
            return own / 1e3 / iters
    return None


def bounds(flops: float, nbytes: float):
    """(bound ms, what bounds it, SIMT bound ms) of a gather-GEMM call: the
    larger of bytes over HBM's rate and flops over the 3xTF32 rate, the
    rate of the work the kernels do; and the larger of bytes and flops over
    the f32 CUDA-core rate, the bound of the earlier SIMT kernels, for
    comparison."""
    tc, bb = flops / PEAK_3XTF32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (max(tc, bb), "operations" if tc >= bb else "bytes",
            max(flops / PEAK_F32 * 1e3, bb))


def add_bound(totals, times: int, bound: float, bound_by: str,
              simt: float) -> None:
    """Add `times` calls' bounds to a kernel's sums; ops_bound_ms and
    bytes_bound_ms split the bound by what bounds each call."""
    totals["bound_ms"] += times * bound
    totals["tc_bound_ms"] += times * bound
    totals["simt_bound_ms"] += times * simt
    key = "ops_bound_ms" if bound_by == "operations" else "bytes_bound_ms"
    totals[key] += times * bound


def check_gather_conv(config, cases, dev, gen):
    """K1 at every conv shape of one config's encoder: against the plain
    version, then ms a launch (back-to-back events), the plain version,
    index_select + matmul, and the 3xTF32 and SIMT bounds.  Returns the
    max error and the sums over a predict."""
    from srfdet3d_torch.ops.gather_conv import gather_conv, gather_conv_plain
    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                  tc_bound_ms=0.0, simt_bound_ms=0.0, ops_bound_ms=0.0,
                  bytes_bound_ms=0.0)
    max_err = 0.0
    for name, n, idx, cin, cout, per_predict in cases:
        m, k = idx.shape
        feats = torch.randn(n, cin, generator=gen).to(dev)
        w = (torch.randn(k, cin, cout, generator=gen) *
             math.sqrt(2.0 / (k * cin))).to(dev)
        got = gather_conv(feats, idx, w)
        ref = gather_conv_plain(feats, idx, w)
        torch.cuda.synchronize()
        err = (got - ref).abs()
        tol = RTOL * ref.abs() + ATOL * math.sqrt(k * cin)
        if not bool((err <= tol).all()):
            raise AssertionError(f"gather_conv {name}: max err "
                                 f"{float(err.max())} over tolerance")
        max_err = max(max_err, float(err.max()))
        table0 = torch.cat([feats, feats.new_zeros(1, cin)])
        w2 = w.reshape(k * cin, cout)
        flat = idx.reshape(-1).long()
        ms = time_ms(lambda: gather_conv(feats, idx, w))
        plain_ms = time_ms(lambda: gather_conv_plain(feats, idx, w))
        lib_ms = time_ms(lambda: torch.index_select(table0, 0, flat)
                         .view(m, k * cin) @ w2)
        nnz = int((idx < n).sum())
        flops = 2.0 * nnz * cin * cout
        nbytes = 4.0 * (m * k + n * cin + k * cin * cout + m * cout)
        bound, bound_by, simt = bounds(flops, nbytes)
        row = dict(phase="gather_conv", config=config, conv=name, n=n, m=m,
                   k=k, cin=cin, cout=cout, launches_per_predict=per_predict,
                   max_abs_err=float(err.max()), ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=bound, bound_by=bound_by,
                   tc_bound_ms=bound, simt_bound_ms=simt, nnz=nnz)
        emit(row)
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("library_ms", lib_ms)):
            totals[key] += per_predict * val
        add_bound(totals, per_predict, bound, bound_by, simt)
    return max_err, totals


def check_eqmatch(cases):
    from srfdet3d_torch.ops.bitmap_rulebook import (column_tables,
                                                    subm_rulebook_bitmap)
    from srfdet3d_torch.ops.eqmatch import eqmatch_rulebook
    totals = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
    for stage, cs, vcol, vz, vyx, mask in cases:
        keys, words, starts = column_tables(cs)
        yb = (vyx[..., 0] - 1).int()
        xb = (vyx[..., 1] - 1).int()
        zb = (vz - 1).int()
        valid = mask.to(torch.uint8)
        hw = cs.shape[1:]

        def kernel():
            return eqmatch_rulebook(keys, words, starts, yb, xb, zb, valid,
                                    hw, cs.row_cap)

        def plain():
            return subm_rulebook_bitmap(cs, vcol, vz, mask)

        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            bad = int((got != ref).sum())
            raise AssertionError(f"eqmatch stage {stage}: {bad} entries "
                                 f"differ from subm_rulebook_bitmap")
        ms, plain_ms = time_ms(kernel), time_ms(plain)
        q = mask.numel()
        nbytes = keys.numel() * 24 + q * 13 + q * 27 * 4
        bound = nbytes / PEAK_BYTES * 1e3
        emit(dict(phase="eqmatch", stage=stage, voxels=q,
                  valid=int(mask.sum()), columns=int(cs.cmask.sum()),
                  grid=list(cs.shape), exact=True, ms=ms, plain_ms=plain_ms,
                  bound_ms=bound, bound_by="bytes"))
        totals["ms"] += ms
        totals["plain_ms"] += plain_ms
        totals["bound_ms"] += bound
    return totals


def host_ms(fn, calls: int = 20) -> float:
    """Host ms of one call of fn, which must not wait on the card: the
    mean over `calls` back-to-back calls of the time to enqueue them."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return ms


def check_strided_prep(idx, n, cin):
    """K4's preparation on the card (reverse rulebook, row grouping)
    exactly against the plain versions on the CPU; its event ms and the
    dfeats tiles' offset steps (tile rows: 64 above 64 channels of dfeats,
    else 128), grouped and in voxel order, and the least the hits need.
    Returns (rev, extra fields of the conv_bwd line)."""
    from srfdet3d_torch.ops import gather_conv_bwd as gcb
    m = idx.shape[0]
    rev, perm = gcb.strided_prep(idx, n)
    torch.cuda.synchronize()
    ref_rev, ref_perm = gcb.strided_prep(idx.cpu(), n)
    if not torch.equal(rev.cpu(), ref_rev):
        raise AssertionError("strided_prep: the reverse rulebook differs")
    if not torch.equal(perm.cpu(), ref_perm):
        raise AssertionError("strided_prep: the row grouping differs")
    bm = 64 if cin > 64 else 128
    extra = dict(prep_ms=time_ms(lambda: gcb.strided_prep(idx, n)),
                 groups=int(gcb.group_keys(rev, m).unique().numel()),
                 tile_rows=bm,
                 tile_offset_steps=gcb.tile_offset_steps(rev, m, perm, bm),
                 tile_offset_steps_voxel_order=gcb.tile_offset_steps(
                     rev, m, None, bm),
                 hit_offset_steps=gcb.tile_offset_steps(rev, m, None, 1)
                 / bm)
    return rev, extra


def check_conv_bwd(cases, dev, gen):
    """K3 and K4 at every conv of the flagship train step (batch 2): dfeats
    (where the step needs it; conv_input's input has no parameters) and dW
    against the plain versions, then times per launch: back-to-back
    events, the plain version, gather + cuBLAS, and the 3xTF32 and SIMT
    bounds; for K4 also check_strided_prep and the wrapper's host ms."""
    from srfdet3d_torch.ops import gather_conv_bwd as gcb
    totals = {kind: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                         tc_bound_ms=0.0, simt_bound_ms=0.0,
                         ops_bound_ms=0.0, bytes_bound_ms=0.0,
                         max_abs_err=0.0)
              for kind in ("subm", "strided")}
    for name, n, idx, cin, cout, per_step in cases:
        m, k = idx.shape
        subm = name == "conv_input" or name.endswith("_subm")
        kind = "subm" if subm else "strided"
        need = name != "conv_input"
        feats = torch.randn(n, cin, generator=gen).to(dev)
        w = (torch.randn(k, cin, cout, generator=gen) *
             math.sqrt(2.0 / (k * cin))).to(dev)
        g = torch.randn(m, cout, generator=gen).to(dev)
        if subm:
            rb = idx
            w_bwd = w.flip(0)

            def kern():
                return gcb.subm_conv_bwd(feats, idx, w, g, need)

            def plain():
                return gcb.gather_bwd_plain(feats, idx, w, g, True, need)
        else:
            rb, extra = check_strided_prep(idx, n, cin)
            w_bwd = w

            def kern():
                return gcb.strided_conv_bwd(feats, idx, w, g, need)

            def plain():
                return gcb.scatter_bwd_plain(feats, idx, w, g, need)
        (got_f, got_w), (ref_f, ref_w) = kern(), plain()
        torch.cuda.synchronize()
        if not subm:
            extra["host_ms"] = host_ms(kern)
        hits = idx < n
        nnz = int(hits.sum())
        per_offset = int(hits.sum(0).max())
        errs = []
        for what, got, ref, terms in (("dW", got_w, ref_w, per_offset),
                                      ("dfeats", got_f, ref_f, k * cout)):
            if ref is None:
                continue
            err = (got - ref).abs()
            tol = RTOL * ref.abs() + ATOL * math.sqrt(max(terms, 1))
            if not bool((err <= tol).all()):
                raise AssertionError(f"conv_bwd {name} {what}: max err "
                                     f"{float(err.max())} over tolerance")
            errs.append(float(err.max()))
        g0 = torch.cat([g, g.new_zeros(1, cout)])
        flat_rb = rb.reshape(-1).long()
        wt2 = w_bwd.transpose(1, 2).reshape(k * cout, cin)

        def library():
            gat = torch.index_select(g0, 0, flat_rb).view(n, k * cout)
            dw = feats.t() @ gat
            return (gat @ wt2 if need else None), dw
        ms = time_ms(kern)
        plain_ms = time_ms(plain)
        lib_ms = time_ms(library)
        products = 2 if need else 1
        flops = products * 2.0 * nnz * cin * cout
        nbytes = 4.0 * (n * cin + m * k + m * cout + 2 * k * cin * cout +
                        (n * cin if need else 0))
        bound, bound_by, simt = bounds(flops, nbytes)
        emit(dict(phase="conv_bwd", kernel="K3" if subm else "K4", conv=name,
                  n=n, m=m, k=k, cin=cin, cout=cout, dfeats=need,
                  launches_per_step=per_step, max_abs_err=max(errs), ms=ms,
                  plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                  bound_by=bound_by, tc_bound_ms=bound, simt_bound_ms=simt,
                  nnz=nnz, **({} if subm else extra)))
        t = totals[kind]
        t["max_abs_err"] = max(t["max_abs_err"], max(errs))
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("library_ms", lib_ms)):
            t[key] += per_step * val
        add_bound(t, per_step, bound, bound_by, simt)
    return totals


def check_roi_bwd(cfg, dev, gen):
    """K5 at the flagship head's geometry: batch 2 x 900 RoIs from boxes
    of nuScenes-like sizes anywhere in range, the four FPN levels at C 128,
    patch 32 with 64 fallback slots; against index_add_ (the plain
    version).  The global atomics a launch, counted from the corners on the
    card: before the window sums one a live corner sample and channel,
    after one a distinct live table row of a RoI and channel.  Returns one
    launch's numbers and the launch's inputs."""
    from srfdet3d_torch.models.detector import bev_geometry
    from srfdet3d_torch.models.head import lidar_rois_from_boxes
    from srfdet3d_torch.ops.roi_align import corner_samples
    from srfdet3d_torch.ops.roi_scatter import (roi_scatter,
                                                roi_scatter_plain,
                                                sample_grads)
    hc = cfg.head
    b, r, c, out, sr = 2, hc.num_proposals, hc.feat_channels_lidar, 7, 2
    _, sizes = bev_geometry(cfg)
    rng = np.random.default_rng(1)
    lo, hi = np.array(cfg.pc_range[:3]), np.array(cfg.pc_range[3:6])
    boxes = np.zeros((b, r, hc.code_size), np.float32)
    boxes[..., :3] = rng.uniform(lo, hi, (b, r, 3))
    boxes[..., 3:6] = np.log(rng.uniform(0.5, 12.0, (b, r, 3)))
    yaw = rng.uniform(-np.pi, np.pi, (b, r))
    boxes[..., 6], boxes[..., 7] = np.sin(yaw), np.cos(yaw)
    rois = lidar_rois_from_boxes(torch.from_numpy(boxes).to(dev),
                                 cfg.pc_range, cfg.voxel_size)
    cs = corner_samples(sizes, rois, hc.lidar_strides, out, sr,
                        patch=hc.roi_patch,
                        patch_fallback=hc.roi_patch_fallback)
    idx, wgt, drop = cs.idx, cs.wgt, cs.drop
    rows = b * sum(h * w for h, w in sizes)
    gp = torch.randn(b * r, out, out, c, generator=gen).to(dev)
    args = (gp, cs.cells, cs.cw, cs.level, drop, rows, sr)

    def kern():
        return roi_scatter(*args)

    def plain():
        return roi_scatter_plain(gp, idx, wgt, drop, rows, sr)
    got, ref = kern(), plain()
    again = kern()
    torch.cuda.synchronize()
    live = (wgt != 0) & ~drop[:, None, None, None]
    per_row = int(torch.bincount(idx[live].reshape(-1),
                                 minlength=rows).max())
    err = (got - ref).abs()
    tol = RTOL * ref.abs() + ATOL * math.sqrt(max(per_row, 1))
    if not bool((err <= tol).all()):
        raise AssertionError(f"roi_scatter: max err {float(err.max())} "
                             f"over tolerance")
    rid = torch.arange(b * r, device=dev)[:, None, None, None]
    touched = torch.unique(rid.expand_as(idx)[live] * rows + idx[live])
    atomics_before = int(live.sum()) * c
    atomics_after = int(touched.numel()) * c
    flat_idx = idx.reshape(-1)
    contrib = (wgt[..., None] * sample_grads(gp, drop, sr)[:, None]
               ).reshape(-1, c)
    dt0 = torch.zeros(rows, c, device=dev)

    def library():
        return dt0.index_add_(0, flat_idx, contrib)
    ms, plain_ms, lib_ms = time_ms(kern), time_ms(plain), time_ms(library)
    del contrib
    # the function's inputs read once (gp, the per-axis corners, their
    # weights, the levels, drop) and the table cotangent written once
    nbytes = (4.0 * (gp.numel() + cs.cells.numel() + cs.cw.numel() +
                     cs.level.numel() + rows * c) + drop.numel())
    bound = nbytes / PEAK_BYTES * 1e3
    row = dict(phase="roi_bwd", rois=b * r, levels=sizes, c=c,
               patch=hc.roi_patch, fallback=hc.roi_patch_fallback,
               dropped=int(drop.sum()), max_adds_per_row=per_row,
               max_abs_err=float(err.max()),
               run_to_run_max_diff=float((got - again).abs().max()),
               atomics_before=atomics_before, atomics_after=atomics_after,
               ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
               bound_by="bytes")
    emit(row)
    return row, (args, got, per_row)


def sync_free(strided_case, roi_case, dev, gen):
    """One K4 backward (a strided conv of the train step) and one K5
    backward under torch.cuda.set_sync_debug_mode("error"), which raises at
    any host sync; each result equal to the same call's outside it."""
    from srfdet3d_torch.ops import gather_conv_bwd as gcb
    from srfdet3d_torch.ops.roi_scatter import roi_scatter
    name, n, idx, cin, cout, _ = strided_case
    k = idx.shape[1]
    feats = torch.randn(n, cin, generator=gen).to(dev)
    w = torch.randn(k, cin, cout, generator=gen).to(dev)
    g = torch.randn(idx.shape[0], cout, generator=gen).to(dev)
    roi_args, roi_ref, per_row = roi_case
    ref_f, ref_w = gcb.strided_conv_bwd(feats, idx, w, g)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got_f, got_w = gcb.strided_conv_bwd(feats, idx, w, g)
        got_t = roi_scatter(*roi_args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    # K4 sums in a fixed order: equal bits; K5's atomics add RoIs in an
    # order that changes from run to run, so within the roi_bwd tolerance
    if not (torch.equal(got_f, ref_f) and torch.equal(got_w, ref_w)):
        raise AssertionError(f"sync_free: K4 at {name} differs")
    diff = float((got_t - roi_ref).abs().max())
    tol = RTOL * roi_ref.abs() + ATOL * math.sqrt(max(per_row, 1))
    if not bool(((got_t - roi_ref).abs() <= tol).all()):
        raise AssertionError(f"sync_free: K5 differs by {diff}")
    emit(dict(phase="sync_free", mode="error", k4_conv=name,
              k5_rois=roi_args[0].shape[0], k5_max_diff=diff, ok=True))


def table_lookups(cfg, batch, dev):
    """Walk the table-backend encoder's rulebooks on the card and keep the
    inputs of every K6 launch: [(lookup name, keys, rows, queries,
    sentinel)], in run order (the stage-0 subm, then per downsample its
    input lookup and the next stage's subm, then conv_out)."""
    from srfdet3d_torch.models.sparse_encoder import (TableRulebooks,
                                                      down_pads)
    from srfdet3d_torch.ops import sparse_conv
    from srfdet3d_torch.ops.voxelize import voxelize_points_batched
    spec = cfg.voxelization
    m = cfg.middle
    vox = voxelize_points_batched(batch["points"].to(dev),
                                  batch["points_mask"].to(dev), spec)
    cases = []
    real = sparse_conv.rulebook_lookup

    def record(keys, rows, queries, sentinel):
        cases.append((names.pop(0), keys, rows, queries, sentinel))
        return real(keys, rows, queries, sentinel)
    pads = down_pads(m.block_type, m.encoder_channels, m.encoder_paddings)
    first = 1 if m.block_type == "conv_module" else 0
    names = ["stage0_subm"]
    for i in range(len(pads)):
        names += [f"down{i + first}", f"stage{i + 1}_subm"]
    names.append("conv_out")
    sparse_conv.rulebook_lookup = record
    try:
        rb = TableRulebooks(vox.voxel_coords, vox.voxel_mask,
                            spec.sparse_shape)
        rb.subm()
        for i, pad in enumerate(pads):
            rb.downsample(pad, m.capacities[i])
            rb.subm()
        rb.convout(m.capacities[-1])
    finally:
        sparse_conv.rulebook_lookup = real
    return cases


def check_rulebook_lookup(config, cases):
    """K6 at every lookup of one table encoder walk: exact against the
    plain version; ms a launch, the plain version, torch.searchsorted on
    the same sorted keys with its equality check and row gather, and the
    byte bound (queries, output, keys and rows once).  Returns the sums
    over the walk (one predict's lookups)."""
    from srfdet3d_torch.ops.rulebook_lookup import (rulebook_lookup,
                                                    rulebook_lookup_plain)
    totals = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    for name, keys, rows, queries, sentinel in cases:
        n = keys.numel()

        def kernel():
            return rulebook_lookup(keys, rows, queries, sentinel)

        def plain():
            return rulebook_lookup_plain(keys, rows, queries, sentinel)
        flat = queries.reshape(-1)

        def library():
            pos = torch.searchsorted(keys, flat).clamp_max_(n - 1)
            return torch.where(keys[pos] == flat, rows[pos], n)
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            bad = int((got != ref).sum())
            raise AssertionError(f"rulebook_lookup {config} {name}: {bad} "
                                 f"entries differ from the plain version")
        lib = library()
        if not torch.equal(lib.view(ref.shape).to(torch.int32), ref):
            raise AssertionError(f"rulebook_lookup {config} {name}: the "
                                 f"library route disagrees")
        ms, plain_ms, lib_ms = time_ms(kernel), time_ms(plain), \
            time_ms(library)
        nbytes = queries.numel() * (8 + 4) + n * (8 + 4)
        bound = nbytes / PEAK_BYTES * 1e3
        emit(dict(phase="rulebook_lookup", config=config, lookup=name,
                  keys=n, queries=list(queries.shape),
                  hits=int((ref < n).sum()), exact=True, ms=ms,
                  plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                  bound_by="bytes"))
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("library_ms", lib_ms), ("bound_ms", bound)):
            totals[key] += val
    return totals


COUNTED = ("gather_conv", "eqmatch", "subm_bwd", "strided_bwd",
           "roi_scatter", "rulebook_lookup")
TRAIN_KERNELS = COUNTED[:5]


def reset_counts():
    from srfdet3d_torch.ops import (eqmatch, gather_conv, gather_conv_bwd,
                                    roi_scatter, rulebook_lookup)
    gather_conv.launches = 0
    eqmatch.launches = 0
    gather_conv_bwd.subm_launches = 0
    gather_conv_bwd.strided_launches = 0
    roi_scatter.launches = 0
    rulebook_lookup.launches = 0


def read_counts():
    """Launches since reset_counts of the kernels in COUNTED order."""
    from srfdet3d_torch.ops import (eqmatch, gather_conv, gather_conv_bwd,
                                    roi_scatter, rulebook_lookup)
    return dict(zip(COUNTED, (gather_conv.launches, eqmatch.launches,
                              gather_conv_bwd.subm_launches,
                              gather_conv_bwd.strided_launches,
                              roi_scatter.launches,
                              rulebook_lookup.launches)))


def all_finite(out) -> bool:
    return all(bool(torch.isfinite(v.float()).all()) for v in out.values())


def predict_launches(model):
    """Launches per predict the model's structure gives: every gathered
    conv once (K1); on the bitmap backend one eq-match per subm stage (K2),
    on the table backend one lookup per subm stage, per downsample and for
    conv_out (K6)."""
    from srfdet3d_torch.models.sparse_encoder import GatheredConvBN
    enc = model.pts_middle_encoder
    convs = sum(isinstance(mod, GatheredConvBN) for mod in enc.modules())
    stages = len(model.cfg.middle.encoder_channels)
    want = dict.fromkeys(COUNTED, 0)
    want["gather_conv"] = convs
    if enc.use_bitmap:
        want["eqmatch"] = stages
    else:
        want["rulebook_lookup"] = 2 * stages
    return want


def predict_phase(phase, cfg, batch, smi, expect):
    """One config's predict at full width, batch 1: launch counts against
    `expect`, finite outputs, p50 over 20 predicts, peak memory, decode
    with score_thr=0, then the parts.  Returns the counts."""
    from srfdet3d_torch.geometry import iou
    from srfdet3d_torch.models.detector import SRFDet
    from srfdet3d_torch.models.head import decode_boxes
    model = SRFDet(cfg, device="cuda", seed=0)
    dev_batch = {k: v.cuda() for k, v in batch.items()}
    torch.cuda.synchronize()
    reset_counts()
    out = model.predict(dev_batch)
    torch.cuda.synchronize()
    counts = read_counts()
    predict_sweeps = iou.last_nms_sweeps
    if counts != expect:
        raise AssertionError(f"{phase} launched {counts}, expected "
                             f"{expect}")
    if not all_finite(out):
        raise AssertionError(f"{phase} gave non-finite outputs")
    with torch.no_grad():
        logits, boxes = model(dev_batch)
    if not (bool(torch.isfinite(logits).all()) and
            bool(torch.isfinite(boxes).all())):
        raise AssertionError(f"{phase}: forward gave non-finite outputs")
    t = cfg.test
    full = decode_boxes(logits[-1], boxes[-1], nms_thr=t.nms_thr,
                        score_thr=0.0, max_per_img=t.max_per_img,
                        post_center_range=t.post_center_range)
    torch.cuda.synchronize()
    if not all_finite(full):
        raise AssertionError("decode_boxes(score_thr=0) gave non-finite "
                             "outputs")
    full_sweeps = iou.last_nms_sweeps

    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.predict(dev_batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()

    def decode_full():
        decode_boxes(logits[-1], boxes[-1], nms_thr=t.nms_thr,
                     score_thr=0.0, max_per_img=t.max_per_img,
                     post_center_range=t.post_center_range)
    decode_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode_full()
        torch.cuda.synchronize()
        decode_ms.append((time.perf_counter() - t0) * 1e3)
    emit(dict(phase=phase, config=cfg.name, rulebook=cfg.middle.rulebook,
              batch=1, points=cfg.points_cap, launches=counts, finite=True,
              p50_ms=statistics.median(times), min_ms=min(times),
              max_ms=max(times), runs=len(times),
              valid_boxes=int(out["valid"].sum()),
              max_score=float(torch.sigmoid(logits[-1]).max()),
              nms_sweeps=predict_sweeps,
              full_nms_valid_boxes=int(full["valid"].sum()),
              full_nms_sweeps=full_sweeps,
              full_nms_decode_p50_ms=statistics.median(decode_ms),
              peak_mem_bytes=peak, device=smi))
    predict_parts(phase.replace("predict", "parts"), model, dev_batch, smi)
    return counts


def predict_parts(phase, model, batch, smi, runs: int = 5):
    """Predict split at its layer boundaries, each part ended by a
    synchronize: median host ms and peak device memory of each part."""
    from srfdet3d_torch.models.head import decode_boxes
    t = model.cfg.test
    points, mask = model._inputs(batch)

    def run():
        feats, vox = model.voxel_features(points, mask)
        yield "voxelize_vfe"
        bev = model.pts_middle_encoder(feats, vox.voxel_coords,
                                       vox.voxel_mask)
        yield "sparse_encoder"
        maps = model.pts_neck(model.pts_backbone(
            bev.permute(0, 3, 1, 2).contiguous()))
        yield "second_fpn"
        logits, boxes = model.bbox_head(maps)
        yield "head"
        decode_boxes(logits[-1], boxes[-1], nms_thr=t.nms_thr,
                     score_thr=t.score_thr, max_per_img=t.max_per_img,
                     post_center_range=t.post_center_range)
        yield "decode_nms"

    ms, peak = {}, {}
    with torch.no_grad():
        for _ in range(runs):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for part in run():
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                ms.setdefault(part, []).append((t1 - t0) * 1e3)
                peak[part] = torch.cuda.max_memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
    emit(dict(phase=phase, config=model.cfg.name,
              rulebook=model.cfg.middle.rulebook, device=smi,
              p50_ms={k: statistics.median(v) for k, v in ms.items()},
              peak_mem_bytes=peak))


def train_launches(model):
    """Launches per train step the model's structure gives: the forward's
    (predict_launches), every subm conv's backward (K3), every strided and
    conv_out backward (K4), one RoIAlign backward per head iteration
    (K5)."""
    from srfdet3d_torch.models.sparse_encoder import GatheredConvBN
    convs = [mod for mod in model.pts_middle_encoder.modules()
             if isinstance(mod, GatheredConvBN)]
    n_subm = sum(c.subm for c in convs)
    want = predict_launches(model)
    want.update(subm_bwd=n_subm, strided_bwd=len(convs) - n_subm,
                roi_scatter=len(model.bbox_head.heads))
    return want


def device_busy(fn, top: int = 10):
    """One call of fn under torch.profiler: its host ms, the summed device
    ms of its kernels (one stream, so they do not overlap), the busy share
    and the kernels that took most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        kernels.append((us / 1e3, e.count, e.key))
    kernels.sort(reverse=True)
    busy_ms = sum(k[0] for k in kernels)
    return dict(host_ms=wall_ms, device_busy_ms=busy_ms,
                busy_share=busy_ms / wall_ms if busy_ms else None,
                top_kernels=[dict(ms=ms, calls=n, name=name[:90])
                             for ms, n, name in kernels[:top]])


def flagship_train(cfg, smi, warmup: int = 2, steps: int = 10):
    """The flagship train step at full width, batch 2, synthetic scene and
    GT, dropout as configured, seeded random weights."""
    from srfdet3d_torch.models.detector import SRFDet
    from srfdet3d_torch.models.losses import srfdet_losses
    from srfdet3d_torch.train.trainer import make_optimizer, train_step
    model = SRFDet(cfg, device="cuda", seed=0)
    batch = {k: v.cuda() for k, v in
             synthetic_batch(cfg, 2, seed=0, with_gt=True).items()}
    opt = make_optimizer(model, cfg, total_steps=1000)
    gen = torch.Generator(device="cuda").manual_seed(0)
    want = train_launches(model)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}

    def step():
        reset_counts()
        metrics = train_step(model, opt, batch, gen)
        torch.cuda.synchronize()
        counts = read_counts()
        if counts != want:
            raise AssertionError(f"train step launched {counts}, the "
                                 f"model's structure gives {want}")
        bad = [k for k, v in metrics.items()
               if not bool(torch.isfinite(v).all())]
        if bad:
            raise AssertionError(f"train step: non-finite {bad}")
        return metrics

    first = step()
    # every parameter got a finite grad and moved; a parameter can only
    # stay put under AdamW if its grad and its value are exactly zero
    stuck = []
    for name, p in model.named_parameters():
        if p.grad is None or not bool(torch.isfinite(p.grad).all()):
            raise AssertionError(f"train step: {name} has no finite grad")
        if torch.equal(p.detach(), before[name]):
            stuck.append(name)
            if bool(p.grad.any()) or bool(p.detach().any()):
                raise AssertionError(f"train step: {name} did not move")
    del before
    for _ in range(warmup - 1):
        step()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last = step()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()

    busy = device_busy(step)
    parts = {}
    gt = (batch["gt_boxes"], batch["gt_labels"], batch["gt_mask"])
    for _ in range(3):
        model.train()
        for p in opt.params:
            p.grad = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, boxes = model(batch, generator=gen)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        losses = srfdet_losses(logits, boxes, *gt, cfg.loss, cfg.ota,
                               decoder_num_heads=cfg.head.num_heads)
        total = sum(losses.values())
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        total.backward()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        opt.step()
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for part, a, b_ in (("forward", t0, t1), ("loss_ota", t1, t2),
                            ("backward", t2, t3), ("optimizer", t3, t4)):
            parts.setdefault(part, []).append((b_ - a) * 1e3)
    emit(dict(phase="flagship_train", config=cfg.name, batch=2,
              points=cfg.points_cap, gt_valid=8, dropout=cfg.head.dropout,
              launches_per_step=want, finite=True,
              params=sum(p.numel() for p in opt.params),
              leaves=len(opt.params), zero_grad_unmoved=stuck,
              first_loss=float(first["loss"]),
              last_loss=float(last["loss"]),
              first_grad_norm=float(first["grad_norm"]),
              losses={k: float(v) for k, v in last.items()},
              p50_ms=statistics.median(times), min_ms=min(times),
              max_ms=max(times), runs=len(times), peak_mem_bytes=peak,
              parts_p50_ms={k: statistics.median(v)
                            for k, v in parts.items()},
              profiled_step=busy, device=smi))
    return want


def tiny_train(steps: int = 2):
    """Tiny train steps: kernels on the card vs plain versions on the CPU.
    Each step starts both from the same state (the CPU's weights, BN
    statistics and AdamW moments), so each compares one step, not two
    drifting runs.  Per step: losses and the grad norm within rtol 1e-4 +
    atol 1e-5; every grad within 2e-3 of its leaf's largest, or of 1e-5 of
    the tree's largest where that is more (the attention key bias, whose
    grad is zero up to rounding: the softmax ignores a shift along the
    keys, so its few 1e-8 of noise exceed 2e-3 of its own largest); BN
    statistics within rtol
    1e-4 + atol 1e-5; parameters within 1e-6 where both grads are outside
    that tolerance with one sign, and within 2 lr + 1e-6 elsewhere (Adam
    moves a parameter by about lr * sign(grad)).

    The grads of a float32 step are discontinuous where an activation sits
    at a ReLU's kink, so a 1e-6 change of the weights can move a leaf's
    grad by percents.  The config and seeds are picked where it does not:
    `tiny_test_config(points_cap=256, voxels_cap=256, gt_cap=4)`, the
    patch RoIAlign scaled down (8 cells, 2 fallback slots), model seed 2,
    batch seed 5, dropout 0; tests/test_torch_port_train.py::
    test_tiny_train_seeds_are_well_conditioned holds every leaf's grad
    within 1e-3 under 1e-6 noise on the weights, for both steps."""
    import dataclasses
    from srfdet3d_torch.configs import tiny_test_config
    from srfdet3d_torch.models.detector import SRFDet
    from srfdet3d_torch.train.trainer import (make_lr_schedule,
                                              make_optimizer, train_step)
    cfg = tiny_test_config(points_cap=256, voxels_cap=256, gt_cap=4)
    cfg = cfg.replace(head=dataclasses.replace(cfg.head, roi_patch=8,
                                               roi_patch_fallback=2))
    batch = synthetic_batch(cfg, 2, seed=5, with_gt=True)
    gbatch = {k: v.cuda() for k, v in batch.items()}
    cpu = SRFDet(cfg, device="cpu", seed=2)
    gpu = SRFDet(cfg, device="cuda", seed=2)
    opt_c, opt_g = make_optimizer(cpu, cfg, 100), make_optimizer(gpu, cfg,
                                                                 100)
    lr = make_lr_schedule(cfg.optim, 100)
    worst = dict(loss=0.0, grad_rel_leaf=0.0, param_resolved=0.0,
                 param_any=0.0)
    worst_leaf = None
    for i in range(steps):
        gpu.load_state_dict(cpu.state_dict())
        opt_g.mu.copy_(opt_c.mu)
        opt_g.nu.copy_(opt_c.nu)
        opt_g.count = opt_c.count
        step_lr = lr(opt_c.count)
        mc = train_step(cpu, opt_c, batch, torch.Generator().manual_seed(0))
        reset_counts()
        mg = train_step(gpu, opt_g, gbatch,
                        torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        counts = read_counts()
        if not all(counts[k] for k in TRAIN_KERNELS):
            raise AssertionError(f"tiny train step skipped a kernel: "
                                 f"{counts}")
        for k, v in mc.items():
            torch.testing.assert_close(mg[k].cpu(), v, rtol=1e-4, atol=1e-5)
            worst["loss"] = max(worst["loss"],
                                float((mg[k].cpu() - v).abs()))
        pc = dict(cpu.named_parameters())
        pg = dict(gpu.named_parameters())
        tree_max = max(float(p.grad.abs().max()) for p in pc.values())
        for n, p in pc.items():
            ref, got = p.grad, pg[n].grad.cpu()
            scale = max(float(ref.abs().max()), 1e-5 * tree_max)
            err = float((got - ref).abs().max())
            if err > 2e-3 * scale:
                raise AssertionError(f"tiny train step {i}: grad of {n} off "
                                     f"by {err} ({err / scale} of its "
                                     f"largest)")
            if err / scale > worst["grad_rel_leaf"]:
                worst["grad_rel_leaf"] = err / scale
                worst_leaf = f"step {i}: {n}"
            resolved = ((ref.abs() > 2e-3 * scale) &
                        (got.abs() > 2e-3 * scale) &
                        (torch.sign(ref) == torch.sign(got)))
            diff = (pg[n].detach().cpu() - p.detach()).abs()
            near = float(diff[resolved].max()) if bool(resolved.any()) \
                else 0.0
            far = float(diff.max())
            if near > 1e-6 or far > 2 * step_lr + 1e-6:
                raise AssertionError(f"tiny train step {i}: {n} off by "
                                     f"{near} (resolved) / {far}")
            worst["param_resolved"] = max(worst["param_resolved"], near)
            worst["param_any"] = max(worst["param_any"], far)
        for (n, bc), bg in zip(cpu.named_buffers(), gpu.buffers()):
            if not n.endswith("num_batches_tracked"):
                torch.testing.assert_close(bg.cpu(), bc, rtol=1e-4,
                                           atol=1e-5)
    emit(dict(phase="tiny_train", steps=steps, launches_last_step=counts,
              lr=lr(0), loss_first=float(mc["loss"]), worst_leaf=worst_leaf,
              **{f"max_{k}_err": v for k, v in worst.items()}))


def tiny_end_to_end(cfg):
    """A tiny config's predict: kernels on the card vs plain versions on
    the CPU, same weights (same seed).  Forward outputs agree within
    rtol = atol = 1e-4 (float32 op order); decoded valid flags exactly and
    scores within 1e-5; labels exactly and boxes within 1e-4 at every valid
    detection whose score is more than 1e-4 from its neighbours' (closer
    scores may swap order).  Points: half of points_cap, x and y uniform
    1 m inside the range, z in its middle half."""
    import dataclasses
    from srfdet3d_torch.models.detector import SRFDet
    from srfdet3d_torch.models.head import decode_boxes
    cfg = cfg.replace(head=dataclasses.replace(cfg.head, roi_patch=8,
                                               roi_patch_fallback=2))
    rng = np.random.default_rng(0)
    p, dim = cfg.points_cap, cfg.points_dim
    lo, hi = np.array(cfg.pc_range[:3]), np.array(cfg.pc_range[3:])
    zq = (hi[2] - lo[2]) / 4
    pts = np.zeros((2, p, dim), np.float32)
    pts[:, :p // 2, :2] = rng.uniform(lo[:2] + 1, hi[:2] - 1, (2, p // 2, 2))
    pts[:, :p // 2, 2] = rng.uniform(lo[2] + zq, hi[2] - zq, (2, p // 2))
    pts[:, :p // 2, 3:] = rng.uniform(0, 1, (2, p // 2, dim - 3))
    mask = np.zeros((2, p), bool)
    mask[:, :p // 2] = True
    batch = {"points": torch.from_numpy(pts),
             "points_mask": torch.from_numpy(mask)}
    cpu = SRFDet(cfg, device="cpu", seed=3)
    # zero class biases: scores spread over (0, 1) instead of bunching at
    # the 0.01 prior, so decoding and NMS have real work to compare
    for head in cpu.bbox_head.heads:
        head.class_logits.bias.data.zero_()
    gpu = SRFDet(cfg, device="cuda", seed=3)
    gpu.load_state_dict(cpu.state_dict())
    reset_counts()
    with torch.no_grad():
        lg, bg = gpu(batch)
        torch.cuda.synchronize()
        counts = read_counts()
        lc, bc = cpu(batch)
    want = predict_launches(gpu)
    if counts != want:
        raise AssertionError(f"tiny predict {cfg.name} on the card launched "
                             f"{counts}, its structure gives {want}")
    ferr = max(float((lg.cpu() - lc).abs().max()),
               float((bg.cpu() - bc).abs().max()))
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(bg.cpu(), bc, rtol=1e-4, atol=1e-4)
    worst = {}
    for thr in (cfg.test.score_thr, 0.0):
        dg = decode_boxes(lg[-1], bg[-1], score_thr=thr,
                          max_per_img=cfg.test.max_per_img,
                          post_center_range=cfg.test.post_center_range)
        dc = decode_boxes(lc[-1], bc[-1], score_thr=thr,
                          max_per_img=cfg.test.max_per_img,
                          post_center_range=cfg.test.post_center_range)
        for k in ("valid", "scores"):
            torch.testing.assert_close(dg[k].cpu(), dc[k], rtol=1e-5,
                                       atol=1e-5)
        s, both = dc["scores"], dc["valid"]
        gap = torch.full_like(s, math.inf)
        d = (s[:, 1:] - s[:, :-1]).abs()
        gap[:, 1:] = torch.minimum(gap[:, 1:], d)
        gap[:, :-1] = torch.minimum(gap[:, :-1], d)
        stable = both & (gap > 1e-4)
        if int(both.sum()) and float(stable.sum()) < 0.9 * int(both.sum()):
            raise AssertionError("tiny decode: too many near-tied scores")
        if not torch.equal(dg["labels"].cpu()[stable], dc["labels"][stable]):
            raise AssertionError("tiny decode: labels differ")
        torch.testing.assert_close(dg["boxes"].cpu()[stable],
                                   dc["boxes"][stable], rtol=1e-4, atol=1e-4)
        worst[f"valid_at_thr_{thr}"] = int(dc["valid"].sum())
    emit(dict(phase="tiny_end_to_end", config=cfg.name,
              rulebook=cfg.middle.rulebook, launches=counts,
              forward_max_abs_err=ferr, **worst))


def table_backend(cfg):
    """The config with middle.rulebook="table"."""
    import dataclasses
    return cfg.replace(middle=dataclasses.replace(cfg.middle,
                                                  rulebook="table"))


def gather_gemm_device_times(cfg, kcfg, batch, kbatch, roi_args, dev, gen):
    """Kernel-only device ms (kernel_device_ms) of every K1 conv (flagship
    and KITTI, batch 1) and every K3 / K4 conv (flagship, batch 2), one
    line per conv beside the gather_conv and conv_bwd lines, after every
    end-to-end timing, so that no profiler session runs before them.
    Then K5's at roi_bwd's inputs (roi_args).  Returns the sums per
    flagship predict (K1) and train step (K3, K4) as {device_ms}, None
    where a conv's is missing, and K5's a launch."""
    from srfdet3d_torch.ops import gather_conv_bwd as gcb
    from srfdet3d_torch.ops.gather_conv import gather_conv
    from srfdet3d_torch.ops.roi_scatter import roi_scatter
    sums = {key: dict(device_ms=0.0)
            for key in ("gather_conv", "subm", "strided")}

    def add(key, own, times):
        t = sums[key]
        t["device_ms"] = None if own is None or t["device_ms"] is None \
            else t["device_ms"] + times * own
    with torch.no_grad():
        for c, b in ((cfg, batch), (kcfg, kbatch)):
            cases, _ = encoder_rulebooks(c, b, dev)
            for name, n, idx, cin, cout, per_predict in cases:
                k = idx.shape[1]
                feats = torch.randn(n, cin, generator=gen).to(dev)
                w = torch.randn(k, cin, cout, generator=gen).to(dev)
                own = kernel_device_ms(lambda: gather_conv(feats, idx, w), 1)
                emit(dict(phase="gather_conv_device", config=c.name,
                          conv=name, device_ms=own,
                          launches_per_predict=per_predict))
                if c is cfg:
                    add("gather_conv", own, per_predict)
        cases, _ = encoder_rulebooks(cfg, synthetic_batch(cfg, 2, seed=0),
                                     dev)
        for name, n, idx, cin, cout, per_step in cases:
            m, k = idx.shape
            subm = name == "conv_input" or name.endswith("_subm")
            need = name != "conv_input"
            feats = torch.randn(n, cin, generator=gen).to(dev)
            w = torch.randn(k, cin, cout, generator=gen).to(dev)
            g = torch.randn(m, cout, generator=gen).to(dev)
            bwd = gcb.subm_conv_bwd if subm else gcb.strided_conv_bwd
            # the dfeats gather-GEMM where asked, the dW pass, its
            # reduction; K4 first prepares its rulebooks (dfeats: grouped)
            line = {}
            launches = 2 + need
            names = GATHER_GEMM_KERNELS
            if not subm:
                # fill + reverse, and the grouping's 3 where dfeats runs
                prep = STRIDED_PREP_LAUNCHES if need else 2
                launches += prep
                names += STRIDED_PREP_KERNELS
                line["prep_device_ms"] = kernel_device_ms(
                    lambda: gcb.strided_prep(idx, n, need), prep,
                    names=STRIDED_PREP_KERNELS)
                # its dfeats gather-GEMM and its dW passes apart
                for what, part, count in (
                        ("dfeats", GATHER_GEMM_KERNELS[:1], int(need)),
                        ("dw", GATHER_GEMM_KERNELS[1:], 2)):
                    if count:
                        line[f"{what}_device_ms"] = kernel_device_ms(
                            lambda: bwd(feats, idx, w, g, need), count,
                            names=part)
            own = kernel_device_ms(lambda: bwd(feats, idx, w, g, need),
                                   launches, names=names)
            emit(dict(phase="conv_bwd_device", kernel="K3" if subm else "K4",
                      conv=name, device_ms=own, launches_per_step=per_step,
                      **line))
            add("subm" if subm else "strided", own, per_step)
        # K5 at roi_bwd's inputs: its kernel alone (not the table's zeros)
        own = kernel_device_ms(lambda: roi_scatter(*roi_args), 1,
                               names=ROI_SCATTER_KERNELS)
        emit(dict(phase="roi_bwd_device", device_ms=own))
        sums["roi_scatter"] = dict(device_ms=own)
    return sums


def kernel_entry(name, source, replaces, launches, t, max_err):
    bound_by = t.get("bound_by") or (
        "operations" if t["ops_bound_ms"] >= t["bytes_bound_ms"]
        else "bytes")
    entry = dict(name=name, route="cuda", source=source, replaces=replaces,
                 launches=launches, max_abs_err=max_err, ms=t["ms"],
                 plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                 bound_by=bound_by, library_ms=t.get("library_ms"))
    # the gather-GEMM kernels also carry their 3xTF32 bound (their
    # bound_ms), the bound of the earlier SIMT kernels and their kernel-only
    # device time
    for key in ("tc_bound_ms", "simt_bound_ms", "device_ms"):
        if key in t:
            entry[key] = t[key]
    return entry


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from srfdet3d_torch import set_backend_flags
    from srfdet3d_torch.configs import (srfdet_voxel_kitti_L,
                                        srfdet_voxel_nusc_L,
                                        tiny_kitti_test_config,
                                        tiny_test_config)
    from srfdet3d_torch.ops import cuda_build
    set_backend_flags()
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit(dict(phase="device", nvidia_smi=smi, kind=kind,
              count=torch.cuda.device_count(), torch=torch.__version__,
              cuda=torch.version.cuda))
    secs = cuda_build.build_kernels(["gather_conv", "eqmatch",
                                     "gather_conv_bwd", "roi_scatter",
                                     "rulebook_lookup"])
    emit(dict(phase="build", seconds=secs))

    cfg = srfdet_voxel_nusc_L()
    batch = synthetic_batch(cfg, 1, seed=0)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    kcfg = srfdet_voxel_kitti_L()
    kbatch = synthetic_batch(kcfg, 1, seed=0)
    with torch.no_grad():
        conv_cases, subm_cases = encoder_rulebooks(cfg, batch, dev)
        k1_err, k1 = check_gather_conv(cfg.name, conv_cases, dev, gen)
        k2 = check_eqmatch(subm_cases)
        del conv_cases, subm_cases
        # KITTI's widths (conv_input Cin 4, 16/32/64, conv_out 64 -> 128)
        kitti_cases, _ = encoder_rulebooks(kcfg, kbatch, dev)
        kitti_err, _ = check_gather_conv(kcfg.name, kitti_cases, dev, gen)
        k1_err = max(k1_err, kitti_err)
        del kitti_cases
        train_cases, _ = encoder_rulebooks(
            cfg, synthetic_batch(cfg, 2, seed=0), dev)
        bwd = check_conv_bwd(train_cases, dev, gen)
        k5, roi_case = check_roi_bwd(cfg, dev, gen)
        sync_free(next(c for c in train_cases if c[0] == "down2"), roi_case,
                  dev, gen)
        roi_args = roi_case[0]
        del train_cases, roi_case
        k6 = check_rulebook_lookup(
            kcfg.name, table_lookups(table_backend(kcfg), kbatch, dev))
        check_rulebook_lookup(
            cfg.name, table_lookups(table_backend(cfg), batch, dev))
    torch.cuda.empty_cache()

    none = dict.fromkeys(COUNTED, 0)
    counts = predict_phase("flagship_predict", cfg, batch, smi,
                           dict(none, gather_conv=21, eqmatch=4))
    k1_launches, k2_launches = counts["gather_conv"], counts["eqmatch"]
    torch.cuda.empty_cache()
    predict_phase("kitti_predict", kcfg, kbatch, smi,
                  dict(none, gather_conv=12, eqmatch=4))
    torch.cuda.empty_cache()
    counts = predict_phase("kitti_predict", table_backend(kcfg), kbatch, smi,
                           dict(none, gather_conv=12, rulebook_lookup=8))
    k6_launches = counts["rulebook_lookup"]
    torch.cuda.empty_cache()
    per_step = flagship_train(cfg, smi)
    torch.cuda.empty_cache()
    tiny_end_to_end(tiny_test_config())
    tiny_end_to_end(table_backend(tiny_kitti_test_config()))
    tiny_end_to_end(table_backend(tiny_test_config()))
    tiny_train()
    device = gather_gemm_device_times(cfg, kcfg, batch, kbatch, roi_args,
                                      dev, gen)
    k1.update(device["gather_conv"])
    bwd["subm"].update(device["subm"])
    bwd["strided"].update(device["strided"])

    k5_steps = per_step["roi_scatter"]
    k5_step = {key: k5_steps * k5[key]
               for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
    k5_step["bound_by"] = "bytes"
    k5_dev = device["roi_scatter"]["device_ms"]
    k5_step["device_ms"] = None if k5_dev is None else k5_steps * k5_dev
    emit({"kernels": [
        kernel_entry("gather_conv", "srfdet3d_torch/csrc/gather_conv.cu",
                     "srfdet3d_tpu/ops/pallas_onehot.py:67", k1_launches,
                     k1, k1_err),
        kernel_entry("eqmatch", "srfdet3d_torch/csrc/eqmatch.cu",
                     "srfdet3d_tpu/ops/pallas_eqmatch.py:53", k2_launches,
                     dict(k2, bound_by="bytes", library_ms=None), 0.0),
        kernel_entry("conv_bwd_subm", "srfdet3d_torch/csrc/gather_conv_bwd.cu",
                     "srfdet3d_tpu/ops/pallas_onehot_bwd.py:320",
                     per_step["subm_bwd"], bwd["subm"],
                     bwd["subm"]["max_abs_err"]),
        kernel_entry("conv_bwd_strided",
                     "srfdet3d_torch/csrc/gather_conv_bwd.cu",
                     "srfdet3d_tpu/ops/pallas_onehot_bwd.py:33",
                     per_step["strided_bwd"], bwd["strided"],
                     bwd["strided"]["max_abs_err"]),
        kernel_entry("roi_scatter", "srfdet3d_torch/csrc/roi_scatter.cu",
                     "srfdet3d_tpu/ops/pallas_patch_scatter.py:69", k5_steps,
                     k5_step, k5["max_abs_err"]),
        kernel_entry("rulebook_lookup",
                     "srfdet3d_torch/csrc/rulebook_lookup.cu",
                     "srfdet3d_tpu/ops/pallas_rulebook.py:43", k6_launches,
                     dict(k6, bound_by="bytes"), 0.0)]})
    print(smi)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
