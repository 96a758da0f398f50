"""Smoke test of the PyTorch port on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: the five CUDA kernels' sources in srfdet3d_torch/csrc, in
   parallel;
3. gather_conv (K1) against its plain version on real flagship rulebooks,
   at every conv shape of the sparse encoder, on srfdet_voxel_kitti_L's
   bitmap rulebooks at its conv shapes (Cin 4, 16/32/64, conv_out
   64 -> 128) and on srfdet_dvoxel_waymo_L's (Cin 5, 131,072 rows of a
   41 x 1536 x 1536 grid); per conv the time a launch (back-to-back events, which
   include the wrapper's host path) and the bound of the 3xTF32 work the
   kernel does (bound_ms, also printed as tc_bound_ms: flops at 165
   TFLOP/s against HBM's bytes), with simt_bound_ms (flops at the f32
   CUDA-core rate, the bound of the earlier SIMT kernels) beside it; the
   kernel-only device time comes at the end of phase 7;
4. eqmatch (K2) against subm_rulebook_bitmap at the 4 flagship stages
   and (after K1's KITTI and Waymo shapes) the 4 stages of
   srfdet_voxel_kitti_L and of srfdet_dvoxel_waymo_L, exact,
   and its plan map against plan_map_plain; ms a launch with its
   map (events), the map's ms (prep_ms), the host ms of a wrapper call
   (host_ms), the plain version and the byte bound;
5. conv_bwd (K3 subm, K4 strided) against their plain versions on the
   flagship train step's rulebooks (batch 2), at every conv shape, with
   the same times and bounds as K1; K4 also holds its reverse rulebook and
   row grouping (strided_prep, on the card) exactly against the plain
   versions and reports their time (prep_ms), the host time of a wrapper
   call (host_ms: the enqueue, the wrapper never waits on the card) and
   the dfeats tiles' offset steps, grouped and in voxel order, against
   the hits' least;
6. roi_bwd (K5) against index_add_ at the flagship head's geometry (batch
   2 x 900 RoIs, four levels at C 128, patch 32, 64 fallback slots), then
   at the KITTI head's (C 256, patch 0) and the pillar head's (strides
   2-16, a 256 x 256 finest level, patch 0), with
   the global atomics a launch before the window sums (one a live corner
   sample and channel) and after (one a distinct live cell and channel),
   and the max difference of two launches (atomic order);
7. rulebook_lookup (K6) against its plain version, exact, at every lookup
   of the table-backend encoder of srfdet_voxel_kitti_L (65,536 voxel
   slots) and of the flagship (120k voxel slots), walking the rulebooks
   only: the lookup alone (ms, host_ms), and at each stage's first lookup
   its hash table (occupied slots against the distinct keys, prep_ms);
   then sync_free: one K4 and one K5 backward, one K2 call with its plan
   map and one K6 hash build and lookup under
   torch.cuda.set_sync_debug_mode("error") (a host sync raises), their
   results equal to the checked ones; then roi_bwd_img: K5 at the image
   geometry of the LC train steps, one sample's boxes projected through
   camera_rig (off-image and behind-camera RoIs included) onto the four
   image levels of every camera at the pooled table's width, for
   srfdet_voxel_nusc_LC (320 slots a camera: 1,920 RoIs) and
   srfdet_pillar_r50_LC (every pair: 5,400 RoIs), as in phase 6;
   then the kernel device times, before every end-to-end phase (a
   profiler session late in the process records only part of the
   launches; a phase whose sessions all miss one fails): every K1 conv
   (flagship and KITTI) and every K3 / K4 conv, one line each: the
   kernels' own device time from torch.profiler (kernel_device_ms; for K4
   with its preparation kernels, and their share as prep_device_ms), K5's
   (roi_bwd_device), K2's query kernel at each flagship subm stage with
   its plan map apart (eqmatch_device: device_ms, prep_device_ms) and
   K6's lookup kernel at every lookup of both table walks with each
   table's hash build apart (rulebook_lookup_device);
8. flagship srfdet_voxel_nusc_L predict at full width, batch 1, on a
   synthetic scene and seeded random weights: launch counts, finite
   outputs, p50 latency, valid boxes, peak memory; plus decode_boxes with
   score_thr=0 so NMS sees its full 900 x 10 load; then the same predict
   split at its layer boundaries (time and peak memory of each part);
9. srfdet_voxel_kitti_L predict at full width, batch 1, the same way, once
   on its shipped bitmap backend and once with middle.rulebook="table";
   then the flagship with middle.rulebook="table" (flagship_table_predict),
   srfdet_dvoxel_nusc_L and srfdet_dvoxel_waymo_L (dvoxel_*_predict) and
   srfdet_pillar_nusc_L (pillar_predict, no sparse-kernel launch); each
   predict line also counts the preparations beside the launches
   (builds: K2's plan maps, 4 a bitmap predict; K6's hash tables, 4 a
   table predict, as many as its lookup walk in phase 7 built);
   then the six LC configs (nusc_lc_predict, r50_lc_predict,
   kitti_lc_predict, waymo_lc_predict, pillar_r50_lc_predict,
   pillar_v299_lc_predict) at full width, batch 1, on the synthetic scene
   with seeded N(0, 1) images of the config's cameras and size and a
   seeded surround rig of pinholes as lidar2img (camera_rig); Waymo LC
   with seeded non-zero DCNv2 offset convs; their parts add the image
   backbone and the image neck, and the two configs with an image-RoI
   cap print the pairs each camera keeps against it in every head
   iteration (*_visible_pairs);
10. train steps at full width, batch 2 with synthetic GT (7 columns at
   code size 8), dropout as configured: the flagship (flagship_train),
   srfdet_voxel_kitti_L (kitti_train: K1-K5 on the conv_module layout)
   and srfdet_pillar_nusc_L (pillar_train: K5 alone): launch counts of
   the five kernels against the structure, finite losses, a finite grad
   for every parameter and every parameter moved, step p50, peak memory,
   the step split into forward, loss + OTA, backward and optimizer, and
   one step under torch.profiler (device busy time and share, the
   kernels that took most of it); then the six LC train steps
   (nusc_lc_train, r50_lc_train, kitti_lc_train, waymo_lc_train,
   pillar_r50_lc_train, pillar_v299_lc_train) at each config's own batch
   size, with lc_batch's images and rig, GridMask and dropout as
   configured, seeded non-zero DCNv2 offsets on Waymo LC, the LiDAR branch
   frozen: K1 and K2 in its forward, K5 once a head iteration for the
   image RoIAlign and none for the BEV table, no K3 or K4; a finite grad
   for every trainable parameter, and the frozen parameters (freeze_mask)
   and the buffers of every module in eval mode unchanged bit for bit
   after every step; then the runtime around the model from files on disk
   (data_phases: seeded data roots in the mmdet3d formats at real sizes
   under a temporary directory, driven through the train and test CLIs'
   main(argv)): nusc_data_train (srfdet_voxel_nusc_L, one epoch at batch
   2 with CBGS and the GT-database paste; launches a step against the
   structure, finite losses, the checkpoint restored bit for bit into a
   fresh model and optimizer, a resume that continues at the saved step,
   and an epoch at batch 4 as two microbatches with its peak beside the
   batch-2 one), nusc_data_test (the test CLI on the val infos:
   launches a frame, the dumped frames equal to model.predict on the same
   collated batches, nuscenes_eval, --eval-from-pkl), nusc_lc_data_train
   and its test (srfdet_voxel_nusc_LC loading the LiDAR checkpoint: every
   LiDAR tensor restored, the image tensors at their seeded init; six
   900 x 1600 .npy frames a keyframe padded to 928 x 1600; the frozen
   LiDAR branch bit for bit the checkpoint's after the steps) and
   kitti_data (srfdet_voxel_kitti_L, two steps at batch 2, then the test
   CLI with kitti_eval, iou_3d on the card); each line carries the
   loader's ms a batch measured alone on the same root, step p50, the
   share of the loop spent waiting on the loader, peak GB, the
   checkpoint's save and load ms and size, or the eval's ms;
11. tiny predicts (tiny_test_config; tiny_kitti_test_config and
   tiny_test_config with middle.rulebook="table"; tiny_pillar_test_config
   with its own corner RoIAlign; two tiny LC configs: VoVNet-19-slim on
   2 cameras, and a caffe ResNet-50 with DCNv2 in stages 3-4 and a BN
   neck), and 12. two tiny train steps each of tiny_test_config, of
   tiny_kitti_test_config (code size 8) and of the tiny VoVNet LC config,
   and one of the tiny ResNet-50 LC config (TINY_LC_TRAIN: the LiDAR
   branch and the backbone's stem and stage 1 frozen, GridMask off), with
   the kernels on the card against the same
   weights on the CPU with the plain versions; then one profiled predict
   of each full-width predict config, the LC ones included
   (*_predict_busy: device busy time and share);
13. the `kernels` line: per kernel, launches (per flagship predict for K1
   and K2, per flagship train step for K3-K5, per KITTI table predict for
   K6), max error against the plain version, and times per predict or per
   train step (kernel, plain version, bound, one PyTorch library call);
   the gather-GEMM kernels K1, K3 and K4 also carry tc_bound_ms (equal
   to their bound_ms), simt_bound_ms and device_ms (profiler), K5
   device_ms and img_geometry (roi_bwd_img's numbers), K2 and K6
   device_ms, host_ms (a wrapper call's, summed), prep_ms and
   prep_device_ms (plan maps, hash builds) and builds; every kernel also
   carries lc_launches, its launches in each LC predict,
   lc_train_launches, its launches in each LC train step, and
   data_launches, its launches a step in each data phase's train run.

The second-to-last line is nvidia-smi's name and power limit; the last line
is {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import math
import os
import pickle
import statistics
import subprocess
import sys
import tempfile
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
# K2's query kernel and its plan map's fill and scatter; K6's lookup kernel
# and its hash table's fill and insert
EQMATCH_KERNELS = ("eqmatch_query_kernel",)
PLAN_MAP_KERNELS = ("plan_map_fill_kernel", "plan_map_scatter_kernel")
LOOKUP_KERNELS = ("rulebook_lookup_kernel",)
KEY_HASH_KERNELS = ("key_hash_fill_kernel", "key_hash_insert_kernel")
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


def camera_rig(cfg, b: int = 1, seed: int = 0) -> np.ndarray:
    """(b, n_cam, 4, 4) float32 lidar2img of a seeded surround rig: n_cam
    pinholes evenly spaced in yaw (camera k looks along 2 pi k / n_cam, +-2
    degrees), nuScenes' field of view (f = 1266 px at 1600 px wide, scaled
    with the config's image width; the principal point at the image
    centre), mounted 1.5 m above the ground with the LiDAR at 1.84 m (z =
    -0.34 in the LiDAR frame), +-5 cm."""
    rng = np.random.default_rng(seed)
    h, w = cfg.img.img_shape
    n = cfg.img.num_cams
    f = 1266.0 * w / 1600.0
    k = np.array([[f, 0, w / 2, 0], [0, f, h / 2, 0], [0, 0, 1, 0],
                  [0, 0, 0, 1]])
    out = np.zeros((b, n, 4, 4), np.float32)
    for i in range(b):
        for cam in range(n):
            yaw = 2 * np.pi * cam / n + np.deg2rad(rng.uniform(-2, 2))
            pos = np.array([0.0, 0.0, -0.34]) + rng.uniform(-0.05, 0.05, 3)
            # camera axes in the LiDAR frame: x right, y down, z forward
            rot = np.array([[np.sin(yaw), -np.cos(yaw), 0.0],
                            [0.0, 0.0, -1.0],
                            [np.cos(yaw), np.sin(yaw), 0.0]])
            ext = np.eye(4)
            ext[:3, :3], ext[:3, 3] = rot, -rot @ pos
            out[i, cam] = k @ ext
    return out


def lc_batch(cfg, b: int = 1, seed: int = 0):
    """synthetic_batch with the cameras of an LC config: seeded N(0, 1)
    images (b, n_cam, H, W, 3), as the normalized images of a batch, and
    camera_rig's lidar2img."""
    batch = synthetic_batch(cfg, b, seed)
    rng = np.random.default_rng(seed + 1)
    h, w = cfg.img.img_shape
    images = rng.standard_normal((b, cfg.img.num_cams, h, w, 3),
                                 dtype=np.float32)
    batch["images"] = torch.from_numpy(images)
    batch["lidar2img"] = torch.from_numpy(camera_rig(cfg, b, seed))
    return batch


def seed_dcn_offsets(model, seed: int = 0) -> int:
    """Seeded non-zero weights in every DCNv2 offset conv (the port starts
    them at zero, a plain conv): offsets of about a pixel, so the taps are
    fractional and some fall outside the image.  Returns the count."""
    from srfdet3d_torch.models.deform_conv import ModulatedDeformConv
    g = torch.Generator().manual_seed(seed)
    n = 0
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, ModulatedDeformConv):
                conv = mod.conv_offset
                fan_in = conv.weight[0].numel()
                conv.weight.copy_(torch.randn(conv.weight.shape, generator=g)
                                  / math.sqrt(fan_in))
                conv.bias.copy_(0.1 * torch.randn(conv.bias.shape,
                                                  generator=g))
                n += 1
    return n


def encoder_rulebooks(cfg, batch, dev):
    """Walk the encoder's bitmap rulebooks on the card for the batch's B
    samples, in the encoder's run order (either layout: basicblock or
    conv_module).  Returns the gather_conv cases [(name, rows N, rulebook
    (M, K), Cin, Cout, launches per forward)], the subm convs of one level
    of the same widths merged into one case, and the eq-match cases
    [(level, ColumnSet, vcol, vz, coords, mask)], one per subm level.  Names
    count levels: down{i} leaves level i, stage{i}_subm runs on it.  An
    eq-match case is (level, ColumnSet, vcol, vz, coords (B, V, 3) zyx,
    mask)."""
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
        subm.append((i, rb.cs, rb.vcol, rb.vz, rb.coords, rb.mask))
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
    raise AssertionError(f"kernel_device_ms: no profiler session of {tries} "
                         f"saw {per_call * iters} launches of {names} "
                         f"(last: {seen})")


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


def eqmatch_calls(case):
    """(kernel, plain, prep) closures of one eq-match case: K2's wrapper on
    the ColumnSet and the voxels the encoder gives it (the plan map and the
    query kernel), subm_rulebook_bitmap (the sorted-key route), and the
    plan map alone."""
    from srfdet3d_torch.ops.bitmap_rulebook import subm_rulebook_bitmap
    from srfdet3d_torch.ops.eqmatch import eqmatch_rulebook, plan_map
    stage, cs, vcol, vz, coords, mask = case

    def kernel():
        return eqmatch_rulebook(cs, coords, mask)

    def plain():
        return subm_rulebook_bitmap(cs, vcol, vz, mask)

    def prep():
        return plan_map(cs)
    return kernel, plain, prep


def eqmatch_bound(case):
    """K2's byte bound (ms): the column arrays once (ccoords 16 B, cmask
    1, bits 8, cstart 8 a column slot), the queries once (coords 24 B,
    mask 1) and the rulebook written once (108 B a query)."""
    _, cs, _, _, _, mask = case
    return (cs.cmask.numel() * 33 + mask.numel() * 133) / PEAK_BYTES * 1e3


def check_eqmatch(config, cases):
    """K2 at every subm stage of one config's bitmap encoder: the rulebook
    exact against subm_rulebook_bitmap and the plan map against
    plan_map_plain; ms a launch (events, with its plan map), the host ms
    of a wrapper call, the plan map's ms (prep_ms), the plain version and
    the byte bound.  Returns the sums over the stages (one predict's)."""
    from srfdet3d_torch.ops.eqmatch import plan_map_plain
    totals = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, host_ms=0.0,
                  prep_ms=0.0)
    for case in cases:
        stage, cs, vcol, vz, coords, mask = case
        kernel, plain, prep = eqmatch_calls(case)
        got, ref, pmap = kernel(), plain(), prep()
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            bad = int((got != ref).sum())
            raise AssertionError(f"eqmatch {config} stage {stage}: {bad} "
                                 f"entries differ from "
                                 f"subm_rulebook_bitmap")
        if not torch.equal(pmap, plan_map_plain(cs)):
            raise AssertionError(f"eqmatch {config} stage {stage}: the plan "
                                 f"map differs from plan_map_plain")
        ms, plain_ms = time_ms(kernel), time_ms(plain)
        prep_ms, host = time_ms(prep), host_ms(kernel)
        bound = eqmatch_bound(case)
        emit(dict(phase="eqmatch", config=config, stage=stage,
                  voxels=mask.numel(),
                  valid=int(mask.sum()), columns=int(cs.cmask.sum()),
                  grid=list(cs.shape), map_cells=pmap.numel(), exact=True,
                  ms=ms, host_ms=host, prep_ms=prep_ms, plain_ms=plain_ms,
                  bound_ms=bound, bound_by="bytes"))
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("bound_ms", bound), ("host_ms", host),
                         ("prep_ms", prep_ms)):
            totals[key] += val
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


def roi_bwd_case(phase, sizes, rois, strides, c, dev, gen, patch=0,
                 fallback=-1, **extra):
    """K5 on the corners of `rois` (B', R, 4) over the levels `sizes`
    (each (H, W), B' tables of them), C channels: against index_add_ (the
    plain version) within RTOL + ATOL * sqrt(adds to the busiest row); the
    global atomics a launch, counted from the corners on the card (before
    the window sums one a live corner sample and channel, after one a
    distinct live table row of a RoI and channel); the max difference of
    two launches; ms, the plain version's, index_add_'s and the byte
    bound.  Emits one line (with `extra`) and returns (it, the launch's
    inputs)."""
    from srfdet3d_torch.ops.roi_align import corner_samples
    from srfdet3d_torch.ops.roi_scatter import (roi_scatter,
                                                roi_scatter_plain,
                                                sample_grads)
    b, r = rois.shape[:2]
    out, sr = 7, 2
    cs = corner_samples(sizes, rois, strides, out, sr, patch=patch,
                        patch_fallback=fallback)
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
                                 minlength=rows).max()) if live.any() else 0
    err = (got - ref).abs()
    tol = RTOL * ref.abs() + ATOL * math.sqrt(max(per_row, 1))
    if not bool((err <= tol).all()):
        raise AssertionError(f"{phase}: max err {float(err.max())} over "
                             f"tolerance")
    if not (bool(torch.isfinite(got).all()) and bool(ref.abs().max() > 0)):
        raise AssertionError(f"{phase}: non-finite or all-zero cotangent")
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
    row = dict(phase=phase, rois=b * r, levels=sizes, strides=list(strides),
               c=c, table_rows=rows, **extra, patch=patch,
               fallback=fallback, dropped=int(drop.sum()),
               live_rois=int(live.flatten(1).any(1).sum()),
               max_adds_per_row=per_row, max_abs_err=float(err.max()),
               run_to_run_max_diff=float((got - again).abs().max()),
               atomics_before=atomics_before, atomics_after=atomics_after,
               ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
               bound_by="bytes")
    emit(row)
    return row, (args, got, per_row)


def check_roi_bwd(cfg, dev, gen):
    """K5 at one config's BEV head geometry (the flagship's: batch 2 x 900
    RoIs, the four FPN levels at C 128, strides 8-64, patch 32 with 64
    fallback slots; KITTI's at C 256, patch 0; the pillar head's at
    strides 2-16, a 256 x 256 finest level, patch 0), RoIs from boxes of
    0.5-12 m anywhere in range: roi_bwd_case."""
    from srfdet3d_torch.models.detector import bev_geometry
    from srfdet3d_torch.models.head import lidar_rois_from_boxes
    hc = cfg.head
    b, r = 2, hc.num_proposals
    _, sizes = bev_geometry(cfg)
    boxes = random_boxes(cfg, b, r, seed=1)
    rois = lidar_rois_from_boxes(boxes.to(dev), cfg.pc_range,
                                 cfg.voxel_size)
    return roi_bwd_case("roi_bwd", sizes, rois, hc.lidar_strides,
                        hc.feat_channels_lidar, dev, gen, hc.roi_patch,
                        hc.roi_patch_fallback, config=cfg.name)


def random_boxes(cfg, b, r, seed):
    """(b, r, code) boxes with absolute centers anywhere in pc_range,
    sizes 0.5-12 m, any yaw."""
    hc = cfg.head
    rng = np.random.default_rng(seed)
    lo, hi = np.array(cfg.pc_range[:3]), np.array(cfg.pc_range[3:6])
    boxes = np.zeros((b, r, hc.code_size), np.float32)
    boxes[..., :3] = rng.uniform(lo, hi, (b, r, 3))
    boxes[..., 3:6] = np.log(rng.uniform(0.5, 12.0, (b, r, 3)))
    yaw = rng.uniform(-np.pi, np.pi, (b, r))
    boxes[..., 6], boxes[..., 7] = np.sin(yaw), np.cos(yaw)
    return torch.from_numpy(boxes)


def check_img_roi_bwd(cfg, dev, gen):
    """K5 at an LC config's image geometry, as its train step runs it: one
    sample's boxes (0.5-12 m anywhere in range, as many as proposals)
    projected through camera_rig's cameras (img_rois_from_boxes: RoIs off
    the image and ~1e6 px RoIs of boxes behind a camera included), every
    camera-proposal pair (img_roi_cap 0) or each camera's first cap
    visible pairs (compact_pairs); the image levels at strides 4-32 of
    every camera, at the pooled table's width (hidden_dim).
    roi_bwd_case."""
    from srfdet3d_torch.geometry.boxes import boxes3d_to_corners3d
    from srfdet3d_torch.models.head import compact_pairs, img_rois_from_boxes
    hc, ic = cfg.head, cfg.img
    n_p, cap = hc.num_proposals, hc.img_roi_cap
    h, w = ic.img_shape
    sizes = [(h // s, w // s) for s in hc.img_strides]
    boxes = random_boxes(cfg, 1, n_p, seed=2).to(dev)
    l2i = torch.from_numpy(camera_rig(cfg, 1, seed=0)).to(dev)
    cam_rois = img_rois_from_boxes(boxes, l2i)        # (1, n_cam, n_p, 4)
    corners = boxes3d_to_corners3d(boxes[..., :8], bottom_center=False,
                                   yaw_as_sincos=True, log_size=True)
    hom = torch.cat([corners, torch.ones_like(corners[..., :1])], -1)
    depth = torch.einsum("bkij,bpcj->bkpci", l2i, hom)[..., 2]
    behind = int((depth < 1e-5).any(-1).sum())
    if cap:
        rois, _ = compact_pairs(cam_rois, (h, w), hc.img_strides, cap)
    else:
        rois = cam_rois.reshape(ic.num_cams, n_p, 4)
    width = (rois[..., 2] - rois[..., 0]).abs()
    return roi_bwd_case(
        "roi_bwd_img", sizes, rois, hc.img_strides, hc.hidden_dim, dev, gen,
        config=cfg.name, cameras=ic.num_cams, img_roi_cap=cap,
        pairs_behind_camera=behind,
        widest_roi_px=float(width[width < 1e5].max()) if bool(
            (width < 1e5).any()) else None,
        rois_over_1e5_px=int((width >= 1e5).sum()))


def sync_free(strided_case, roi_case, eq_case, lookup_case, dev, gen):
    """One K4 backward (a strided conv of the train step), one K5
    backward, one K2 call (its plan map and query) and one K6 hash build
    and lookup under torch.cuda.set_sync_debug_mode("error"), which raises
    at any host sync; each result equal to the same call's outside it (K2
    and K6: to their plain versions)."""
    from srfdet3d_torch.ops import gather_conv_bwd as gcb
    from srfdet3d_torch.ops.roi_scatter import roi_scatter
    from srfdet3d_torch.ops.rulebook_lookup import (key_hash,
                                                    rulebook_lookup,
                                                    rulebook_lookup_plain)
    name, n, idx, cin, cout, _ = strided_case
    k = idx.shape[1]
    feats = torch.randn(n, cin, generator=gen).to(dev)
    w = torch.randn(k, cin, cout, generator=gen).to(dev)
    g = torch.randn(idx.shape[0], cout, generator=gen).to(dev)
    roi_args, roi_ref, per_row = roi_case
    eq_kernel, eq_plain, _ = eqmatch_calls(eq_case)
    lname, keys, rows, queries, sentinel = lookup_case[:5]
    ref_f, ref_w = gcb.strided_conv_bwd(feats, idx, w, g)
    eq_ref = eq_plain()
    lookup_ref = rulebook_lookup_plain(keys, rows, queries, sentinel)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got_f, got_w = gcb.strided_conv_bwd(feats, idx, w, g)
        got_t = roi_scatter(*roi_args)
        got_eq = eq_kernel()
        got_lookup = rulebook_lookup(keys, rows, queries, sentinel,
                                     key_hash(keys, rows, sentinel))
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
    if not torch.equal(got_eq, eq_ref):
        raise AssertionError(f"sync_free: K2 at stage {eq_case[0]} differs")
    if not torch.equal(got_lookup, lookup_ref):
        raise AssertionError(f"sync_free: K6 at {lname} differs")
    emit(dict(phase="sync_free", mode="error", k4_conv=name,
              k5_rois=roi_args[0].shape[0], k5_max_diff=diff,
              k2_stage=eq_case[0], k6_lookup=lname, ok=True))


def table_lookups(cfg, batch, dev):
    """Walk the table-backend encoder's rulebooks on the card and keep the
    inputs of every K6 launch: [(lookup name, keys, rows, queries,
    sentinel, hash table, first lookup of its table)], in run order (the
    stage-0 subm, then per downsample its input lookup and the next
    stage's subm, then conv_out)."""
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

    def record(keys, rows, queries, sentinel, hashed):
        first = not any(c[5] is hashed for c in cases)
        cases.append((names.pop(0), keys, rows, queries, sentinel, hashed,
                      first))
        return real(keys, rows, queries, sentinel, hashed)
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
    plain version; ms a launch (the lookup alone, as the encoder probes
    its stage's table), the host ms of a wrapper call, the plain version,
    torch.searchsorted on the same sorted keys with its equality check and
    row gather, and the byte bound (queries, output, keys and rows once).
    At the first lookup of each table, its hash build: the occupied slots
    against the distinct valid keys, its ms (prep_ms, one build a stage).
    Returns the sums over the walk (one predict's lookups and builds)."""
    from srfdet3d_torch.ops.rulebook_lookup import (key_hash,
                                                    rulebook_lookup,
                                                    rulebook_lookup_plain)
    totals = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                  host_ms=0.0, prep_ms=0.0, builds=0)
    for name, keys, rows, queries, sentinel, hashed, first in cases:
        n = keys.numel()

        def kernel():
            return rulebook_lookup(keys, rows, queries, sentinel, hashed)

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
        host = host_ms(kernel)
        extra = {}
        if first:
            occupied = int((hashed.table != -1).sum())
            distinct = int(torch.unique(keys[(keys >= 0) &
                                             (keys < sentinel)]).numel())
            if occupied != distinct:
                raise AssertionError(f"key_hash {config} {name}: {occupied} "
                                     f"slots hold {distinct} keys")
            extra = dict(slots=hashed.table.shape[0], occupied=occupied,
                         prep_ms=time_ms(lambda: key_hash(keys, rows,
                                                          sentinel)))
            totals["prep_ms"] += extra["prep_ms"]
            totals["builds"] += 1
        nbytes = queries.numel() * (8 + 4) + n * (8 + 4)
        bound = nbytes / PEAK_BYTES * 1e3
        emit(dict(phase="rulebook_lookup", config=config, lookup=name,
                  keys=n, queries=list(queries.shape),
                  hits=int((ref < n).sum()), exact=True, ms=ms,
                  host_ms=host, plain_ms=plain_ms, library_ms=lib_ms,
                  bound_ms=bound, bound_by="bytes", **extra))
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("library_ms", lib_ms), ("bound_ms", bound),
                         ("host_ms", host)):
            totals[key] += val
    return totals


COUNTED = ("gather_conv", "eqmatch", "subm_bwd", "strided_bwd",
           "roi_scatter", "rulebook_lookup")


def reset_counts():
    from srfdet3d_torch.ops import (eqmatch, gather_conv, gather_conv_bwd,
                                    roi_scatter, rulebook_lookup)
    gather_conv.launches = 0
    eqmatch.launches = 0
    gather_conv_bwd.subm_launches = 0
    gather_conv_bwd.strided_launches = 0
    roi_scatter.launches = 0
    rulebook_lookup.launches = 0
    eqmatch.map_builds = 0
    rulebook_lookup.builds = 0


def read_builds():
    """Preparations since reset_counts, counted apart from the launches:
    K2's plan maps and K6's hash tables."""
    from srfdet3d_torch.ops import eqmatch, rulebook_lookup
    return dict(plan_map=eqmatch.map_builds, key_hash=rulebook_lookup.builds)


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
    conv_out (K6); none on the pillar path, which has no sparse conv."""
    from srfdet3d_torch.models.sparse_encoder import GatheredConvBN
    want = dict.fromkeys(COUNTED, 0)
    if model.cfg.middle.kind == "pillar_scatter":
        return want                     # no sparse conv: no K1, K2 or K6
    enc = model.pts_middle_encoder
    convs = sum(isinstance(mod, GatheredConvBN) for mod in enc.modules())
    stages = len(model.cfg.middle.encoder_channels)
    want["gather_conv"] = convs
    if enc.use_bitmap:
        want["eqmatch"] = stages
    else:
        want["rulebook_lookup"] = 2 * stages
    return want


def predict_builds(model):
    """Preparations per predict the structure gives: one plan map per
    eq-match (bitmap backend), one hash table per stage's key table (table
    backend)."""
    if model.cfg.middle.kind == "pillar_scatter":
        return dict(plan_map=0, key_hash=0)
    stages = len(model.cfg.middle.encoder_channels)
    bitmap = model.pts_middle_encoder.use_bitmap
    return dict(plan_map=stages if bitmap else 0,
                key_hash=0 if bitmap else stages)


def predict_phase(phase, cfg, batch, smi, expect, prepare=None):
    """One config's predict at full width, batch 1: launch counts against
    `expect` and the model's structure, finite outputs, p50 over 20
    predicts, peak memory, decode with score_thr=0, then the parts (and on
    an LC model with an image-RoI cap, the visible pairs a camera against
    it).  `prepare(model)` edits the seeded model first.  Returns the
    counts and the preparations (read_builds), which must equal
    predict_builds."""
    from srfdet3d_torch.geometry import iou
    from srfdet3d_torch.models.detector import SRFDet
    from srfdet3d_torch.models.head import decode_boxes
    model = SRFDet(cfg, device="cuda", seed=0)
    if prepare is not None:
        prepare(model)
    dev_batch = {k: v.cuda() for k, v in batch.items()}
    torch.cuda.synchronize()
    reset_counts()
    out = model.predict(dev_batch)
    torch.cuda.synchronize()
    counts, builds = read_counts(), read_builds()
    predict_sweeps = iou.last_nms_sweeps
    if counts != expect or counts != predict_launches(model):
        raise AssertionError(f"{phase} launched {counts}, expected "
                             f"{expect}, its structure gives "
                             f"{predict_launches(model)}")
    if builds != predict_builds(model):
        raise AssertionError(f"{phase} built {builds}, its structure gives "
                             f"{predict_builds(model)}")
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
              batch=1, points=cfg.points_cap, launches=counts,
              builds=builds, finite=True,
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
    if cfg.use_img and cfg.head.img_roi_cap:
        visible_pairs(phase.replace("predict", "visible_pairs"), model,
                      dev_batch, smi)
    return counts, builds


@torch.no_grad()
def visible_pairs(phase, model, batch, smi):
    """The image RoIs each camera keeps against img_roi_cap, in every
    head iteration of one predict: visible_pair_counts of the boxes each
    iteration pools (the DPG's proposals, then each iteration's output),
    their largest, and the pairs the cap dropped."""
    from srfdet3d_torch.models.head import (denormalize_centers,
                                            img_rois_from_boxes,
                                            visible_pair_counts)
    cfg, head = model.cfg, model.bbox_head
    points, mask = model._inputs(batch)
    maps = model.extract_point_features(points, mask)
    img_maps = head.image_maps(model.extract_img_features(
        model.image_tensor(batch)))
    boxes0, _ = head.init_proposals(maps, img_maps)
    _, boxes = model(batch)
    l2i = batch["lidar2img"].float()
    strides = cfg.head.img_strides
    cap = cfg.head.img_roi_cap
    counts = []
    for b in [denormalize_centers(boxes0, cfg.pc_range)] + list(boxes[:-1]):
        counts.append(visible_pair_counts(
            img_rois_from_boxes(b, l2i), cfg.img.img_shape,
            strides)[0].tolist())
    dropped = sum(max(c - cap, 0) for it in counts for c in it)
    emit(dict(phase=phase, config=cfg.name, img_roi_cap=cap,
              proposals=cfg.head.num_proposals,
              visible_per_camera=counts,
              max_visible=max(max(it) for it in counts),
              dropped_pairs=dropped, device=smi))


def predict_parts(phase, model, batch, smi, runs: int = 5):
    """Predict split at its layer boundaries, each part ended by a
    synchronize: median host ms and peak device memory of each part."""
    from srfdet3d_torch.models.head import decode_boxes
    t = model.cfg.test
    points, mask = model._inputs(batch)
    use_img = model.cfg.use_img

    def run():
        feats, vox = model.voxel_features(points, mask)
        yield "voxelize_vfe"
        bev = model.middle(feats, vox)
        yield ("pillar_scatter" if model.cfg.middle.kind == "pillar_scatter"
               else "sparse_encoder")
        maps = model.pts_neck(model.pts_backbone(
            bev.permute(0, 3, 1, 2).contiguous()))
        yield "second_fpn"
        img_feats = l2i = None
        if use_img:
            stages = model.img_backbone(model.image_tensor(batch))
            yield "img_backbone"
            img_feats = model.img_neck(stages)
            l2i = batch["lidar2img"].float()
            yield "img_neck"
        logits, boxes = model.bbox_head(maps, None, img_feats, l2i)
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


def predict_busy(phase, cfg, batch, smi, prepare=None):
    """One predict of a fresh model (seed 0, after one warm-up predict)
    under torch.profiler: host ms, device busy ms and share, top kernels.
    Run after every end-to-end timing, so no profiler run precedes a
    p50."""
    from srfdet3d_torch.models.detector import SRFDet
    model = SRFDet(cfg, device="cuda", seed=0)
    if prepare is not None:
        prepare(model)
    dev_batch = {k: v.cuda() for k, v in batch.items()}
    model.predict(dev_batch)
    emit(dict(phase=phase, config=cfg.name, rulebook=cfg.middle.rulebook,
              device=smi,
              profiled_predict=device_busy(lambda: model.predict(dev_batch),
                                           top=5)))


def train_launches(model):
    """Launches per train step the model's structure gives: the forward's
    (predict_launches); unless freeze_lidar cuts the LiDAR branch's
    backward, every subm conv's backward (K3), every strided and conv_out
    backward (K4) and one BEV RoIAlign backward per head iteration (K5);
    with the image branch one image RoIAlign backward per head iteration
    (K5: the pooled image table always needs its grad).  The pillar path
    has no sparse conv: K5's alone."""
    from srfdet3d_torch.models.sparse_encoder import GatheredConvBN
    cfg = model.cfg
    lidar_bwd = not cfg.optim.freeze_lidar
    convs = []
    if cfg.middle.kind != "pillar_scatter" and lidar_bwd:
        convs = [mod for mod in model.pts_middle_encoder.modules()
                 if isinstance(mod, GatheredConvBN)]
    n_subm = sum(c.subm for c in convs)
    iters = len(model.bbox_head.heads)
    want = predict_launches(model)
    want.update(subm_bwd=n_subm, strided_bwd=len(convs) - n_subm,
                roi_scatter=iters * (int(lidar_bwd) + int(cfg.use_img)))
    return want


def train_batch(cfg, b: int, seed: int = 0):
    """synthetic_batch with GT, and an LC config's cameras (lc_batch)."""
    batch = synthetic_batch(cfg, b, seed=seed, with_gt=True)
    if cfg.use_img:
        cams = lc_batch(cfg, b, seed=seed)
        batch.update(images=cams["images"], lidar2img=cams["lidar2img"])
    return batch


def frozen_state(model, opt):
    """What a train step must leave bit for bit, by name: the parameters
    outside the optimizer (freeze_mask), and the buffers of every module
    in eval mode during training (the frozen LiDAR branch, the image
    backbone under norm_eval)."""
    model.train()
    trainable = {id(p) for p in opt.params}
    state = {f"param {n}": p for n, p in model.named_parameters()
             if id(p) not in trainable}
    for name, mod in model.named_modules():
        if not mod.training:
            for b, buf in mod.named_buffers(recurse=False):
                state[f"buffer {name}.{b}"] = buf
    return state


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


def train_phase(phase, cfg, smi, warmup: int = 2, steps: int = 10,
                batch_size: int = 2, prepare=None):
    """One config's train step at full width, `batch_size` samples of the
    synthetic scene and GT (7 columns at code size 8, else 9; an LC
    config's seeded images and camera_rig; GridMask and dropout as
    configured, from one generator on the card), seeded random weights
    (`prepare(model)` edits them first): launch counts against
    train_launches every step, finite losses, a finite grad and a move for
    every trainable parameter, the frozen parameters and the eval-mode
    modules' buffers (frozen_state) unchanged bit for bit after every
    step, step p50 over `steps`, peak memory, the step's parts and one
    profiled step.  Returns the launches a step."""
    from srfdet3d_torch.models.detector import SRFDet
    from srfdet3d_torch.models.losses import srfdet_losses
    from srfdet3d_torch.train.trainer import make_optimizer, train_step
    model = SRFDet(cfg, device="cuda", seed=0)
    if prepare is not None:
        prepare(model)
    batch = {k: v.cuda() for k, v in train_batch(cfg, batch_size).items()}
    opt = make_optimizer(model, cfg, total_steps=1000)
    gen = torch.Generator(device="cuda").manual_seed(0)
    want = train_launches(model)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    frozen = frozen_state(model, opt)
    frozen_before = {k: v.detach().clone() for k, v in frozen.items()}

    def step():
        reset_counts()
        metrics = train_step(model, opt, batch, gen)
        torch.cuda.synchronize()
        counts = read_counts()
        if counts != want:
            raise AssertionError(f"{phase}: train step launched {counts}, "
                                 f"the model's structure gives {want}")
        bad = [k for k, v in metrics.items()
               if not bool(torch.isfinite(v).all())]
        if bad:
            raise AssertionError(f"{phase}: non-finite {bad}")
        moved = [k for k, v in frozen.items()
                 if not torch.equal(v, frozen_before[k])]
        if moved:
            raise AssertionError(f"{phase}: frozen state changed: "
                                 f"{moved[:4]}")
        return metrics

    first = step()
    # every trainable parameter got a finite grad and moved; one can only
    # stay put under AdamW if its grad and its value are exactly zero
    stuck = []
    for name, p in model.named_parameters():
        if f"param {name}" in frozen:
            if p.grad is not None:
                raise AssertionError(f"{phase}: frozen {name} has a grad")
            continue
        if p.grad is None or not bool(torch.isfinite(p.grad).all()):
            raise AssertionError(f"{phase}: {name} has no finite grad")
        if torch.equal(p.detach(), before[name]):
            stuck.append(name)
            if bool(p.grad.any()) or bool(p.detach().any()):
                raise AssertionError(f"{phase}: {name} did not move")
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
    n_frozen = sum(k.startswith("param ") for k in frozen)
    emit(dict(phase=phase, config=cfg.name, batch=batch_size,
              points=cfg.points_cap, gt_valid=8,
              gt_columns=batch["gt_boxes"].shape[-1],
              dropout=cfg.head.dropout,
              grid_mask=bool(cfg.use_img and cfg.img.use_grid_mask),
              launches_per_step=want, finite=True,
              params=sum(p.numel() for p in opt.params),
              leaves=len(opt.params), frozen_leaves=n_frozen,
              frozen_params=sum(p.numel() for k, p in frozen.items()
                                if k.startswith("param ")),
              frozen_buffers=len(frozen) - n_frozen,
              zero_grad_unmoved=stuck,
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


def tiny_train_setup():
    """tiny_train's flagship-family config and (model, batch) seeds:
    `tiny_test_config(points_cap=256, voxels_cap=256, gt_cap=4)` with the
    patch RoIAlign scaled down (8 cells, 2 fallback slots), model seed 2,
    batch seed 5."""
    import dataclasses
    from srfdet3d_torch.configs import tiny_test_config
    cfg = tiny_test_config(points_cap=256, voxels_cap=256, gt_cap=4)
    cfg = cfg.replace(head=dataclasses.replace(cfg.head, roi_patch=8,
                                               roi_patch_fallback=2))
    return cfg, 2, 5


def tiny_kitti_train_setup():
    """The code-size-8 tiny train step's config and seeds:
    `tiny_kitti_test_config(points_cap=256, voxels_cap=256, gt_cap=4)`
    (conv_module encoder, 7-column GT, roi_patch 0), model seed 23, batch
    seed 5."""
    from srfdet3d_torch.configs import tiny_kitti_test_config
    return tiny_kitti_test_config(points_cap=256, voxels_cap=256,
                                  gt_cap=4), 23, 5


def tiny_train(cfg, model_seed: int, batch_seed: int, steps: int = 2,
               prepare=None):
    """Tiny train steps: kernels on the card vs plain versions on the CPU.
    Each step starts both from the same state (the CPU's weights, BN
    statistics and AdamW moments), so each compares one step, not two
    drifting runs.  The card's launches each step equal train_launches.
    Per step: losses and the grad norm within rtol 1e-4 +
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
    grad by percents.  The configs and seeds (tiny_train_setup,
    tiny_kitti_train_setup; dropout 0) are picked where it does not:
    tests/test_torch_port_train.py::test_tiny_train_seeds_are_well_conditioned
    and tests/test_torch_port_dvoxel.py::
    test_tiny_kitti_train_seeds_are_well_conditioned hold every leaf's grad
    within 1e-3 under 1e-6 noise on the weights, for both steps; for the
    tiny LC configs (TINY_LC_TRAIN, GridMask off: the card's generator
    draws other masks than the CPU's)
    tests/test_torch_port_lc_train.py::test_tiny_lc_seeds_are_well_conditioned.
    An LC config also gets train_batch's images and camera rig, and
    `prepare(model)` edits the CPU model's seeded weights; its frozen
    parameters (freeze_mask) get no grad on either side and stay put."""
    from srfdet3d_torch.models.detector import SRFDet
    from srfdet3d_torch.train.trainer import (make_lr_schedule,
                                              make_optimizer, train_step)
    batch = train_batch(cfg, 2, seed=batch_seed)
    gbatch = {k: v.cuda() for k, v in batch.items()}
    cpu = SRFDet(cfg, device="cpu", seed=model_seed)
    if prepare is not None:
        prepare(cpu)
    gpu = SRFDet(cfg, device="cuda", seed=model_seed)
    want = train_launches(gpu)
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
        if counts != want:
            raise AssertionError(f"tiny train step {cfg.name} launched "
                                 f"{counts}, its structure gives {want}")
        for k, v in mc.items():
            torch.testing.assert_close(mg[k].cpu(), v, rtol=1e-4, atol=1e-5)
            worst["loss"] = max(worst["loss"],
                                float((mg[k].cpu() - v).abs()))
        pc = dict(cpu.named_parameters())
        pg = dict(gpu.named_parameters())
        trained = {id(p) for p in opt_c.params}
        tree_max = max(float(p.grad.abs().max()) for p in pc.values()
                       if id(p) in trained)
        for n, p in pc.items():
            if id(p) not in trained:
                if p.grad is not None or pg[n].grad is not None or \
                        not torch.equal(pg[n].detach().cpu(), p.detach()):
                    raise AssertionError(f"tiny train step {i}: frozen {n} "
                                         f"got a grad or moved")
                continue
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
    emit(dict(phase="tiny_train", config=cfg.name,
              code_size=cfg.head.code_size, seeds=[model_seed, batch_seed],
              frozen_leaves=len(pc) - len(opt_c.params),
              steps=steps, launches_last_step=counts,
              lr=lr(0), loss_first=float(mc["loss"]), worst_leaf=worst_leaf,
              **{f"max_{k}_err": v for k, v in worst.items()}))


def tiny_end_to_end(cfg, patch: bool = True, prepare=None,
                    seed: int = 3):
    """A tiny config's predict: kernels on the card vs plain versions on
    the CPU, same weights (same seed).  Forward outputs agree within
    rtol = atol = 1e-4 (float32 op order); decoded valid flags exactly and
    scores within 1e-5; labels exactly and boxes within 1e-4 at every valid
    detection whose score is more than 1e-4 from its neighbours' (closer
    scores may swap order).  Points: half of points_cap, x and y uniform
    1 m inside the range, z in its middle half.  With `patch` the head
    takes the patch RoIAlign scaled down (8 cells, 2 fallback slots),
    else the config's own (roi_patch 0: every RoI by its corners).  An LC
    config also gets lc_batch's images and camera rig (seed 0);
    `prepare(model)` edits the CPU model's seeded weights (model `seed`)
    before the card's model copies them."""
    import dataclasses
    from srfdet3d_torch.models.detector import SRFDet
    from srfdet3d_torch.models.head import decode_boxes
    if patch:
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
    if cfg.use_img:
        cams = lc_batch(cfg, 2, seed=0)
        batch.update(images=cams["images"], lidar2img=cams["lidar2img"])
    cpu = SRFDet(cfg, device="cpu", seed=seed)
    if prepare is not None:
        prepare(cpu)
    # zero class biases: scores spread over (0, 1) instead of bunching at
    # the 0.01 prior, so decoding and NMS have real work to compare
    for head in cpu.bbox_head.heads:
        head.class_logits.bias.data.zero_()
    gpu = SRFDet(cfg, device="cuda", seed=seed)
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
              rulebook=cfg.middle.rulebook,
              image_backbone=cfg.img.backbone if cfg.use_img else None,
              launches=counts, forward_max_abs_err=ferr, **worst))


def table_backend(cfg):
    """The config with middle.rulebook="table"."""
    import dataclasses
    return cfg.replace(middle=dataclasses.replace(cfg.middle,
                                                  rulebook="table"))


def kernel_device_times(cfg, kcfg, batch, kbatch, roi_args, dev, gen):
    """Kernel-only device ms (kernel_device_ms) of every K1 conv (flagship
    and KITTI, batch 1) and every K3 / K4 conv (flagship, batch 2), one
    line per conv beside the gather_conv and conv_bwd lines, before the
    end-to-end phases: a profiler session late in the process misses
    launches.  Then K5's at roi_bwd's inputs (roi_args), K2's at every
    flagship subm stage (eqmatch_device) and K6's at every lookup of the
    KITTI and flagship table walks (rulebook_lookup_device).  Returns the
    sums per flagship predict (K1, K2), train step (K3, K4) and KITTI table
    predict (K6) as {device_ms}, and K5's a launch."""
    from srfdet3d_torch.ops import gather_conv_bwd as gcb
    from srfdet3d_torch.ops.gather_conv import gather_conv
    from srfdet3d_torch.ops.roi_scatter import roi_scatter
    from srfdet3d_torch.ops.rulebook_lookup import key_hash, rulebook_lookup
    sums = {key: dict(device_ms=0.0)
            for key in ("gather_conv", "subm", "strided", "eqmatch",
                        "eqmatch_prep", "rulebook_lookup",
                        "rulebook_lookup_prep")}

    def add(key, own, times):
        sums[key]["device_ms"] += times * own
    with torch.no_grad():
        for c, b in ((cfg, batch), (kcfg, kbatch)):
            cases, subm_cases = encoder_rulebooks(c, b, dev)
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
            if c is cfg:
                # K2's query kernel, and apart its plan map (fill, scatter)
                for case in subm_cases:
                    kernel, _, prep = eqmatch_calls(case)
                    own = kernel_device_ms(kernel, 1,
                                           names=EQMATCH_KERNELS)
                    prep_own = kernel_device_ms(prep, 2,
                                                names=PLAN_MAP_KERNELS)
                    emit(dict(phase="eqmatch_device", stage=case[0],
                              device_ms=own, prep_device_ms=prep_own,
                              bound_ms=eqmatch_bound(case)))
                    add("eqmatch", own, 1)
                    add("eqmatch_prep", prep_own, 1)
            del cases, subm_cases
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
        # K6 at every lookup of both table walks (the lookup kernel), and
        # at each table's first lookup its hash build (fill, insert); the
        # KITTI sums a predict
        for c, b in ((kcfg, kbatch), (cfg, batch)):
            for name, keys, rows, queries, sentinel, hashed, first in \
                    table_lookups(table_backend(c), b, dev):
                own = kernel_device_ms(
                    lambda: rulebook_lookup(keys, rows, queries, sentinel,
                                            hashed),
                    1, names=LOOKUP_KERNELS)
                line = {}
                if first:
                    line["prep_device_ms"] = kernel_device_ms(
                        lambda: key_hash(keys, rows, sentinel), 2,
                        names=KEY_HASH_KERNELS)
                    if c is kcfg:
                        add("rulebook_lookup_prep", line["prep_device_ms"],
                            1)
                emit(dict(phase="rulebook_lookup_device", config=c.name,
                          lookup=name, device_ms=own, **line))
                if c is kcfg:
                    add("rulebook_lookup", own, 1)
    for kind in ("eqmatch", "rulebook_lookup"):
        sums[kind]["prep_device_ms"] = sums.pop(f"{kind}_prep")["device_ms"]
    return sums


# the LC predict phases: (phase, config, the launches its LiDAR branch's
# structure gives; the image branch launches none of the six kernels)
LC_PHASES = (
    ("nusc_lc_predict", "srfdet_voxel_nusc_LC",
     dict(gather_conv=21, eqmatch=4)),
    ("r50_lc_predict", "srfdet_voxel_r50_LC",
     dict(gather_conv=21, eqmatch=4)),
    ("kitti_lc_predict", "srfdet_voxel_kitti_LC",
     dict(gather_conv=12, eqmatch=4)),
    ("waymo_lc_predict", "srfdet_dvoxel_waymo_LC",
     dict(gather_conv=21, eqmatch=4)),
    ("pillar_r50_lc_predict", "srfdet_pillar_r50_LC", {}),
    ("pillar_v299_lc_predict", "srfdet_pillar_v299_LC", {}),
)


# the tiny LC predicts' model seeds: with seed 3 the ResNet model's decode
# has two score pairs within 1e-4 (2 of 16 detections a sample whose order
# may swap, under the 90% the decode check compares by order); seed 4's
# scores are apart
TINY_LC_SEEDS = (3, 4)

# the LC train phases: (phase, config), each at its config's own
# optim.batch_size_per_device (1; KITTI LC 4; Waymo LC 2)
LC_TRAIN_PHASES = (
    ("nusc_lc_train", "srfdet_voxel_nusc_LC"),
    ("r50_lc_train", "srfdet_voxel_r50_LC"),
    ("kitti_lc_train", "srfdet_voxel_kitti_LC"),
    ("waymo_lc_train", "srfdet_dvoxel_waymo_LC"),
    ("pillar_r50_lc_train", "srfdet_pillar_r50_LC"),
    ("pillar_v299_lc_train", "srfdet_pillar_v299_LC"),
)

# the tiny LC train steps held card against CPU: (tiny_lc_test_config's
# backbone, its options, model seed, batch seed, steps).  As the shipped
# LC fine-tunes set them (the LiDAR branch frozen, the stem and stage 1
# frozen; norm_frozen as on Waymo LC), GridMask off (the card's generator
# draws other masks than the CPU's).  The seeds keep every trainable
# leaf's grad within 1e-3 under a 1e-6 change of the weights, each step
# (tests/test_torch_port_lc_seeds.py).  ResNet-50 takes one step: at 64 x
# 128 its deep stages run on 8-32 pixels a channel, where one ReLU input
# crossing zero moves a weight's grad by percents, and of over 70 seeds,
# frozen stages and image sizes tried none kept a second step's grads
# within 1e-3 (the first step's at seeds 2, 0: 5e-4).
TINY_LC_TRAIN = (
    ("vovnet", dict(frozen_stages=1, use_grid_mask=False), 8, 1, 2),
    ("r50_dcn", dict(frozen_stages=1, norm_frozen=True,
                     use_grid_mask=False), 2, 0, 1),
)


def tiny_lc_configs():
    """The tiny LC configs held card against CPU in predict
    (tiny_lc_test_config): VoVNet-19-slim on 2 cameras (a 64-channel plain
    image neck reduced to the head's 32 by img_conv, every camera-proposal
    pair pooled), and a caffe ResNet-50 with DCNv2 in stages 3-4 and a
    32-channel BN + ReLU neck (no img_conv, 8 image-RoI slots a camera);
    64 x 128 images."""
    from srfdet3d_torch.configs import tiny_lc_test_config
    return tuple(tiny_lc_test_config(b) for b in ("vovnet", "r50_dcn"))


# ---------------------------------------------------------------------------
# the runtime around the model: train and test from files on disk

# seeded dataset roots at real sizes (srfdet3d_torch/data/synthetic_root.py):
# a nuScenes keyframe and each of its 10 sweeps of 34,688 points (~380k
# before the range filter, against points_cap 262,144), ~35 GT boxes over
# the ten classes; the LC root adds six 900 x 1600 frames a keyframe; KITTI
# frames of 120,000 points with the front camera's calib and annos
DATA_ROOTS = {
    "nus": dict(n_train=4, n_val=2, points=34688, sweeps=10, boxes=35,
                db_per_class=3),
    "nus_lc": dict(n_train=4, n_val=2, points=34688, sweeps=10, boxes=35,
                   db_per_class=3, cams=True, img_hw=(900, 1600)),
    "kitti": dict(n_train=4, n_val=2, points=120_000, boxes=12,
                  img_hw=(375, 1242), db_per_class=3),
}
# the configs of the four phases (keys of DATA_ROOTS)
DATA_CONFIGS = {"nus": "srfdet_voxel_nusc_L", "nus_lc": "srfdet_voxel_nusc_LC",
                "kitti": "srfdet_voxel_kitti_L"}


def free_cache() -> None:
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def loader_ms(dataset, batch_size: int, batches: int = 6,
              workers: int = 4) -> float:
    """Host ms a batch of data_loader alone (its thread pool of `workers`,
    prefetch 2) over the first `batches` batches of an epoch."""
    from srfdet3d_torch.data import data_loader
    it = data_loader(dataset, batch_size, seed=0, num_workers=workers)
    t0 = time.perf_counter()
    n = 0
    for _ in it:
        n += 1
        if n == batches:
            break
    it.close()
    return (time.perf_counter() - t0) * 1e3 / max(n, 1)


def check_launches(phase, counts, want, times: int) -> None:
    need = {k: want[k] * times for k in COUNTED}
    if counts != need:
        raise AssertionError(f"{phase}: launched {counts} in {times} steps "
                             f"or frames; the model's structure gives {need}")


def run_train_cli(argv):
    """tools.train.main(argv) with the launch counts from 0 and the peak
    memory from its start: (record, launches, peak GB)."""
    from srfdet3d_torch.tools import train as train_cli
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    rec = train_cli.main(argv + ["--device", "cuda"])
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    bad = [k for k, v in rec["metrics"].items() if not math.isfinite(v)]
    if bad or not rec["metrics"]:
        raise AssertionError(f"{argv[0]}: non-finite {bad or 'no'} metrics")
    return rec, counts, peak


def step_stats(rec):
    """The loop's numbers: step p50 (forward to synced update), the host's
    wait for the loader a step, and the wait's share of the loop, with and
    without the first batch (the pool's start and the first samples)."""
    step, wait = rec["step_ms"], rec["wait_ms"]
    later = sum(wait[1:]) + sum(step[1:])
    return dict(steps=len(step), step_p50_ms=statistics.median(step),
                step_ms=step, wait_p50_ms=statistics.median(wait),
                wait_ms=wait,
                wait_share=sum(wait) / (sum(wait) + sum(step)),
                wait_share_after_first=(sum(wait[1:]) / later
                                        if later else None))


def check_restore(phase, rec):
    """The last checkpoint restored into a fresh model and optimizer
    equals the trainer's, bit for bit: every state_dict tensor, mu, nu,
    count and the step.  Returns (load ms, size MB)."""
    from srfdet3d_torch.models.detector import SRFDet
    from srfdet3d_torch.train.trainer import make_optimizer
    from srfdet3d_torch.utils.checkpoint import restore_checkpoint
    model, opt = rec["model"], rec["opt"]
    fresh = SRFDet(model.cfg, device="cuda", seed=123)
    fopt = make_optimizer(fresh, model.cfg, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step = restore_checkpoint(rec["checkpoint"], fresh, fopt)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    want = model.state_dict()
    got = fresh.state_dict()
    bad = [k for k in want if not torch.equal(want[k], got[k])]
    if bad or step != rec["last_step"] or fopt.count != opt.count or \
            not torch.equal(fopt.mu, opt.mu) or \
            not torch.equal(fopt.nu, opt.nu):
        raise AssertionError(f"{phase}: checkpoint restore differs: "
                             f"{bad[:4]} step {step} / {rec['last_step']} "
                             f"count {fopt.count} / {opt.count}")
    return load_ms, os.path.getsize(rec["checkpoint"]) / 1e6


# decode every frame's max_per_img boxes (score_thr 0): with a short run's
# weights the scores sit near the focal prior, under the shipped 0.1
TEST_OPTIONS = ("test.score_thr=0.0",)


def test_cli_phase(phase, name, root, ckpt, work, smi):
    """tools.test.main on the val infos from `ckpt` with TEST_OPTIONS:
    launches a frame
    against the predict structure, the dumped per-frame results equal to
    model.predict on the same collated batches (boxes and scores within
    1e-4: the card's float atomics in the point scatters may reorder
    sums; labels exactly), finite metrics, and --eval-from-pkl on the
    dump giving the same metrics."""
    from srfdet3d_torch.configs import get_config
    from srfdet3d_torch.data import data_loader
    from srfdet3d_torch.models.detector import SRFDet
    from srfdet3d_torch.tools import test as test_cli
    from srfdet3d_torch.tools.train import apply_cfg_options, dataset_class
    from srfdet3d_torch.utils.checkpoint import load_for_eval
    cfg = apply_cfg_options(get_config(name), TEST_OPTIONS)
    out = os.path.join(work, f"{phase}.pkl")
    options = ["--cfg-options", *TEST_OPTIONS]
    argv = [name, ckpt, "--data-root", root, "--batch-size", "1", "--out",
            out, "--device", "cuda", *options]
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = test_cli.main(argv)
    eval_ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    with open(out, "rb") as f:
        dump = pickle.load(f)
    frames = len(dump["preds"])
    model = SRFDet(cfg, device="cuda")
    load_for_eval(ckpt, model)
    check_launches(phase, counts, predict_launches(model), frames)
    val = dataset_class(cfg)(
        cfg, info_path=os.path.join(root, f"{cfg.dataset}_infos_val.pkl"),
        data_root=root, test_mode=False, augment=False)
    worst = 0.0
    for i, batch in enumerate(data_loader(val, 1, shuffle=False,
                                          num_workers=0, drop_last=False)):
        pred = model.predict({k: torch.from_numpy(v)
                              for k, v in batch.items()
                              if k not in test_cli.GT_KEYS})
        gts, preds = test_cli.frames_from_outputs(
            cfg, {k: v.cpu().numpy() for k, v in pred.items()}, batch, 1)
        p, d = preds[0], dump["preds"][i]
        if list(p["labels_name"]) != list(d["labels_name"]) or \
                not np.array_equal(gts[0]["boxes"], dump["gts"][i]["boxes"]):
            raise AssertionError(f"{phase}: frame {i} differs from "
                                 f"model.predict")
        if len(p["boxes"]):
            worst = max(worst, float(np.abs(p["boxes"] - d["boxes"]).max()),
                        float(np.abs(p["scores"] - d["scores"]).max()))
    if worst > 1e-4:
        raise AssertionError(f"{phase}: dump off model.predict by {worst}")
    scalars = {k: v for k, v in res.items() if isinstance(v, float)}
    if not scalars or not all(math.isfinite(v) for v in scalars.values()):
        raise AssertionError(f"{phase}: metrics {scalars}")
    again = test_cli.main([name, "--eval-from-pkl", out, "--device", "cuda",
                           *options])
    if {k: again[k] for k in scalars} != scalars:
        raise AssertionError(f"{phase}: --eval-from-pkl gives other metrics")
    emit(dict(phase=phase, config=name, options=TEST_OPTIONS,
              frames=frames, eval_ms=eval_ms,
              launches_per_frame={k: v // max(frames, 1)
                                  for k, v in counts.items()},
              dump_vs_predict_max_abs=worst,
              detections=sum(len(p["boxes"]) for p in dump["preds"]),
              metrics=scalars, device=smi))
    return scalars


def data_phases(smi, tmp: str):
    """The four phases from files on disk (DATA_ROOTS under `tmp`):
    nusc_data_train, nusc_data_test, nusc_lc_data_train (with its test
    CLI) and kitti_data (train, then the test CLI with kitti_eval).
    Returns the launches a step of each train run."""
    from srfdet3d_torch.configs import get_config
    from srfdet3d_torch.data import synthetic_root
    from srfdet3d_torch.models.detector import LIDAR_MODULES, SRFDet
    from srfdet3d_torch.tools.train import train_dataset
    from srfdet3d_torch.utils.checkpoint import load_pretrained
    launches = {}

    # 1. srfdet_voxel_nusc_L from a nuScenes root: one epoch at batch 2
    # with CBGS and the GT-database paste, its checkpoint restored, a
    # resume, and one epoch with two microbatches a step at batch 4
    name = DATA_CONFIGS["nus"]
    cfg = get_config(name)
    t0 = time.perf_counter()
    nus = synthetic_root.write_nuscenes_root(os.path.join(tmp, "nus"),
                                             **DATA_ROOTS["nus"])
    write_s = time.perf_counter() - t0
    ds = train_dataset(cfg, nus["root"], db_info=nus["db"])
    load_batch = loader_ms(ds, 2)
    sample = ds[0]
    base = [name, "--data-root", nus["root"], "--db-info", nus["db"],
            "--epochs", "1", "--log-interval", "5"]
    rec, counts, peak = run_train_cli(
        base + ["--batch-size", "2", "--work-dir",
                os.path.join(tmp, "wd_nus")])
    want = train_launches(rec["model"])
    check_launches("nusc_data_train", counts, want, len(rec["step_ms"]))
    launches["nusc_data_train"] = want
    load_ms, size_mb = check_restore("nusc_data_train", rec)
    l_ckpt = rec["checkpoint"]
    del rec["model"], rec["opt"]
    resumed, rcounts, resume_peak = run_train_cli(
        [name, "--data-root", nus["root"], "--db-info", nus["db"],
         "--epochs", "2", "--batch-size", "2", "--resume-from", l_ckpt,
         "--log-interval", "5", "--work-dir", os.path.join(tmp, "wd_res")])
    if resumed["first_step"] != rec["last_step"] or \
            resumed["last_step"] != 2 * rec["last_step"]:
        raise AssertionError(f"resume: steps {resumed['first_step']} -> "
                             f"{resumed['last_step']}, saved at "
                             f"{rec['last_step']}")
    check_launches("nusc_data_resume", rcounts, want,
                   len(resumed["step_ms"]))
    del resumed["model"], resumed["opt"]
    free_cache()
    accum, acounts, accum_peak = run_train_cli(
        base + ["--batch-size", "4", "--work-dir",
                os.path.join(tmp, "wd_accum"), "--cfg-options",
                "optim.accum_steps=2"])
    check_launches("nusc_data_accum", acounts, want,
                   2 * len(accum["step_ms"]))
    del accum["model"], accum["opt"]
    free_cache()
    emit(dict(phase="nusc_data_train", config=name, cbgs_samples=len(ds),
              frames=DATA_ROOTS["nus"]["n_train"],
              points_before_filter=DATA_ROOTS["nus"]["points"] *
              (DATA_ROOTS["nus"]["sweeps"] + 1),
              points_kept=int(sample["points_mask"].sum()),
              gt_kept=int(sample["gt_mask"].sum()), root_write_s=write_s,
              loader_ms_per_batch=load_batch, batch=2,
              **step_stats(rec), peak_gb=peak, launches_per_step=want,
              ckpt_save_ms=rec["save_ms"], ckpt_load_ms=load_ms,
              ckpt_mb=size_mb, losses=rec["metrics"],
              resume=dict(first_step=resumed["first_step"],
                          last_step=resumed["last_step"],
                          step_p50_ms=statistics.median(resumed["step_ms"]),
                          wait_share=step_stats(resumed)["wait_share"],
                          peak_gb=resume_peak),
              # both after the first run: cuDNN has timed its algorithms
              accum=dict(batch=4, accum_steps=2,
                         steps=len(accum["step_ms"]),
                         step_p50_ms=statistics.median(accum["step_ms"]),
                         peak_gb=accum_peak, batch2_peak_gb=resume_peak,
                         losses=accum["metrics"]),
              device=smi))

    # 2. the test CLI on the val infos from that checkpoint
    test_cli_phase("nusc_data_test", name, nus["root"], l_ckpt, tmp, smi)

    # 3. srfdet_voxel_nusc_LC, the staged fine-tune: the LiDAR checkpoint
    # into the LC model (--load-from), the LiDAR branch frozen
    lc_name = DATA_CONFIGS["nus_lc"]
    lc_cfg = get_config(lc_name)
    t0 = time.perf_counter()
    lc = synthetic_root.write_nuscenes_root(os.path.join(tmp, "nus_lc"),
                                            **DATA_ROOTS["nus_lc"])
    write_s = time.perf_counter() - t0
    l_state = torch.load(l_ckpt, map_location="cpu",
                         weights_only=True)["model"]
    lidar_names = {k for k in l_state
                   if not k.endswith("num_batches_tracked")}
    fresh = SRFDet(lc_cfg, device="cuda", seed=0)
    init = {k: v.detach().clone() for k, v in fresh.state_dict().items()}
    restored = set(load_pretrained(fresh, l_ckpt))
    state = fresh.state_dict()
    kept_init = [k for k in state if k not in restored and
                 not torch.equal(state[k], init[k])]
    wrong = [k for k in restored
             if not torch.equal(state[k].cpu(), l_state[k])]
    if restored != lidar_names or kept_init or wrong:
        raise AssertionError(f"LC load: {len(restored)} restored of "
                             f"{len(lidar_names)}; moved {kept_init[:4]}; "
                             f"wrong {wrong[:4]}")
    n_img = sum(1 for k in state if k not in restored)
    del fresh, init, state
    lc_ds = train_dataset(lc_cfg, lc["root"], cbgs=False)
    lc_load = loader_ms(lc_ds, 1, batches=4)
    rec, counts, peak = run_train_cli(
        [lc_name, "--data-root", lc["root"], "--load-from", l_ckpt,
         "--no-cbgs", "--batch-size", "1", "--epochs", "1",
         "--log-interval", "1", "--work-dir", os.path.join(tmp, "wd_lc")])
    want = train_launches(rec["model"])
    check_launches("nusc_lc_data_train", counts, want, len(rec["step_ms"]))
    launches["nusc_lc_data_train"] = want
    # the frozen LiDAR branch, parameters and BN buffers, is the L
    # checkpoint's bit for bit after the fine-tune's steps
    after = rec["model"].state_dict()
    moved = [k for k in lidar_names if k.split(".")[0] in LIDAR_MODULES
             and not torch.equal(after[k].cpu(), l_state[k])]
    if moved or not any(k.split(".")[0] in LIDAR_MODULES
                        for k in lidar_names):
        raise AssertionError(f"LC fine-tune moved frozen LiDAR tensors "
                             f"{moved[:4]}")
    load_ms, size_mb = check_restore("nusc_lc_data_train", rec)
    lc_ckpt = rec["checkpoint"]
    del rec["model"], rec["opt"], after
    free_cache()
    emit(dict(phase="nusc_lc_data_train", config=lc_name,
              frames=DATA_ROOTS["nus_lc"]["n_train"], cameras=6,
              raw_hw=DATA_ROOTS["nus_lc"]["img_hw"],
              img_shape=lc_cfg.img.img_shape, mode=lc_cfg.img.mode,
              cameras_in_batch=lc_cfg.img.num_cams,
              root_write_s=write_s, restored_from_l=len(restored),
              kept_init=n_img, loader_ms_per_batch=lc_load, batch=1,
              **step_stats(rec), peak_gb=peak, launches_per_step=want,
              frozen_lidar_tensors=sum(k.split(".")[0] in LIDAR_MODULES
                                       for k in lidar_names),
              ckpt_save_ms=rec["save_ms"], ckpt_load_ms=load_ms,
              ckpt_mb=size_mb, losses=rec["metrics"], device=smi))
    test_cli_phase("nusc_lc_data_test", lc_name, lc["root"], lc_ckpt, tmp,
                   smi)
    free_cache()

    # 4. srfdet_voxel_kitti_L: two steps at batch 2, then kitti_eval
    k_name = DATA_CONFIGS["kitti"]
    k_cfg = get_config(k_name)
    t0 = time.perf_counter()
    kit = synthetic_root.write_kitti_root(os.path.join(tmp, "kitti"),
                                          **DATA_ROOTS["kitti"])
    write_s = time.perf_counter() - t0
    k_ds = train_dataset(k_cfg, kit["root"], db_info=kit["db"])
    k_load = loader_ms(k_ds, 2, batches=2)
    rec, counts, peak = run_train_cli(
        [k_name, "--data-root", kit["root"], "--db-info", kit["db"],
         "--batch-size", "2", "--epochs", "1", "--log-interval", "1",
         "--work-dir", os.path.join(tmp, "wd_kitti")])
    want = train_launches(rec["model"])
    check_launches("kitti_data", counts, want, len(rec["step_ms"]))
    launches["kitti_data"] = want
    load_ms, size_mb = check_restore("kitti_data", rec)
    k_ckpt = rec["checkpoint"]
    del rec["model"], rec["opt"]
    emit(dict(phase="kitti_data_train", config=k_name,
              frames=DATA_ROOTS["kitti"]["n_train"], root_write_s=write_s,
              loader_ms_per_batch=k_load, batch=2, **step_stats(rec),
              peak_gb=peak, launches_per_step=want,
              ckpt_save_ms=rec["save_ms"], ckpt_load_ms=load_ms,
              ckpt_mb=size_mb, losses=rec["metrics"], device=smi))
    test_cli_phase("kitti_data_test", k_name, kit["root"], k_ckpt, tmp, smi)
    return launches


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
    for key in ("tc_bound_ms", "simt_bound_ms", "device_ms", "host_ms",
                "prep_ms", "prep_device_ms", "builds", "lc_launches",
                "lc_train_launches", "data_launches", "img_geometry"):
        if key in t:
            entry[key] = t[key]
    return entry


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from srfdet3d_torch import set_backend_flags
    from srfdet3d_torch.configs import (srfdet_dvoxel_nusc_L,
                                        srfdet_dvoxel_waymo_L,
                                        srfdet_pillar_nusc_L,
                                        srfdet_voxel_kitti_L,
                                        srfdet_voxel_nusc_L,
                                        tiny_kitti_test_config,
                                        tiny_lc_test_config,
                                        tiny_pillar_test_config,
                                        tiny_test_config)
    from srfdet3d_torch.configs import CONFIGS
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
    wcfg = srfdet_dvoxel_waymo_L()
    wbatch = synthetic_batch(wcfg, 1, seed=0)
    pcfg = srfdet_pillar_nusc_L()
    with torch.no_grad():
        conv_cases, subm_cases = encoder_rulebooks(cfg, batch, dev)
        k1_err, k1 = check_gather_conv(cfg.name, conv_cases, dev, gen)
        k2 = check_eqmatch(cfg.name, subm_cases)
        eq_case = subm_cases[0]
        del conv_cases, subm_cases
        # KITTI's widths (conv_input Cin 4, 16/32/64, conv_out 64 -> 128),
        # and K2 at its bitmap encoder's 4 subm stages
        kitti_cases, kitti_subm = encoder_rulebooks(kcfg, kbatch, dev)
        kitti_err, _ = check_gather_conv(kcfg.name, kitti_cases, dev, gen)
        k1_err = max(k1_err, kitti_err)
        check_eqmatch(kcfg.name, kitti_subm)
        del kitti_cases, kitti_subm
        # srfdet_dvoxel_waymo_L: 131,072 voxel slots of a 41 x 1536 x 1536
        # grid (K1's row count, K2's largest plan map)
        waymo_cases, waymo_subm = encoder_rulebooks(wcfg, wbatch, dev)
        waymo_err, _ = check_gather_conv(wcfg.name, waymo_cases, dev, gen)
        k1_err = max(k1_err, waymo_err)
        check_eqmatch(wcfg.name, waymo_subm)
        del waymo_cases, waymo_subm
        train_cases, _ = encoder_rulebooks(
            cfg, synthetic_batch(cfg, 2, seed=0), dev)
        bwd = check_conv_bwd(train_cases, dev, gen)
        k5, roi_case = check_roi_bwd(cfg, dev, gen)
        # K5 at the KITTI head (C 256) and the pillar head (strides 2-16)
        for c in (kcfg, pcfg):
            check_roi_bwd(c, dev, gen)
        lookups = table_lookups(table_backend(kcfg), kbatch, dev)
        k6 = check_rulebook_lookup(kcfg.name, lookups)
        flagship_walk = check_rulebook_lookup(
            cfg.name, table_lookups(table_backend(cfg), batch, dev))
        sync_free(next(c for c in train_cases if c[0] == "down2"), roi_case,
                  eq_case, lookups[0], dev, gen)
        roi_args = roi_case[0]
        del train_cases, roi_case, eq_case, lookups
        # K5 at the image geometry of the LC train steps: the cap-320
        # flagship LC (1,920 RoIs) and the pillar ResNet-50 LC (no cap:
        # 5,400)
        k5_img = [check_img_roi_bwd(CONFIGS[name](), dev, gen)[0]
                  for name in ("srfdet_voxel_nusc_LC",
                               "srfdet_pillar_r50_LC")]
    torch.cuda.empty_cache()
    # kernel-only device times first: late in the process a profiler
    # session misses launches
    device = kernel_device_times(cfg, kcfg, batch, kbatch, roi_args, dev,
                                 gen)
    del roi_args
    torch.cuda.empty_cache()

    none = dict.fromkeys(COUNTED, 0)
    counts, builds = predict_phase("flagship_predict", cfg, batch, smi,
                                   dict(none, gather_conv=21, eqmatch=4))
    k2["builds"] = builds["plan_map"]
    k1_launches, k2_launches = counts["gather_conv"], counts["eqmatch"]
    torch.cuda.empty_cache()
    predict_phase("kitti_predict", kcfg, kbatch, smi,
                  dict(none, gather_conv=12, eqmatch=4))
    torch.cuda.empty_cache()
    counts, builds = predict_phase(
        "kitti_predict", table_backend(kcfg), kbatch, smi,
        dict(none, gather_conv=12, rulebook_lookup=8))
    k6_launches = counts["rulebook_lookup"]
    if builds["key_hash"] != k6["builds"]:
        raise AssertionError(f"KITTI table predict built {builds} hash "
                             f"tables, its walk {k6['builds']}")
    torch.cuda.empty_cache()
    # the flagship on the table backend: 21 K1 and 8 K6 launches, as many
    # hash builds as its lookup walk made
    counts, builds = predict_phase(
        "flagship_table_predict", table_backend(cfg), batch, smi,
        dict(none, gather_conv=21, rulebook_lookup=8))
    if builds["key_hash"] != flagship_walk["builds"]:
        raise AssertionError(f"flagship table predict built {builds} hash "
                             f"tables, its walk {flagship_walk['builds']}")
    torch.cuda.empty_cache()
    dcfg = srfdet_dvoxel_nusc_L()
    predict_phase("dvoxel_nusc_predict", dcfg, synthetic_batch(dcfg, 1, seed=0),
                  smi, dict(none, gather_conv=21, eqmatch=4))
    torch.cuda.empty_cache()
    predict_phase("dvoxel_waymo_predict", wcfg, wbatch, smi,
                  dict(none, gather_conv=21, eqmatch=4))
    torch.cuda.empty_cache()
    # the pillar path runs no sparse conv: no K1, K2 or K6 launch
    predict_phase("pillar_predict", pcfg, synthetic_batch(pcfg, 1, seed=0),
                  smi, none)
    torch.cuda.empty_cache()
    # the six LC configs at full width: their LiDAR branches launch what
    # their LiDAR-only twins do (the image branch runs no TPU kernel's
    # port); Waymo LC with seeded non-zero DCNv2 offsets
    lc_launches = {}
    for phase, name, expect in LC_PHASES:
        c = CONFIGS[name]()
        counts, _ = predict_phase(phase, c, lc_batch(c, 1, seed=0), smi,
                                  dict(none, **expect),
                                  prepare=seed_dcn_offsets)
        lc_launches[phase] = counts
        torch.cuda.empty_cache()
    per_step = train_phase("flagship_train", cfg, smi)
    torch.cuda.empty_cache()
    train_phase("kitti_train", kcfg, smi, warmup=1, steps=5)
    torch.cuda.empty_cache()
    train_phase("pillar_train", pcfg, smi, warmup=1, steps=5)
    torch.cuda.empty_cache()
    # the six LC train steps at full width, each at its own batch size,
    # the LiDAR branch frozen: K1 and K2 in the frozen voxel encoders'
    # forward, K5 once a head iteration for the image RoIAlign, no K3 or
    # K4 and no BEV K5 (the BEV table needs no grad)
    lc_train = {}
    for phase, name in LC_TRAIN_PHASES:
        c = CONFIGS[name]()
        lc_train[phase] = train_phase(
            phase, c, smi, warmup=1, steps=3,
            batch_size=c.optim.batch_size_per_device,
            prepare=seed_dcn_offsets)
        torch.cuda.empty_cache()
    # the runtime around the model: train and test from files on disk
    with tempfile.TemporaryDirectory() as tmp:
        data_launches = data_phases(smi, tmp)
    free_cache()
    tiny_end_to_end(tiny_test_config())
    tiny_end_to_end(table_backend(tiny_kitti_test_config()))
    tiny_end_to_end(table_backend(tiny_test_config()))
    tiny_end_to_end(tiny_pillar_test_config(), patch=False)
    for c, seed in zip(tiny_lc_configs(), TINY_LC_SEEDS):
        tiny_end_to_end(c, prepare=seed_dcn_offsets, seed=seed)
    tiny_train(*tiny_train_setup())
    tiny_train(*tiny_kitti_train_setup())
    for backbone, opts, model_seed, batch_seed, steps in TINY_LC_TRAIN:
        tiny_train(tiny_lc_test_config(backbone, **opts), model_seed,
                   batch_seed, steps, prepare=seed_dcn_offsets)
    for phase, c, b in (("flagship", cfg, batch), ("kitti", kcfg, kbatch),
                        ("kitti_table", table_backend(kcfg), kbatch),
                        ("flagship_table", table_backend(cfg), batch),
                        ("dvoxel_nusc", dcfg, synthetic_batch(dcfg, 1)),
                        ("dvoxel_waymo", wcfg, wbatch),
                        ("pillar", pcfg, synthetic_batch(pcfg, 1))):
        predict_busy(f"{phase}_predict_busy", c, b, smi)
        torch.cuda.empty_cache()
    for phase, name, _ in LC_PHASES:
        c = CONFIGS[name]()
        predict_busy(f"{phase}_busy", c, lc_batch(c, 1, seed=0), smi,
                     seed_dcn_offsets)
        torch.cuda.empty_cache()
    k1.update(device["gather_conv"])
    k2.update(device["eqmatch"])
    k6.update(device["rulebook_lookup"])
    bwd["subm"].update(device["subm"])
    bwd["strided"].update(device["strided"])

    k5_steps = per_step["roi_scatter"]
    k5_step = {key: k5_steps * k5[key]
               for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
    k5_step["bound_by"] = "bytes"
    k5_step["device_ms"] = k5_steps * device["roi_scatter"]["device_ms"]
    k5_step["img_geometry"] = [
        {key: row[key] for key in ("config", "rois", "c", "table_rows", "ms",
                                   "plain_ms", "library_ms", "bound_ms",
                                   "max_abs_err")} for row in k5_img]
    for entry, key in ((k1, "gather_conv"), (k2, "eqmatch"),
                       (bwd["subm"], "subm_bwd"),
                       (bwd["strided"], "strided_bwd"),
                       (k5_step, "roi_scatter"), (k6, "rulebook_lookup")):
        entry["lc_launches"] = {ph: c[key] for ph, c in lc_launches.items()}
        entry["lc_train_launches"] = {ph: c[key]
                                      for ph, c in lc_train.items()}
        entry["data_launches"] = {ph: c[key]
                                  for ph, c in data_launches.items()}
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
