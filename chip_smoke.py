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
   then tail_graph: predict's tail as one CUDA graph
   (models/tail_graph.py) over five frames of the benchmark's
   lidar_stream traffic, each replay bit for bit the eager tail on the
   same encoder output, the last frame's outputs its own, one capture
   and a replay a predict, memory_reserved, the peak and predict's p50
   with and without the graph;
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
   checkpoint's save and load ms and size, or the eval's ms; all of them
   on the data pipeline's default point route, the C++ one
   (srfdet3d_torch/csrc/pointio.cpp, built with g++ after the CUDA
   kernels); then the host side: data_route (the C++ route's build
   seconds; the loader's ms a batch on the nuScenes and KITTI roots on
   each route at 4 threads and 1; samples of both routes equal, the
   points as sets of rows where they fit points_cap, by count where they
   do not), data_step_profile (the flagship step at batch 2 from the
   nuScenes root with the batches held in memory, with the loader on the
   numpy route and on the C++ route: step p50 with profiling.StepTimer,
   wait share, the main thread's and the process's CPU ms, and under
   profiling.trace device busy, host-to-device copy, sync-wait and the
   main thread's host ms outside the syncs) and raw_tree_train (a raw
   nuScenes tree through `python -m srfdet3d_torch.tools.create_data
   nuscenes --with-db`, then one train-CLI epoch from its pickles with
   the GT-database paste: launches against the structure, the tb/ event
   file read back); then
   convert_roundtrip: a seeded full-width model A of srfdet_voxel_nusc_L,
   srfdet_voxel_nusc_LC and srfdet_dvoxel_waymo_LC (seeded DCNv2 offsets)
   written in the reference's mm-stack names and layouts
   (reference_checkpoint: spconv KIO, the fused in_proj, SECOND's first
   conv on the reference's BEV channel order, DCNv2 (Cout, Cin, 3, 3)) as
   mmdet writes a release ({"state_dict": module.-prefixed, "meta"}),
   converted by the port's convert CLI and loaded by the test CLI's load
   path into a fresh model B: B's weights A's bit for bit, B's predict on
   the card A's (valid masks and labels identical, boxes and scores
   within 1e-6), launches equal to the structure; the .pth's MB, the
   convert's and the load's seconds; flagship_learn, run by the learn
   worker (`python3 chip_smoke.py --learn-worker <dir> <start>`, a
   process of its own, two torch threads) from the end of
   data_step_profile to the end of the tiny train steps, beside the
   checks of raw_tree_train, convert_roundtrip, the ddp_* phases, the
   options and the tiny phases (their times are not the port's numbers;
   its lines come out when it ends): the flagship at full width trained on two planted nuScenes keyframes (LEARN_ROOT: no
   sweeps, one box of each class a frame, 400 points planted in each)
   through the port's dataset (the test pipeline's transforms), loader and
   train_step for LEARN_STEPS steps at batch 2 with the config's AdamW at
   LEARN_OPTIONS, the loss every 25 steps, and the test CLI's nuScenes
   evaluator on those two frames at score_thr 0 with the seeded random
   weights and after training: the last loss at most half the first,
   mAP at least max(100 x the random weights', 0.01), each frame's
   top-scored box within 1 m BEV of a planted centre; step p50, peak GB,
   launches a step and a frame equal to the structure; the phase runs
   under deterministic cuDNN (deterministic_cudnn: no benchmark timing),
   restored after; the predict exports (tools/export.py),
   flagship_export (the flagship, weights passed in) and
   kitti_table_export (srfdet_voxel_kitti_L on the table backend,
   weights baked), run by the export worker (`python3 chip_smoke.py
   --export-worker <dir> <start>`, a process of its own, one torch
   thread): started with the learn worker, it exports each predict (no
   launch while it traces), saves it, loads it through the op library
   and checks its graph (the srfdet:: ops of its backend, one
   while_loop, no host read); after the tiny train steps and the learn
   worker's end, alone on the card, it calls each artifact on its
   predict phase's batch: the launches of the live predict (K1 21 and K2
   4; K1 12 and K6 8, with the lookup walk's hash builds), outputs within
   tests/test_export.py's bar of the live predict's (scores and boxes
   rtol 1e-5 / atol 1e-6, labels and valid equal) under deterministic
   cuDNN, with the live-vs-live and artifact-vs-live spreads; each line
   has export s, load s, file MB, the artifact's p50 beside eager
   predict's over EXPORT_RUNS alternating calls, the seconds waited for
   the worker to be ready and the seconds of its card half; and data
   parallelism (srfdet3d_torch/parallel): ddp_flagship_train, the
   flagship at full width (dropout off) on two ranks that share the card
   over gloo (host-staged collectives; NCCL refuses two ranks on one
   card), `python3 chip_smoke.py --ddp-worker <dir>` each, at batch 2
   a rank, for 3 steps, against this process at batch 4: each step run
   again from the ranks' state before it (rank 0's parameters, buffers
   and AdamW moments), playing back the ranks' discrete decisions
   (Decisions: RoI levels, sample corners, OTA matches), and held within
   DDP_LOSS_RTOL, DDP_GRAD_RTOL, DDP_LEAF_TOL and 2 lr (step_errors); the
   decisions that flip and the first step's error without playback
   reported; the ranks' parameters and buffers bit for bit equal, each
   rank's launches a step equal to the structure, its p50 and peak, the
   collectives a step and the gloo all-reduce times;
   model_axis_flagship, the same flagship steps on a 2 x 2 (data x
   model) grid of such ranks (`--ddp-worker <dir> 2`), the 900 proposals
   sharded 450 a model rank under proposal_sharding, the decisions
   joined along the proposals as well (joined_decisions with n_model),
   held as ddp_flagship_train's, after two predicts (at the flagship's
   32-cell BEV patch window, and at MODEL_AXIS_OVERFLOW_PATCH, where the
   misfits overflow the 64 fallback slots and those of rank 0's block
   decide drops in rank 1's) whose
   gathered outputs are held field by field within MODEL_AXIS_PRED_TOL
   of this process's; with each rank's launches, p50 and peak, the
   collectives a step by group and the BEV patch rule's misfits a
   sample;
   ddp_nccl_world1, 3 flagship steps in an NCCL group of one, every
   collective issued, between two runs with no group on the same weights
   (p50s, differences per step), the first step held within the same
   tolerances against a no-group step that plays back its decisions;
   ddp_cli, the launchers
   dist_train.sh (2 ranks, gloo on the card, 4 steps from a seeded root)
   and dist_test.sh (3 val frames on 2 ranks) against the test CLI in one
   process on the same checkpoint (the dump within 1e-4, the metrics within
   1e-4); every subprocess killed at DDP_TIMEOUT;
    then the options that no shipped config turns on, through
   --cfg-options (option_config), at the flagship's full width:
   options_encoder (srfdet_voxel_nusc_L with the deformable BEV encoder:
   its predict phase, K1 21 and K2 4, and train steps at batch 2 with the
   hungarian assigner, K1 21, K2 4, K3 17, K4 4, K5 5 a step, with the host
   ms of the scipy solves a step), options_auction_nodpg (no DPG, the
   auction assigner and head remat: train steps, the auction's rounds a
   step and the budgets it spent, one step's grads with remat within 1e-5
   of the same step's without, both peaks) and options_img_patch
   (srfdet_voxel_nusc_LC's predict with the image RoIAlign's xpatch 32 at
   fallbacks -1 and 0 and its patch 32 at -1: fallback -1 within 1e-4 of
   the pairs route, the pairs fallback 0 zeroes a camera in each head
   iteration);
11. tiny predicts (tiny_test_config; tiny_kitti_test_config and
   tiny_test_config with middle.rulebook="table"; tiny_pillar_test_config
   with its own corner RoIAlign; two tiny LC configs: VoVNet-19-slim on
   2 cameras, and a caffe ResNet-50 with DCNv2 in stages 3-4 and a BN
   neck; the VoVNet one with every option a predict runs,
   all_options_tiny), and 12. two tiny train steps each of tiny_test_config, of
   tiny_kitti_test_config (code size 8) and of the tiny VoVNet LC config,
   and one of the tiny ResNet-50 LC config (TINY_LC_TRAIN: the LiDAR
   branch and the backbone's stem and stage 1 frozen, GridMask off), with
   the kernels on the card against the same
   weights on the CPU with the plain versions; then one profiled predict
   of each full-width predict config, the LC ones included
   (*_predict_busy: device busy time and share);
The bfloat16 compute modes run among these phases: after K1's flagship
check, K1-bf16 at the same 21 convs on bf16 tables and weights
(gather_conv_bf16 lines, with the CUDA kernels one call launches: the
gather-GEMM alone where Cin % 8 == 0), after K3 / K4's, K4-bf16 at the
step's 4 strided and conv_out convs (conv_bwd_bf16, with the device ms of
the preparation, the dfeats gather and the dW pass apart), each within
one bf16 ulp of its plain version (BF16_RTOL) with ms, device ms, plain,
library (index_select and bf16 products) and the bound at the bf16 rate
(PEAK_BF16, 2-byte tables); after flagship_predict, flagship_bf16_predict
(compute_dtype="bfloat16": K1-bf16 21, K2 4) and flagship_bf16_vs_f32
(the bf16 model's box centres against the float32 model's on the same
weights, mean under 0.5 m); after the LC predicts,
nusc_lc_img_bf16_predict (img.compute_dtype="bfloat16": the launches of
nusc_lc_predict); after flagship_train, flagship_bf16_train (K1-bf16 21,
K2 4, K3 17 on float32 upcasts, K4-bf16 4, no K5: bf16 RoIAlign tables
take the plain route); after the LC train phases, nusc_lc_img_bf16_train
(nusc_lc_train's launches); after the tiny predicts, tiny_bf16_end_to_end
of both modes (the card closer to the CPU's bf16 outputs than those are
to the float32 model's); and their *_busy lines with the others'.  Every
parameter of every train phase stays float32.
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
   data_launches, its launches a step in each data phase's train run,
   convert_launches, its launches in each round-trip predict,
   learn_launches, its launches a flagship_learn step, ddp_launches,
   each ddp_flagship_train rank's launches a step, model_axis_launches,
   each model_axis_flagship rank's launches a step, and options_launches,
   its launches in each option phase's predict or train step,
   export_launches, its launches in each export phase's artifact call,
   and bf16_launches, its launches in each bf16 phase; K1-bf16
   (gather_conv_bf16) and K4-bf16 (conv_bwd_strided_bf16) are entries of
   their own.

The second-to-last line is nvidia-smi's name and power limit; the last line
is {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import dataclasses
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
# bf16 tensor cores, dense: the bound of the bf16 gather-GEMMs (K1-bf16,
# K4-bf16), one product a multiply-add
PEAK_BF16 = 989e12
# a bf16 kernel against its plain version: both sum in float32 and round
# once, so they differ by at most one bf16 ulp (2^-7 relative), plus float32
# summation-order noise near zero (2^-14 of the largest output)
BF16_RTOL, BF16_ATOL_REL = 2.0 ** -7, 2.0 ** -14
# the gather-GEMM kernels' own device code, by name in a profiler trace:
# the forward and dfeats gathers (float32 3xTF32, bf16 wgmma) and the dW
# passes (float32, bf16 wgmma) with their chunk-order sum; the strided
# backward (K4) also runs its preparation kernels (reverse rulebook, row
# grouping: 5 launches), K5 its one kernel
DFEATS_KERNELS = ("gather_gemm::kernel", "sm90::gather_kernel")
DW_KERNELS = ("dw_partial_kernel", "dw_wgmma_kernel", "dw_reduce_kernel",
              "dw_reduce_bf16_kernel")
GATHER_GEMM_KERNELS = DFEATS_KERNELS + DW_KERNELS
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
# timed predicts a predict phase, and runs of a predict's or a train
# step's parts (kept low: the whole run must end within its time limit on a
# slow host; 6 and 3 before the bf16 phases came)
PREDICT_RUNS = 4
PARTS_RUNS = 2
# every kernel against its plain version: rtol + atol * sqrt(terms summed
# into an output element); the kernel sums in another order than the plain
# version (K5 with atomics, in an order that changes from run to run), so
# float32 rounding differs by a few ulps per term
RTOL, ATOL = 1e-5, 1e-5


_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries t_s, the seconds since
    the script started (where its time goes)."""
    if "phase" in obj:
        obj = dict(obj, t_s=time.perf_counter() - _START)
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
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
    """The JAX package's synthetic scene (__graft_entry__._synthetic_batch),
    through the port's copy (tools/export.synthetic_batch): half of
    points_cap real, uniform in pc_range, seeded; with_gt adds gt_cap GT
    boxes of which the first 8 are valid."""
    from srfdet3d_torch.tools.export import synthetic_batch as port_batch
    return port_batch(cfg, b, with_gt=with_gt, seed=seed)


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


def kernel_device_ms(fn, per_call: int, iters: int = 5, tries: int = 3,
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


def kernels_per_call(fn, iters: int = 3, tries: int = 3,
                     names=GATHER_GEMM_KERNELS) -> float:
    """The CUDA kernels of any name that one call of fn launches, from a
    torch.profiler session (the card's spin at its start left out).  As in
    kernel_device_ms, a session counts only if it saw one launch of the
    named kernels a call."""
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
        named = every = 0
        for e in prof.key_averages():
            if getattr(e, "device_type", None) != DeviceType.CUDA or \
                    "spin_kernel" in e.key:
                continue
            every += e.count
            if any(name in e.key for name in names):
                named += e.count
        if named == iters:
            return every / iters
    raise AssertionError(f"kernels_per_call: no profiler session of {tries} "
                         f"saw {iters} launches of {names} (last: {named})")


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


def bf16_bounds(flops: float, nbytes: float):
    """(bound ms, what bounds it) of a bf16 gather-GEMM call: the larger of
    bytes over HBM's rate and flops over the bf16 tensor-core rate."""
    ops, bb = flops / PEAK_BF16 * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(ops, bb), "operations" if ops >= bb else "bytes"


def check_bf16(what, got, ref):
    """A bf16 kernel's output against its plain version's: within one bf16
    ulp, plus float32 order noise near zero (BF16_RTOL, BF16_ATOL_REL).
    Returns the max abs error."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    tol = BF16_RTOL * ref.abs() + BF16_ATOL_REL * float(ref.abs().max())
    if not bool((err <= tol).all()):
        raise AssertionError(f"{what}: max err {float(err.max())} over one "
                             f"bf16 ulp")
    return float(err.max())


def check_gather_conv_bf16(config, cases, dev, gen):
    """K1-bf16 at every conv shape of the bf16 model's encoder (bf16 tables
    and weights): against the plain version within one bf16 ulp, then ms a
    launch (events), kernel-only device ms (profiler, early in the
    process), the CUDA kernels one wrapper call launches (profiler; a call
    with Cin % 8 == 0 must launch the gather-GEMM alone: no pad, no weight
    transpose), the plain version, index_select + a bf16 matmul, and the
    bound (2-byte tables, 989 TFLOP/s).  Returns the max error and the sums
    over a predict."""
    from srfdet3d_torch.ops.gather_conv import gather_conv, gather_conv_plain
    totals = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, library_ms=0.0,
                  bound_ms=0.0, ops_bound_ms=0.0, bytes_bound_ms=0.0)
    max_err = 0.0
    for name, n, idx, cin, cout, per_predict in cases:
        m, k = idx.shape
        feats = torch.randn(n, cin, generator=gen).to(dev, torch.bfloat16)
        w = (torch.randn(k, cin, cout, generator=gen) *
             math.sqrt(2.0 / (k * cin))).to(dev, torch.bfloat16)
        got = gather_conv(feats, idx, w)
        ref = gather_conv_plain(feats, idx, w)
        torch.cuda.synchronize()
        err = check_bf16(f"gather_conv_bf16 {name}", got, ref)
        if got.dtype != torch.bfloat16:
            raise AssertionError(f"gather_conv_bf16 {name}: {got.dtype} out")
        max_err = max(max_err, err)
        table0 = torch.cat([feats, feats.new_zeros(1, cin)])
        w2 = w.reshape(k * cin, cout)
        flat = idx.reshape(-1).long()
        ms = time_ms(lambda: gather_conv(feats, idx, w))
        device_ms = kernel_device_ms(lambda: gather_conv(feats, idx, w), 1)
        kernels = kernels_per_call(lambda: gather_conv(feats, idx, w))
        if cin % 8 == 0 and kernels != 1:
            raise AssertionError(f"gather_conv_bf16 {name}: a call launched "
                                 f"{kernels} kernels, not the gather-GEMM "
                                 f"alone")
        plain_ms = time_ms(lambda: gather_conv_plain(feats, idx, w))
        lib_ms = time_ms(lambda: torch.index_select(table0, 0, flat)
                         .view(m, k * cin) @ w2)
        nnz = int((idx < n).sum())
        flops = 2.0 * nnz * cin * cout
        nbytes = 2.0 * (n * cin + k * cin * cout + m * cout) + 4.0 * m * k
        bound, bound_by = bf16_bounds(flops, nbytes)
        emit(dict(phase="gather_conv_bf16", config=config, conv=name, n=n,
                  m=m, k=k, cin=cin, cout=cout,
                  launches_per_predict=per_predict, max_abs_err=err, ms=ms,
                  device_ms=device_ms, kernels_per_call=kernels,
                  plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                  bound_by=bound_by, nnz=nnz))
        for key, val in (("ms", ms), ("device_ms", device_ms),
                         ("plain_ms", plain_ms), ("library_ms", lib_ms),
                         ("bound_ms", bound)):
            totals[key] += per_predict * val
        key = "ops_bound_ms" if bound_by == "operations" else "bytes_bound_ms"
        totals[key] += per_predict * bound
    return max_err, totals


def check_conv_bwd_bf16(cases, dev, gen):
    """K4-bf16 at the strided and conv_out convs of the bf16 flagship's
    train step (batch 2): dfeats and dW against scatter_bwd_plain in bf16
    within one bf16 ulp, both bf16; then ms a launch (events, with the
    rulebook preparation), kernel-only device ms, split as
    conv_bwd_device splits K4's (the preparation's, the dfeats gather's and
    the dW pass's kernels), the plain version, the reverse-rulebook gather
    + two bf16 cuBLAS products, and the bound (2-byte tables, 989
    TFLOP/s).  The subm convs' backward in bf16 is
    K3's float32 kernel on upcasts, checked in float32 by check_conv_bwd.
    Returns the sums over a step."""
    from srfdet3d_torch.ops import gather_conv_bwd as gcb
    totals = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, library_ms=0.0,
                  bound_ms=0.0, ops_bound_ms=0.0, bytes_bound_ms=0.0,
                  max_abs_err=0.0)
    bf = torch.bfloat16
    for name, n, idx, cin, cout, per_step in cases:
        if name == "conv_input" or name.endswith("_subm"):
            continue
        m, k = idx.shape
        feats = torch.randn(n, cin, generator=gen).to(dev, bf)
        w = (torch.randn(k, cin, cout, generator=gen) *
             math.sqrt(2.0 / (k * cin))).to(dev, bf)
        g = torch.randn(m, cout, generator=gen).to(dev, bf)

        def kern():
            return gcb.strided_conv_bwd(feats, idx, w, g)

        def plain():
            return gcb.scatter_bwd_plain(feats, idx, w, g)
        (got_f, got_w), (ref_f, ref_w) = kern(), plain()
        torch.cuda.synchronize()
        if got_f.dtype != bf or got_w.dtype != bf:
            raise AssertionError(f"conv_bwd_bf16 {name}: {got_f.dtype}, "
                                 f"{got_w.dtype} out")
        err = max(check_bf16(f"conv_bwd_bf16 {name} dfeats", got_f, ref_f),
                  check_bf16(f"conv_bwd_bf16 {name} dW", got_w, ref_w))
        rev, _ = gcb.strided_prep(idx, n, False)
        g0 = torch.cat([g, g.new_zeros(1, cout)])
        flat_rb = rev.reshape(-1).long()
        wt2 = w.transpose(1, 2).reshape(k * cout, cin)

        def library():
            gat = torch.index_select(g0, 0, flat_rb).view(n, k * cout)
            return gat @ wt2, feats.t() @ gat
        ms = time_ms(kern)
        device_ms = kernel_device_ms(
            kern, 3 + STRIDED_PREP_LAUNCHES,
            names=GATHER_GEMM_KERNELS + STRIDED_PREP_KERNELS)
        split = dict(
            prep_device_ms=kernel_device_ms(
                lambda: gcb.strided_prep(idx, n), STRIDED_PREP_LAUNCHES,
                names=STRIDED_PREP_KERNELS),
            dfeats_device_ms=kernel_device_ms(kern, 1,
                                              names=DFEATS_KERNELS),
            dw_device_ms=kernel_device_ms(kern, 2, names=DW_KERNELS))
        plain_ms = time_ms(plain)
        lib_ms = time_ms(library)
        nnz = int((idx < n).sum())
        flops = 2 * 2.0 * nnz * cin * cout
        nbytes = (2.0 * (2 * n * cin + m * cout + 2 * k * cin * cout) +
                  4.0 * m * k)
        bound, bound_by = bf16_bounds(flops, nbytes)
        emit(dict(phase="conv_bwd_bf16", kernel="K4-bf16", conv=name, n=n,
                  m=m, k=k, cin=cin, cout=cout, launches_per_step=per_step,
                  max_abs_err=err, ms=ms, device_ms=device_ms, **split,
                  plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                  bound_by=bound_by, nnz=nnz))
        totals["max_abs_err"] = max(totals["max_abs_err"], err)
        for key, val in (("ms", ms), ("device_ms", device_ms),
                         ("plain_ms", plain_ms), ("library_ms", lib_ms),
                         ("bound_ms", bound)):
            totals[key] += per_step * val
        key = "ops_bound_ms" if bound_by == "operations" else "bytes_bound_ms"
        totals[key] += per_step * bound
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
           "roi_scatter", "rulebook_lookup", "gather_conv_bf16",
           "strided_bwd_bf16")


# the system's counters (srfdet3d_torch.utils.profiling) of each kernel in
# COUNTED order, and of the builds counted apart from the launches: K2's
# plan maps and K6's hash tables
COUNTERS = ("gather_conv.launches", "eqmatch.launches",
            "gather_conv_bwd.subm_launches",
            "gather_conv_bwd.strided_launches", "roi_scatter.launches",
            "rulebook_lookup.launches", "gather_conv.bf16_launches",
            "gather_conv_bwd.strided_bf16_launches")
BUILD_COUNTERS = {"plan_map": "eqmatch.map_builds",
                  "key_hash": "rulebook_lookup.builds"}
HUNGARIAN = ("copy_ms", "host_ms", "solves", "auctions", "rounds",
             "exhausted")


def reset_counts(*prefixes):
    """Zero the launch and build counters (or the counters whose names
    start with one of `prefixes`)."""
    from srfdet3d_torch.utils import profiling
    profiling.reset(*(prefixes or COUNTERS + tuple(BUILD_COUNTERS.values())))


def read_builds():
    """Preparations since reset_counts, counted apart from the launches:
    K2's plan maps and K6's hash tables."""
    from srfdet3d_torch.utils import profiling
    counts = profiling.snapshot()
    return {k: counts.get(name, 0) for k, name in BUILD_COUNTERS.items()}


def read_counts():
    """Launches since reset_counts of the kernels in COUNTED order."""
    from srfdet3d_torch.utils import profiling
    counts = profiling.snapshot()
    return {k: counts.get(name, 0) for k, name in zip(COUNTED, COUNTERS)}


def hungarian_stats():
    """The assignment's counters since reset_counts("hungarian."): scipy
    solves and their copy and host ms, auctions, rounds, budgets spent."""
    from srfdet3d_torch.utils import profiling
    counts = profiling.snapshot()
    return {k: counts.get("hungarian." + k, 0) for k in HUNGARIAN}


def all_finite(out) -> bool:
    return all(bool(torch.isfinite(v.float()).all()) for v in out.values())


def predict_launches(model):
    """Launches per predict the model's structure gives: every gathered
    conv once (K1; K1-bf16 in the bf16 model); on the bitmap backend one
    eq-match per subm stage (K2), on the table backend one lookup per subm
    stage, per downsample and for conv_out (K6); none on the pillar path,
    which has no sparse conv."""
    from srfdet3d_torch.models.sparse_encoder import GatheredConvBN
    want = dict.fromkeys(COUNTED, 0)
    if model.cfg.middle.kind == "pillar_scatter":
        return want                     # no sparse conv: no K1, K2 or K6
    enc = model.pts_middle_encoder
    convs = sum(isinstance(mod, GatheredConvBN) for mod in enc.modules())
    stages = len(model.cfg.middle.encoder_channels)
    bf16 = model.dtype == torch.bfloat16
    want["gather_conv_bf16" if bf16 else "gather_conv"] = convs
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
    `expect` and the model's structure, finite outputs, p50 over
    PREDICT_RUNS predicts, peak memory, decode with score_thr=0, then the
    parts (and on an LC model with an image-RoI cap, the visible pairs a
    camera against it).  `prepare(model)` edits the seeded model first.  Returns the
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
    for _ in range(PREDICT_RUNS):
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


# lidar_stream frames the tail_graph phase replays, and its seed
TAIL_FRAMES = 4
TAIL_SEED = 2 ** 33 + 22


@torch.no_grad()
def tail_graph_phase(smi, frames: int = TAIL_FRAMES, seed: int = TAIL_SEED):
    """Predict's tail graph (models/tail_graph.py) on the flagship at full
    width, over `frames` + 1 frames of the benchmark's lidar_stream
    traffic.  Each frame's sparse encoder output goes through the eager
    tail (`SRFDet._tail`) and through the graph: bit for bit the same
    outputs.  The last frame comes after the others and must give its own
    outputs, not the frame before's (no static input goes stale).  Over
    the predicts after set-up: one capture, a replay a frame, no eager
    count.  Beside them: whether two eager forwards of one frame agree
    bit for bit (the voxelizer's and the encoder's kernels are upstream of
    the graph), memory_reserved and the peak allocated over predicts with
    and without the graph (its predicate patched off), and their p50."""
    from unittest import mock

    from benchmark import scene
    from benchmark.registry import Registry
    from srfdet3d_torch.configs import get_config
    from srfdet3d_torch.models.detector import TAIL_MODULES, SRFDet
    from srfdet3d_torch.utils import profiling
    reg = Registry()
    cell = reg.cell("nusc_L.predict.stream")
    traffic = dict(reg.traffic(cell), pool=frames + 1)
    pool = scene.make_pool(traffic, reg.config(cell), seed, "cuda")
    batches = [{k: b[k].cuda() for k in ("points", "points_mask")}
               for b in pool]
    model = SRFDet(get_config("srfdet_voxel_nusc_L"), device="cuda",
                   seed=0)

    def sparse_of(b):
        feats, vox = model.voxel_features(*model._inputs(b))
        return model.middle(feats, vox, dense=False)

    def predict_ms(b):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.predict(b)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    with mock.patch.object(SRFDet, "tail_graphed",
                           lambda self, batch: False):
        forward_repeats = same(model(batches[0]), model(batches[0]))
        for b in batches:
            model.predict(b)            # cuDNN's search on the first
        torch.cuda.reset_peak_memory_stats()
        eager_ms = [predict_ms(b) for b in batches]
        eager_peak = torch.cuda.max_memory_allocated()
    eager_reserved = torch.cuda.memory_reserved()
    profiling.reset("tail_graph.")
    model.predict(batches[0])           # the capture
    captured_reserved = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    graphed_ms = [predict_ms(b) for b in batches]
    graph_peak = torch.cuda.max_memory_allocated()
    counts = {k: profiling.snapshot().get("tail_graph." + k, 0)
              for k in ("captures", "replays", "eager")}
    want = dict(captures=1, replays=frames + 2, eager=0)
    if counts != want:
        raise AssertionError(f"tail_graph counted {counts}, want {want}")
    graphed, eager = [], []
    for b in batches:
        sparse = sparse_of(b)
        eager.append(model._tail(*sparse))
        graphed.append(model._tail_graphs.run(model._tail, sparse, model,
                                              TAIL_MODULES))
    for i, (g, e) in enumerate(zip(graphed, eager)):
        if not same(g, e):
            gap = max(float((x - y).abs().max()) for x, y in zip(g, e))
            raise AssertionError(f"tail_graph: frame {i}'s replay differs "
                                 f"from its eager tail (max {gap:.3g})")
    if same(graphed[-1], graphed[-2]):
        raise AssertionError("tail_graph: the last frame gave the frame "
                             "before's outputs")
    emit(dict(phase="tail_graph", config="srfdet_voxel_nusc_L",
              traffic="lidar_stream", frames=frames + 1, counts=counts,
              tail_bit_equal=True, eager_forward_repeats=forward_repeats,
              memory_reserved_bytes=dict(eager=eager_reserved,
                                         with_graph=captured_reserved),
              peak_allocated_bytes=dict(eager=eager_peak,
                                        with_graph=graph_peak),
              predict_p50_ms=dict(eager=statistics.median(eager_ms),
                                  with_graph=statistics.median(graphed_ms)),
              device=smi))


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


def predict_parts(phase, model, batch, smi, runs: int = PARTS_RUNS):
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


# predicts and artifact calls an export phase times, alternating, after
# one untimed call of each
EXPORT_RUNS = 5
# the artifact's outputs against the live predict's (tests/test_export.py's
# bar): scores and boxes allclose, labels and valid equal
EXPORT_RTOL, EXPORT_ATOL = 1e-5, 1e-6
EXPORT_OPS = {"bitmap": ("srfdet.gather_conv.default",
                         "srfdet.eqmatch_rulebook.default"),
              "table": ("srfdet.gather_conv.default",
                        "srfdet.key_hash.default",
                        "srfdet.rulebook_lookup.default")}
# the exported predicts: (phase, config, on the table backend, baked, the
# live predict's launches)
EXPORT_CASES = (
    ("flagship_export", "srfdet_voxel_nusc_L", False, False,
     dict(gather_conv=21, eqmatch=4)),
    ("kitti_table_export", "srfdet_voxel_kitti_L", True, True,
     dict(gather_conv=12, rulebook_lookup=8)))
# seconds the export worker may take from its start to its end
EXPORT_TIMEOUT = 900


def output_spread(a, b):
    """Largest |a - b| of the float outputs, and whether the integer ones
    are equal."""
    return dict(scores=float((a["scores"] - b["scores"]).abs().max()),
                boxes=float((a["boxes"] - b["boxes"]).abs().max()),
                labels_equal=bool(torch.equal(a["labels"], b["labels"])),
                valid_equal=bool(torch.equal(a["valid"], b["valid"])))


def prepare_export(phase, name, table, bake, work):
    """The host half of an export phase: the config's seeded model on the
    card, its predict exported (tools/export.py) with no launch while it
    traces, saved, loaded through the op library, its graph holding the
    srfdet:: ops of its backend, one while_loop and no host read."""
    from srfdet3d_torch.configs import CONFIGS
    from srfdet3d_torch.models.detector import SRFDet
    from srfdet3d_torch.tools import export
    cfg = CONFIGS[name]()
    cfg = table_backend(cfg) if table else cfg
    model = SRFDet(cfg, device="cuda", seed=0)
    path = os.path.join(work, f"{phase}.pt2")
    reset_counts()
    t0 = time.perf_counter()
    export.export_predict(cfg, path, model=model, bake_params=bake)
    export_s = time.perf_counter() - t0
    if read_counts() != dict.fromkeys(COUNTED, 0) or any(
            read_builds().values()):
        raise AssertionError(f"{phase}: the export launched "
                             f"{read_counts()}, built {read_builds()}")
    t0 = time.perf_counter()
    prog = export.load_artifact(path)
    load_s = time.perf_counter() - t0
    targets = {str(n.target) for n in prog.graph.nodes
               if n.op == "call_function"}
    backend = "bitmap" if model.pts_middle_encoder.use_bitmap else "table"
    missing = [op for op in EXPORT_OPS[backend] if op not in targets]
    if missing or "while_loop" not in targets or \
            "aten._local_scalar_dense.default" in targets:
        raise AssertionError(f"{phase}: graph lacks {missing} or the "
                             f"while_loop, or holds a host read")
    return dict(phase=phase, cfg=cfg, model=model, bake=bake,
                run=prog.module(), export_s=export_s, load_s=load_s,
                file_mb=os.path.getsize(path) / 1e6)


def check_export(prep, expect, smi):
    """The card half: the artifact called on the predict phase's batch
    (with the live model's state when its weights are passed in) launches
    `expect` with the live predict's preparations, and its outputs meet
    the bar against the live predict's, both under deterministic cuDNN
    (the live-vs-live and artifact-vs-live spreads are kept); then its
    p50 beside eager predict's over EXPORT_RUNS alternating calls, after
    one untimed call of each.
    Returns the phase's record."""
    phase, cfg, model, run = (prep["phase"], prep["cfg"], prep["model"],
                              prep["run"])
    batch = {k: v.cuda() for k, v in synthetic_batch(cfg, 1, seed=0).items()}
    args = (batch,) if prep["bake"] else (model.state_dict(), batch)
    with deterministic_cudnn():
        live = model.predict(batch)
        again = model.predict(batch)
        torch.cuda.synchronize()
        reset_counts()
        got = run(*args)
        torch.cuda.synchronize()
        counts, builds = read_counts(), read_builds()
    want = dict(dict.fromkeys(COUNTED, 0), **expect)
    if counts != want or counts != predict_launches(model) or \
            builds != predict_builds(model):
        raise AssertionError(f"{phase}: the artifact launched {counts} and "
                             f"built {builds}; the live predict launches "
                             f"{want} and builds {predict_builds(model)}")
    spreads = dict(live_vs_live=output_spread(again, live),
                   artifact_vs_live=output_spread(got, live))
    ok = set(got) == set(live) and all(
        torch.equal(got[k], live[k]) for k in ("labels", "valid")) and all(
        torch.allclose(got[k], live[k], rtol=EXPORT_RTOL, atol=EXPORT_ATOL)
        for k in ("scores", "boxes"))
    if not ok:
        raise AssertionError(f"{phase}: the artifact's outputs miss the bar "
                             f"against the live predict: {spreads}")
    eager, artifact = [], []
    pairs = ((lambda: model.predict(batch), eager),
             (lambda: run(*args), artifact))
    # one untimed call each first: cuDNN times its algorithms on the
    # first call with benchmark on (above it ran deterministic)
    for fn, _ in pairs:
        fn()
    for _ in range(EXPORT_RUNS):
        for fn, times in pairs:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    return dict(phase=phase, config=cfg.name, rulebook=cfg.middle.rulebook,
                bake_params=prep["bake"], launches=counts, builds=builds,
                export_s=prep["export_s"], load_s=prep["load_s"],
                file_mb=prep["file_mb"],
                artifact_p50_ms=statistics.median(artifact),
                eager_p50_ms=statistics.median(eager), runs=EXPORT_RUNS,
                artifact_ms=artifact, eager_ms=eager,
                valid_boxes=int(got["valid"].sum()), **spreads, device=smi)


def export_worker(work: str) -> int:
    """`python3 chip_smoke.py --export-worker <dir> <start>`: the export
    phases in a process of their own.  It prepares every EXPORT_CASES
    artifact (prepare_export: host work, one torch thread), writes
    <dir>/ready, waits for <dir>/go, then runs each card half
    (check_export) and writes the records to <dir>/export.json."""
    from srfdet3d_torch import set_backend_flags
    torch.set_num_threads(1)
    set_backend_flags()
    smi = nvidia_smi()
    preps = [prepare_export(phase, name, table, bake, work)
             for phase, name, table, bake, _ in EXPORT_CASES]
    open(os.path.join(work, "ready"), "w").close()
    go = os.path.join(work, "go")
    while not os.path.exists(go):
        time.sleep(0.2)
    records = [check_export(prep, case[4], smi)
               for prep, case in zip(preps, EXPORT_CASES)]
    write_json(os.path.join(work, "export.json"), records)
    return 0


def learn_worker(work: str) -> int:
    """`python3 chip_smoke.py --learn-worker <dir> <start>`: flagship_learn
    in a process of its own (two torch threads), its data root and
    checkpoints under <dir>; its lines go to its log, its launches a step
    to <dir>/learn.json."""
    from srfdet3d_torch import set_backend_flags
    torch.set_num_threads(2)
    set_backend_flags()
    launches = flagship_learn(nvidia_smi(), work)
    write_json(os.path.join(work, "learn.json"), launches)
    return 0


def write_json(path: str, obj) -> None:
    with open(path + ".tmp", "w") as f:
        json.dump(obj, f)
    os.replace(path + ".tmp", path)


class PhaseWorker:
    """`python3 chip_smoke.py <flag> <dir> <start>` in a session of its
    own, its output in <dir>/worker.log; <start> is this script's start on
    the monotonic clock, which every process of the host shares, so the
    worker's lines carry t_s on this process's scale.  close() kills it if
    it still runs and removes its directory; it also runs at exit."""

    def __init__(self, flag: str, timeout: float):
        import atexit
        self.flag, self.timeout = flag, timeout
        self.work = tempfile.mkdtemp(prefix=f"srfdet_{flag.strip('-')}_")
        self.log = os.path.join(self.work, "worker.log")
        self.t0 = time.perf_counter()
        with open(self.log, "w") as f:
            self.proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), flag, self.work,
                 repr(_START)], stdout=f, stderr=subprocess.STDOUT,
                start_new_session=True)
        atexit.register(self.close)

    def _fail(self, why: str):
        self.close_proc()
        self.relay()
        with open(self.log) as f:
            tail = f.read()[-3000:]
        raise AssertionError(f"the {self.flag} process {why}:\n{tail}")

    def _poll(self) -> None:
        """Raise if the worker exited with an error or outran its time."""
        if self.proc.poll() is not None:
            self._fail(f"exited {self.proc.returncode}")
        if time.perf_counter() - self.t0 > self.timeout:
            self._fail(f"ran past {self.timeout} s")

    def wait(self) -> None:
        """Wait for the worker to end; raise with its log if it fails or
        outruns its time."""
        try:
            self.proc.wait(timeout=max(
                self.timeout - (time.perf_counter() - self.t0), 1.0))
        except subprocess.TimeoutExpired:
            self._fail(f"ran past {self.timeout} s")
        if self.proc.returncode != 0:
            self._fail(f"exited {self.proc.returncode}")

    def relay(self) -> None:
        """The worker's JSON lines to this process's output, the rest of
        its log to standard error."""
        with open(self.log) as f:
            for line in f:
                out = sys.stdout if line.startswith("{") else sys.stderr
                out.write(line)
        sys.stdout.flush()

    def close_proc(self):
        import signal
        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.wait()

    def close(self):
        import shutil
        self.close_proc()
        shutil.rmtree(self.work, ignore_errors=True)


class ExportWorker(PhaseWorker):
    """The export worker (export_worker).  Started with flagship_learn's
    worker, it spends its minutes of host time (the traces, the saves, the
    loads) beside the phases that run while the flagship learns; checks()
    then lets it run its card half while this process waits, so no other
    phase shares the card with it."""

    def __init__(self):
        super().__init__("--export-worker", EXPORT_TIMEOUT)

    def checks(self):
        """Wait until the worker has prepared its artifacts, let it run
        the card halves, and return (its records, the seconds waited for
        it to be ready, the seconds of its card halves); raise with its
        log if it fails or outruns EXPORT_TIMEOUT."""
        t0 = time.perf_counter()
        ready = os.path.join(self.work, "ready")
        while not os.path.exists(ready):
            self._poll()
            time.sleep(0.2)
        t1 = time.perf_counter()
        open(os.path.join(self.work, "go"), "w").close()
        self.wait()
        with open(os.path.join(self.work, "export.json")) as f:
            records = json.load(f)
        return records, t1 - t0, time.perf_counter() - t1


class LearnWorker(PhaseWorker):
    """flagship_learn's worker (learn_worker): it trains while this
    process runs the checks from raw_tree_train to the tiny train steps;
    result() waits for it, relays its lines and returns its launches a
    step."""

    def __init__(self):
        super().__init__("--learn-worker", LEARN_TIMEOUT)

    def result(self):
        t0 = time.perf_counter()
        self.wait()
        self.relay()
        with open(os.path.join(self.work, "learn.json")) as f:
            launches = json.load(f)
        emit(dict(phase="learn_worker", wait_s=time.perf_counter() - t0,
                  worker_s=time.perf_counter() - self.t0))
        return launches


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
    has no sparse conv: K5's alone.  In the bf16 model (compute_dtype)
    the strided backward is K4-bf16, the subm one K3 on float32 upcasts,
    and no RoIAlign backward is K5: its tables are bf16, whose cotangent
    takes the plain route (JAX `roi_align.py:122`); the image branch alone
    in bf16 hands the head float32 levels, so K5 stays."""
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
    f32 = model.dtype == torch.float32
    want.update(subm_bwd=n_subm, roi_scatter=iters * f32 * (
        int(lidar_bwd) + int(cfg.use_img)))
    want["strided_bwd" if f32 else "strided_bwd_bf16"] = len(convs) - n_subm
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


def train_phase(phase, cfg, smi, warmup: int = 2, steps: int = 5,
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
    wide = [n for n, p in model.named_parameters()
            if p.dtype != torch.float32]
    if wide:
        raise AssertionError(f"{phase}: parameters not float32: {wide[:4]}")

    busy = device_busy(step)
    parts = {}
    gt = (batch["gt_boxes"], batch["gt_labels"], batch["gt_mask"])
    for _ in range(PARTS_RUNS):
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


def bf16_config(cfg, model: bool = True):
    """cfg in a bf16 mode: the whole model (compute_dtype), or the image
    branch alone (img.compute_dtype)."""
    import dataclasses
    if model:
        return cfg.replace(compute_dtype="bfloat16")
    return cfg.replace(img=dataclasses.replace(cfg.img,
                                               compute_dtype="bfloat16"))


@torch.no_grad()
def bf16_centre_gap(phase, cfg, batch, smi, bar_m: float = 0.5):
    """The bf16 model against the float32 one on the same weights (seed 0)
    and batch: every layer's box centres (metres) and logits apart on
    average, the centres under JAX's bar (tests/test_bf16.py:27-28: a mean
    below 0.5 m); the bf16 boxes float32 and finite."""
    from srfdet3d_torch.models.detector import SRFDet
    dev_batch = {k: v.cuda() for k, v in batch.items()}
    out = {}
    for name, c in (("f32", cfg), ("bf16", bf16_config(cfg))):
        model = SRFDet(c, device="cuda", seed=0)
        out[name] = model(dev_batch)
        del model
    (l32, b32), (l16, b16) = out["f32"], out["bf16"]
    if b16.dtype != torch.float32 or l16.dtype != torch.bfloat16:
        raise AssertionError(f"{phase}: dtypes {l16.dtype}, {b16.dtype}")
    if not (bool(torch.isfinite(b16).all()) and
            bool(torch.isfinite(l16.float()).all())):
        raise AssertionError(f"{phase}: non-finite bf16 outputs")
    gap = float((b16[..., :3] - b32[..., :3]).abs().mean())
    if not gap < bar_m:
        raise AssertionError(f"{phase}: mean centre gap {gap} m")
    emit(dict(phase=phase, config=cfg.name, mean_centre_gap_m=gap,
              max_centre_gap_m=float((b16[..., :3] - b32[..., :3]).abs()
                                     .max()),
              mean_logit_gap=float((l16.float() - l32).abs().mean()),
              bar_m=bar_m, device=smi))


@torch.no_grad()
def tiny_bf16_end_to_end(cfg16, seed: int = 3):
    """A tiny config in a bf16 mode: the kernels on the card (K1-bf16 in
    the bf16 model) against the plain versions on the CPU, same weights
    and points (tiny_end_to_end's).  The two sides round the same ops to
    bf16 but sum in other orders, which flips an ulp here and there; the
    card must sit closer to the CPU's bf16 outputs than those sit from the
    CPU's float32 model, for the logits and the box centres (mean
    absolute distances); boxes float32, outputs finite, launches as the
    structure gives."""
    from srfdet3d_torch.models.detector import SRFDet
    rng = np.random.default_rng(0)
    p, dim = cfg16.points_cap, cfg16.points_dim
    lo, hi = np.array(cfg16.pc_range[:3]), np.array(cfg16.pc_range[3:])
    pts = np.zeros((2, p, dim), np.float32)
    pts[:, :p // 2, :3] = rng.uniform(lo + 1, hi - 1, (2, p // 2, 3))
    pts[:, :p // 2, 3:] = rng.uniform(0, 1, (2, p // 2, dim - 3))
    mask = np.zeros((2, p), bool)
    mask[:, :p // 2] = True
    batch = {"points": torch.from_numpy(pts),
             "points_mask": torch.from_numpy(mask)}
    if cfg16.use_img:
        cams = lc_batch(cfg16, 2, seed=0)
        batch.update(images=cams["images"], lidar2img=cams["lidar2img"])
    cpu = SRFDet(cfg16, device="cpu", seed=seed)
    img = (dataclasses.replace(cfg16.img, compute_dtype="") if cfg16.use_img
           else cfg16.img)
    cfg32 = cfg16.replace(compute_dtype="float32", img=img)
    cpu32 = SRFDet(cfg32, device="cpu", seed=seed)
    gpu = SRFDet(cfg16, device="cuda", seed=seed)
    gpu.load_state_dict(cpu.state_dict())
    cpu32.load_state_dict(cpu.state_dict())
    reset_counts()
    lg, bg = gpu(batch)
    torch.cuda.synchronize()
    counts = read_counts()
    want = predict_launches(gpu)
    if counts != want:
        raise AssertionError(f"tiny bf16 predict {cfg16.name} launched "
                             f"{counts}, its structure gives {want}")
    lc, bc = cpu(batch)
    l32, b32 = cpu32(batch)
    if bg.dtype != torch.float32 or lg.dtype != lc.dtype:
        raise AssertionError(f"tiny bf16 predict: dtypes {lg.dtype}, "
                             f"{bg.dtype}")
    ratios = {}
    for key, got, ref, f32 in (("logits", lg.float().cpu(), lc.float(), l32),
                               ("centres", bg[..., :3].cpu(), bc[..., :3],
                                b32[..., :3])):
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"tiny bf16 predict: non-finite {key}")
        d_card = float((got - ref).abs().mean())
        d_f32 = float((ref - f32).abs().mean())
        ratios[key] = d_card / d_f32
        if not d_card < d_f32:
            raise AssertionError(f"tiny bf16 predict {cfg16.name}: {key} "
                                 f"card-CPU {d_card} vs bf16-f32 {d_f32}")
    emit(dict(phase="tiny_bf16_end_to_end", config=cfg16.name,
              compute_dtype=cfg16.compute_dtype,
              img_compute_dtype=cfg16.img.compute_dtype if cfg16.use_img
              else None, launches=counts, card_over_bf16_gap=ratios))


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
                        ("dfeats", DFEATS_KERNELS, int(need)),
                        ("dw", DW_KERNELS, 2)):
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


def loader_ms(dataset, batch_size: int, batches: int = 4,
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
    CLI) and kitti_data (train, then the test CLI with kitti_eval), on the
    loader's default point route (the C++ one).  Returns the launches a
    step of each train run and the nuScenes and KITTI roots' paths."""
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
    return launches, {"nus": nus, "kitti": kit}


# the host side (srfdet3d_torch/data/native.py, utils/profiling.py,
# tools/create_data.py): the C++ point route against the numpy one on the
# data roots, the flagship step from files profiled three ways, and a raw
# nuScenes tree through create_data into the train CLI

# samples of each root held route against route in data_route
ROUTE_SAMPLES = 4
# data_step_profile: steps a way (StepTimer drops the first STEP_WARMUP),
# and profiled steps after them
STEP_WARMUP, STEP_STEPS, STEP_PROFILED = 2, 5, 1
# the CUDA runtime calls in which the host waits for the card
SYNC_CALLS = ("cudaDeviceSynchronize", "cudaStreamSynchronize",
              "cudaEventSynchronize")
# the raw tree of raw_tree_train: DATA_ROOTS["nus"]'s sizes
RAW_NUS_ROOT = dict(n_train=4, n_val=2, points=34688, sweeps=10, boxes=35)
FLAGSHIP_STEP_LAUNCHES = dict(dict.fromkeys(COUNTED, 0), gather_conv=21,
                              eqmatch=4, subm_bwd=17, strided_bwd=4,
                              roi_scatter=5)


class point_route:
    """Within the block, the data pipeline's point route (SRFDET_POINT_IO)
    is `name`; the earlier setting is restored after."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.saved = os.environ.get("SRFDET_POINT_IO")
        os.environ["SRFDET_POINT_IO"] = self.name

    def __exit__(self, *exc):
        if self.saved is None:
            os.environ.pop("SRFDET_POINT_IO", None)
        else:
            os.environ["SRFDET_POINT_IO"] = self.saved


def data_route(smi, roots, build_s: float, built: bool):
    """The C++ point route (srfdet3d_torch/csrc/pointio.cpp, built with
    g++ at first use: `build_s`, `built` whether this process compiled it)
    against the numpy route on the nuScenes and KITTI data roots of
    data_phases, with the GT-database paste and CBGS as the train CLI
    reads them: the loader's ms a batch on each route at num_workers 4
    (the loader's default) and 1; ROUTE_SAMPLES samples of each root on
    both routes, every key but the points bit for bit, the points as sets
    of rows where the in-range count fits points_cap (KITTI) and by kept
    count where it does not (nuScenes: ~381k points against 262,144)."""
    from srfdet3d_torch.configs import get_config
    from srfdet3d_torch.data import native
    from srfdet3d_torch.tools.train import train_dataset
    t_phase = time.perf_counter()
    out = {}
    for key, batches in (("nus", 6), ("kitti", 2)):
        cfg = get_config(DATA_CONFIGS[key])
        root = roots[key]
        ds = train_dataset(cfg, root["root"], db_info=root["db"])
        ms = {}
        for name in ("numpy", "cpp"):
            with point_route(name):
                for workers in (4, 1):
                    ms[f"{name}_w{workers}"] = loader_ms(ds, 2, batches,
                                                        workers)
        kept, set_equal = [], []
        for i in range(ROUTE_SAMPLES):
            with point_route("numpy"):
                a = ds[i]
            with point_route("cpp"):
                b = ds[i]
            for k in a:
                if k not in ("points", "points_mask") and \
                        not np.array_equal(a[k], b[k]):
                    raise AssertionError(f"data_route {key}: sample {i} "
                                         f"{k} differs between the routes")
            na, nb = int(a["points_mask"].sum()), int(b["points_mask"].sum())
            if na != nb:
                raise AssertionError(f"data_route {key}: sample {i} kept "
                                     f"{na} points on numpy, {nb} on C++")
            kept.append(nb)
            if nb < cfg.points_cap:
                rows = [{r.tobytes() for r in s["points"][s["points_mask"]]}
                        for s in (a, b)]
                if rows[0] != rows[1]:
                    raise AssertionError(f"data_route {key}: sample {i} "
                                         f"keeps other rows on the routes")
                set_equal.append(i)
        out[key] = dict(config=cfg.name, samples=len(ds),
                        loader_ms=ms, points_cap=cfg.points_cap,
                        kept=kept, rows_equal_as_sets=set_equal,
                        kept_count_equal=True)
    emit(dict(phase="data_route", library=str(native.library_path().name),
              build_s=build_s, built_here=built, batch=2, **out,
              seconds=time.perf_counter() - t_phase, device=smi))


def profiled_steps(log_dir, run_steps, steps: int):
    """`steps` steps of run_steps under profiling.trace: a step's device
    busy ms (every kernel and copy), host-to-device copy ms, ms the main
    thread waited in CUDA syncs, the window's wall ms, and the main
    thread's host ms outside those waits."""
    from torch.autograd import DeviceType
    from srfdet3d_torch.utils import profiling
    with profiling.trace(log_dir, "cuda") as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_steps(steps)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = h2d = sync = 0.0
    for e in prof.key_averages():
        if getattr(e, "device_type", None) == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0.0)
            busy += us
            if "HtoD" in e.key:
                h2d += us
        elif e.key in SYNC_CALLS:
            sync += e.cpu_time_total
    n = max(steps, 1)
    return dict(device_busy_ms=busy / 1e3 / n, h2d_ms=h2d / 1e3 / n,
                sync_wait_ms=sync / 1e3 / n, wall_ms=wall / n,
                main_host_ms=(wall - sync / 1e3) / n,
                trace_files=len(os.listdir(log_dir)))


def data_step_profile(smi, roots, tmp: str):
    """The flagship train step at batch 2 from the nuScenes data root,
    three ways in one process after warm-up, each over the same
    STEP_WARMUP + STEP_STEPS batches of the seeded loader order:
    in_memory (the batches collated beforehand, no loader thread during
    the steps), numpy (the loader, 4 threads, on the numpy point route)
    and cpp (the loader on the C++ route).  Each: step p50 (StepTimer,
    synced at each step's end), the wait's share of the loop, the main
    thread's and the process's CPU ms a step (thread_time and
    process_time around the step's work, before its closing sync), then
    STEP_PROFILED more steps under
    profiling.trace: device busy ms, host-to-device copy ms, the ms the
    main thread waited in CUDA syncs and its host ms outside them.  No
    bar on speed; launches a step equal the structure."""
    from srfdet3d_torch.configs import get_config
    from srfdet3d_torch.data import data_loader
    from srfdet3d_torch.models.detector import SRFDet
    from srfdet3d_torch.tools.train import train_dataset
    from srfdet3d_torch.train.trainer import (make_optimizer,
                                              step_generator, train_step)
    from srfdet3d_torch.utils.profiling import StepTimer
    t_phase = time.perf_counter()
    cfg = get_config(DATA_CONFIGS["nus"])
    root = roots["nus"]
    ds = train_dataset(cfg, root["root"], db_info=root["db"])
    model = SRFDet(cfg, device="cuda", seed=0)
    opt = make_optimizer(model, cfg, 1000)
    want = train_launches(model)
    total = STEP_WARMUP + STEP_STEPS + STEP_PROFILED
    count = [0]

    def step(batch):
        train_step(model, opt, {k: torch.from_numpy(v)
                                for k, v in batch.items()},
                   step_generator(model, 0, count[0]))
        count[0] += 1

    loader = data_loader(ds, 2, seed=0)
    held = [next(loader) for _ in range(total)]
    loader.close()
    for b in held[:2]:                   # warm-up: cuDNN's timings
        step(b)
    torch.cuda.synchronize()
    out = {}
    for way in ("in_memory", "numpy", "cpp"):
        # the loader's threads read the route at each sample
        with point_route("cpp" if way == "in_memory" else way):
            it = iter(held) if way == "in_memory" else \
                data_loader(ds, 2, seed=0)
            timer = StepTimer(warmup=STEP_WARMUP, device="cuda")
            waits, main_cpu, proc_cpu = [], [], []
            reset_counts()
            t0 = time.perf_counter()
            for i in range(STEP_WARMUP + STEP_STEPS):
                batch = next(it)
                t1 = time.perf_counter()
                with timer:
                    c0, p0 = time.thread_time(), time.process_time()
                    step(batch)
                    # before the timer's sync, which spins on the CPU
                    c1, p1 = time.thread_time(), time.process_time()
                if i >= STEP_WARMUP:
                    waits.append((t1 - t0) * 1e3)
                    main_cpu.append((c1 - c0) * 1e3)
                    proc_cpu.append((p1 - p0) * 1e3)
                t0 = time.perf_counter()
            check_launches(f"data_step_profile {way}", read_counts(), want,
                           STEP_WARMUP + STEP_STEPS)

            def run_steps(n):
                for _ in range(n):
                    step(next(it))

            prof = profiled_steps(os.path.join(tmp, f"trace_{way}"),
                                  run_steps, STEP_PROFILED)
            if way != "in_memory":
                it.close()
        summary = timer.summary()
        out[way] = dict(step_p50_ms=summary["p50_ms"],
                        step_p90_ms=summary["p90_ms"],
                        step_mean_ms=summary["mean_ms"],
                        wait_share=sum(waits) / (sum(waits) +
                                                 sum(timer.times) * 1e3),
                        wait_p50_ms=statistics.median(waits),
                        main_thread_cpu_ms=statistics.median(main_cpu),
                        process_cpu_ms=statistics.median(proc_cpu),
                        profiled=prof)
    del model, opt, held
    free_cache()
    emit(dict(phase="data_step_profile", config=cfg.name, batch=2,
              steps=STEP_STEPS, warmup=STEP_WARMUP,
              profiled_steps=STEP_PROFILED, loader_workers=4,
              launches_per_step=want, **out,
              seconds=time.perf_counter() - t_phase, device=smi))


def raw_tree_train(smi, tmp: str):
    """A raw nuScenes tree (synthetic_root.write_raw_nuscenes_root at the
    data root's sizes: 4 + 2 keyframes of 34,688 points, 10 sweeps, 35
    instances a scene) through `python -m srfdet3d_torch.tools.create_data
    nuscenes --with-db`, then one train-CLI epoch of the flagship at batch
    2 from the pickles it wrote, with CBGS and the GT-database paste:
    launches a step equal to the structure (K1 21, K2 4, K3 17, K4 4, K5
    5), finite losses, and the run's tb/ event file read back by the
    port's reader (a loss and an lr a step, the last loss the run's)."""
    import srfdet3d_torch
    from srfdet3d_torch.data import synthetic_root
    from srfdet3d_torch.utils.event_file import read_scalars
    t_phase = time.perf_counter()
    root = os.path.join(tmp, "raw_nus")
    t0 = time.perf_counter()
    tree = synthetic_root.write_raw_nuscenes_root(root, **RAW_NUS_ROOT)
    write_s = time.perf_counter() - t0
    repo = os.path.dirname(os.path.dirname(os.path.abspath(
        srfdet3d_torch.__file__)))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "srfdet3d_torch.tools.create_data",
         "nuscenes", "--root", root, "--with-db"], cwd=repo,
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": repo})
    create_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"create_data failed:\n{proc.stderr[-3000:]}")
    frames = {}
    for split in ("train", "val"):
        with open(os.path.join(root, f"nuscenes_infos_{split}.pkl"),
                  "rb") as f:
            frames[split] = len(pickle.load(f))
    db_info = os.path.join(root, "nuscenes_dbinfos_train.pkl")
    with open(db_info, "rb") as f:
        db = pickle.load(f)
    objects = sum(len(v) for v in db.values())
    if frames != {"train": RAW_NUS_ROOT["n_train"],
                  "val": RAW_NUS_ROOT["n_val"]} or not objects:
        raise AssertionError(f"create_data wrote {frames} frames and "
                             f"{objects} db objects")
    name = DATA_CONFIGS["nus"]
    rec, counts, peak = run_train_cli(
        [name, "--data-root", root, "--db-info", db_info, "--batch-size",
         "2", "--epochs", "1", "--log-interval", "1", "--work-dir",
         os.path.join(tmp, "wd_raw")])
    want = train_launches(rec["model"])
    if want != FLAGSHIP_STEP_LAUNCHES:
        raise AssertionError(f"raw_tree_train: structure {want}")
    steps = len(rec["step_ms"])
    check_launches("raw_tree_train", counts, want, steps)
    scalars = read_scalars(rec["event_file"])
    losses = [(s, v) for t, s, v in scalars if t == "loss"]
    lrs = [s for t, s, _ in scalars if t == "lr"]
    if [s for s, _ in losses] != list(range(1, steps + 1)) or \
            lrs != list(range(1, steps + 1)) or \
            losses[-1][1] != np.float32(rec["metrics"]["loss"]):
        raise AssertionError(f"raw_tree_train: event file {scalars[:6]} "
                             f"for {steps} steps, last loss "
                             f"{rec['metrics']['loss']}")
    del rec["model"], rec["opt"]
    free_cache()
    emit(dict(phase="raw_tree_train", config=name,
              raw_root=dict(RAW_NUS_ROOT, version=tree["version"],
                            scenes=tree["scenes"]),
              root_write_s=write_s, create_data_s=create_s,
              frames=frames, db_objects=objects,
              db_classes={k: len(v) for k, v in sorted(db.items())},
              batch=2, **step_stats(rec), peak_gb=peak,
              launches_per_step=want, event_scalars=len(scalars),
              losses=rec["metrics"], seconds=time.perf_counter() - t_phase,
              device=smi))


# the three configs of convert_roundtrip: the flagship, the headline LC
# fine-tune (VoVNet-99) and Waymo LC (ResNet-101 with DCNv2, a BN image
# neck, the dynamic VFE)
CONVERT_CONFIGS = ("srfdet_voxel_nusc_L", "srfdet_voxel_nusc_LC",
                   "srfdet_dvoxel_waymo_LC")
# the port's names of a head iteration's modules -> the reference's
# (SingleSRFDetHeadLiDAR's attributes carry the _lidar suffix)
_HEAD_REF = {"norm_attn": "norm1_lidar", "norm_inst": "norm2_lidar",
             "norm_ffn": "norm3_lidar", "ffn1": "linear1_lidar",
             "ffn2": "linear2_lidar", "class_logits": "class_logits_lidar",
             "bboxes_delta": "bboxes_delta_lidar",
             "output_fused_proj": "output_fused_proj"}


def _encoder_ref_names(cfg):
    """The sparse encoder's port module -> (the reference's
    SparseSequential or SparseBasicBlock, the conv's index in a block: 0
    for a SparseSequential (conv .0, BN .1), 1 or 2 for conv1 / conv2)."""
    mc = cfg.middle
    names = {"conv_input": ("conv_input", 0), "conv_out": ("conv_out", 0)}
    last = len(mc.encoder_channels) - 1
    for i, blocks in enumerate(mc.encoder_channels):
        for j in range(len(blocks)):
            tm = f"encoder_layers.encoder_layer{i + 1}.{j}"
            if mc.block_type == "conv_module":
                names[f"down{i}" if i and not j else f"subm{i}_{j}"] = (tm, 0)
            elif j == len(blocks) - 1 and i != last:
                names[f"down{i}"] = (tm, 0)
            else:
                for k in (1, 2):
                    names[f"bb{i}_{j}_conv{k}"] = (tm, k)
    return names


def reference_checkpoint(model):
    """The port model's weights in the reference's mm-stack module names
    and layouts, as a released .pth holds them: spconv weights in 'KIO'
    (kz, ky, kx, in, out), SECOND's first conv on the reference's c*D + d
    BEV channels, MultiheadAttention's fused in_proj, DCNv2 weights
    (Cout, Cin, kh, kw), the BN step counters kept.  The inverse of
    srfdet3d_torch.utils.torch_convert (the JAX package has no exporter:
    this half of the round trip lives here).  CPU tensors."""
    import re
    from srfdet3d_torch.utils.torch_convert import (_encoder_out_depth,
                                                    bev_in_perm)
    cfg = model.cfg
    enc = _encoder_ref_names(cfg) if cfg.middle.kind == "sparse" else {}
    second = [(s, j) for s, n in enumerate(cfg.backbone.layer_nums)
              for j in range(n + 1)]
    num_ins = {"pts_neck": len(cfg.backbone.out_channels), "img_neck": 4}
    out, qkv = {}, {}
    for key, t in model.state_dict().items():
        t = t.detach().cpu()
        top, _, rest = key.partition(".")
        ref = None
        if top == "pts_voxel_encoder":
            src = "vfe_layers" if cfg.vfe.kind == "dynamic" else "pfn_layers"
            m = re.fullmatch(r"layers\.(\d+)\.(linear|bn)\.(\w+)", rest)
            if m:
                sub = "linear" if m[2] == "linear" else "norm"
                ref = f"{top}.{src}.{m[1]}.{sub}.{m[3]}"
            m = re.fullmatch(r"centroid_(fc|bn)([12])\.(\w+)", rest)
            if m:
                idx = (0 if m[1] == "fc" else 1) + 3 * (int(m[2]) - 1)
                ref = f"{top}.cen2point_pos_enc.{idx}.{m[3]}"
        elif top == "pts_middle_encoder":
            name, _, leaf = rest.partition(".")
            tm, k = enc[name]
            if leaf == "kernel":
                taps = (3, 3, 3) if t.shape[0] == 27 else (3, 1, 1)
                t = t.reshape(taps + tuple(t.shape[1:]))
                ref = f"{top}.{tm}.{f'conv{k}' if k else '0'}.weight"
            else:
                ref = f"{top}.{tm}.{f'bn{k}' if k else '1'}.{leaf[3:]}"
        elif top == "pts_backbone":
            m = re.fullmatch(r"blocks\.(\d+)\.(conv|bn)\.(\w+)", rest)
            s, j = second[int(m[1])]
            if m[2] == "conv" and int(m[1]) == 0 and \
                    cfg.middle.kind == "sparse":
                perm = torch.from_numpy(bev_in_perm(
                    _encoder_out_depth(cfg), cfg.middle.output_channels))
                w = torch.empty_like(t)
                w[:, perm] = t
                t = w
            ref = f"{top}.blocks.{s}.{3 * j + (m[2] == 'bn')}.{m[3]}"
        elif top in num_ins:
            m = re.fullmatch(r"(lateral|fpn|extra)\.(\d+)\.(conv|bn)\.(\w+)",
                             rest)
            i = int(m[2])
            mod = {"lateral": f"lateral_convs.{i}", "fpn": f"fpn_convs.{i}",
                   "extra": f"fpn_convs.{num_ins[top] + i}"}[m[1]]
            ref = f"{top}.{mod}.{m[3]}.{m[4]}"
        elif top == "img_backbone" and cfg.img.backbone.startswith("vovnet"):
            m = re.fullmatch(r"stem(\d)\.(conv|bn)\.(\w+)", rest)
            if m:
                sub = "conv" if m[2] == "conv" else "norm"
                ref = f"{top}.stem.stem_{m[1]}/{sub}.{m[3]}"
            m = re.fullmatch(r"stages\.(\d+)\.(\d+)\.(convs\.(\d+)|concat|ese)"
                             r"\.(conv|bn|fc)\.(\w+)", rest)
            if m:
                s, b = int(m[1]) + 2, int(m[2]) + 1
                pre = f"{top}.stage{s}.OSA{s}_{b}"
                sub = "conv" if m[5] == "conv" else "norm"
                if m[3] == "ese":
                    ref = f"{pre}.ese.fc.{m[6]}"
                elif m[3] == "concat":
                    ref = f"{pre}.concat.OSA{s}_{b}_concat/{sub}.{m[6]}"
                else:
                    ref = (f"{pre}.layers.{m[4]}.OSA{s}_{b}_{m[4]}/{sub}"
                           f".{m[6]}")
        elif top == "img_backbone":
            m = re.fullmatch(r"layers\.(\d+)\.(\d+)\.(.+)", rest)
            if rest.startswith(("conv1.", "bn1.")):
                ref = key
            elif m:
                pre = f"{top}.layer{int(m[1]) + 1}.{m[2]}"
                part = m[3]
                mm = re.fullmatch(r"(conv\d|down)\.(conv|bn)\.(\w+)", part)
                if part == "dcn2.kernel":          # (9 Cin, Cout) tap-major
                    cout = t.shape[1]
                    t = t.reshape(3, 3, -1, cout).permute(3, 2, 0, 1)
                    ref = f"{pre}.conv2.weight"
                elif part.startswith(("dcn2.conv_offset.", "bn2.")):
                    ref = f"{pre}.{part.replace('dcn2.', 'conv2.')}"
                elif mm and mm[1] == "down":
                    ref = (f"{pre}.downsample.{0 if mm[2] == 'conv' else 1}"
                           f".{mm[3]}")
                elif mm:
                    n = mm[1][-1]
                    ref = (f"{pre}.conv{n}.{mm[3]}" if mm[2] == "conv"
                           else f"{pre}.bn{n}.{mm[3]}")
        elif top == "bbox_head":
            m = re.fullmatch(r"heads\.(\d+)\.(\w+)\.(.+)", rest)
            if rest in ("init_proposal_boxes", "init_proposal_feats"):
                ref = f"{key}.weight"
            elif re.fullmatch(r"dpg_dw(_img)?\.\d+\..+", rest):
                mod, lvl, leaf = rest.split(".", 2)
                kind = "img" if mod.endswith("_img") else "lidar"
                ref = f"{top}.dpg_dw_convs_{kind}.{lvl}.{leaf}"
            elif re.fullmatch(r"dpg_fc[12]\.\w+", rest):
                mod, leaf = rest.split(".")
                ref = f"{top}.{mod}_lidar.{leaf}"
            elif re.fullmatch(r"dpg_fc[12]_img\.\w+", rest):
                ref = key
            elif rest.startswith("img_conv."):
                ref = f"{top}.img_convs.{rest[len('img_conv.'):]}"
            elif m:
                pre = f"{top}.head_series_lidar.{m[1]}"
                mod, part = m[2], m[3]
                tower = re.fullmatch(r"(fcs|norms)\.(\d+)\.(\w+)", part)
                if mod == "self_attn" and part.startswith(
                        ("q_proj", "k_proj", "v_proj")):
                    proj, leaf = part.split(".")
                    qkv.setdefault((pre, leaf), {})[proj] = t
                    continue
                if mod == "self_attn":
                    ref = f"{pre}.self_attn_lidar.{part}"
                elif mod == "inst_interact":
                    ref = f"{pre}.inst_interact_lidar.{part}"
                elif mod in ("cls_fcs", "cls_norms", "reg_fcs", "reg_norms"):
                    tw, kind = mod.split("_")
                    k, leaf = part.split(".")
                    idx = 3 * int(k) + (kind == "norms")
                    ref = f"{pre}.{tw}_module_lidar.{idx}.{leaf}"
                else:
                    ref = f"{pre}.{_HEAD_REF[mod]}.{part}"
        if ref is None:
            raise KeyError(f"no reference name for the port's {key}")
        out[ref] = t.contiguous()
    for (pre, leaf), parts in qkv.items():
        out[f"{pre}.self_attn_lidar.in_proj_{leaf}"] = torch.cat(
            [parts["q_proj"], parts["k_proj"], parts["v_proj"]])
    return out


def convert_roundtrip(smi, tmp: str):
    """A seeded port model A (CONVERT_CONFIGS, full width; Waymo LC with
    seeded DCNv2 offsets) in the reference's names and layouts
    (reference_checkpoint, spconv KIO), saved as mmdet writes a release
    ({"state_dict": module.-prefixed, "meta"}); the port's convert CLI
    reads it and the test CLI's load path (load_for_eval) loads its output
    into a fresh model B: B's weights equal A's bit for bit and B's predict
    on the card (decoded at TEST_OPTIONS' score_thr 0) equals A's on the
    phase's synthetic batch (valid masks and labels identical, boxes and
    scores within 1e-6; A's own second predict beside it), with launches
    equal to the structure.  Returns the launches of each predict."""
    from srfdet3d_torch.configs import get_config
    from srfdet3d_torch.models.detector import SRFDet
    from srfdet3d_torch.tools import convert_checkpoint
    from srfdet3d_torch.tools.train import apply_cfg_options
    from srfdet3d_torch.utils.checkpoint import load_for_eval
    launches = {}
    for name in CONVERT_CONFIGS:
        t_phase = time.perf_counter()
        # decode at score_thr 0: random weights score near the focal prior
        cfg = apply_cfg_options(get_config(name), TEST_OPTIONS)
        batch = (lc_batch(cfg, 1, seed=0) if cfg.use_img
                 else synthetic_batch(cfg, 1, seed=0))
        a = SRFDet(cfg, device="cuda", seed=11)
        dcn = seed_dcn_offsets(a)
        out_a = a.predict(batch)
        again = a.predict(batch)
        t0 = time.perf_counter()
        ref = reference_checkpoint(a)
        pth = os.path.join(tmp, f"{name}.pth")
        torch.save({"state_dict": {f"module.{k}": v for k, v in ref.items()},
                    "meta": {"epoch": 20}}, pth)
        export_s = time.perf_counter() - t0
        out = os.path.join(tmp, f"{name}_port.pt")
        t0 = time.perf_counter()
        meta = convert_checkpoint.main([name, pth, out,
                                        "--spconv-layout", "KIO"])
        convert_s = time.perf_counter() - t0
        b = SRFDet(cfg, device="cuda", seed=12)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        load_for_eval(out, b)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        sa, sb = a.state_dict(), b.state_dict()
        differ = [k for k in sa if not k.endswith("num_batches_tracked")
                  and not torch.equal(sa[k], sb[k])]
        if differ or meta["unset_port_tensors"]:
            raise AssertionError(
                f"convert_roundtrip {name}: weights differ at {differ[:4]}, "
                f"{meta['unset_port_tensors']} tensors unset")
        want = predict_launches(b)
        reset_counts()
        out_b = b.predict(batch)
        counts = read_counts()
        check_launches(f"convert_roundtrip {name}", counts, want, 1)
        launches[name] = counts

        def worst(x, y):
            return max(float((x[k] - y[k]).abs().max())
                       for k in ("boxes", "scores"))
        err, own = worst(out_a, out_b), worst(out_a, again)
        if not all(torch.equal(out_a[k], out_b[k])
                   for k in ("valid", "labels")) or err > 1e-6 or \
                not all_finite(out_b) or not bool(out_b["valid"].any()):
            raise AssertionError(f"convert_roundtrip {name}: B's predict "
                                 f"differs from A's by {err}")
        emit(dict(phase="convert_roundtrip", config=name,
                  pth_mb=os.path.getsize(pth) / 1e6,
                  reference_tensors=len(ref), port_tensors=meta["tensors"],
                  unused_reference_keys=meta["unused_reference_keys"],
                  dcn_offset_convs=dcn, export_s=export_s,
                  convert_s=convert_s, load_s=load_s,
                  valid=int(out_b["valid"].sum()), max_abs_diff=err,
                  a_rerun_max_abs_diff=own, launches=counts,
                  seconds=time.perf_counter() - t_phase, device=smi))
        del a, b, sa, sb, ref
        for path in (pth, out):
            os.remove(path)
        free_cache()
    return launches


class RepeatFrames:
    """`dataset`'s frames in turn, `length` samples: one loader pass over
    a whole training run, so the loader's prefetch spans every step."""

    def __init__(self, dataset, length: int):
        self.dataset, self.length = dataset, length

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, i: int):
        return self.dataset[i % len(self.dataset)]


# flagship_learn: two nuScenes keyframes of 34,688 points, one box of each
# class a frame with 400 points planted in each (every box a GT), no
# sweeps: the writer's sweeps are uniform noise (a real sweep repeats the
# scene's surfaces).  With 10 of them the points occupy ~262k voxels,
# over voxels_cap (120,000), and the voxelizer keeps the smallest
# plan-major keys: the boxes in the upper half of y never reach the model;
# with 2, a large box's centre was still 1.4-1.6 m off after 400 steps in
# one run of four (bench/learn_sweep.py, PERF.md).  Steps at batch 2
# (both frames) with the test pipeline's transforms and the config's AdamW
# at lr 1e-3: at its own 2e-4 a proposal still memorising another frame's
# box (21 m off) scored 0.026 under the top box; 20 warm-up steps, where
# the config's 2,000 would outlast the run
LEARN_ROOT = dict(n_train=2, n_val=0, points=34688, sweeps=0, boxes=10,
                  per_box=400, db_per_class=0, seed=3)
LEARN_STEPS = 400
LEARN_OPTIONS = ("optim.lr=0.001", "optim.warmup_iters=20")
# seconds the learn worker may take from its start to its end
LEARN_TIMEOUT = 700


def learn_eval(name, root, ckpt, tag, tmp):
    """The test CLI on the learning root's train frames (score_thr 0) from
    `ckpt`: the metrics, the dumped frames, the launches against the
    structure."""
    from srfdet3d_torch.tools import test as test_cli
    dump = os.path.join(tmp, f"learn_{tag}.pkl")
    reset_counts()
    t0 = time.perf_counter()
    res = test_cli.main([name, ckpt, "--data-root", root["root"],
                         "--ann-file", root["train"], "--batch-size", "1",
                         "--out", dump, "--device", "cuda", "--cfg-options",
                         *TEST_OPTIONS])
    ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    with open(dump, "rb") as f:
        frames = pickle.load(f)
    return res, frames, counts, ms


class deterministic_cudnn:
    """Within the block cuDNN runs its deterministic algorithms, chosen by
    its heuristics (no cudnn.benchmark timing, whose choice can differ
    from run to run); the earlier flags are restored after."""

    def __enter__(self):
        self.saved = (torch.backends.cudnn.deterministic,
                      torch.backends.cudnn.benchmark)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False

    def __exit__(self, *exc):
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = self.saved


def flagship_learn(smi, tmp: str, options=LEARN_OPTIONS,
                   steps: int = LEARN_STEPS, phase: str = "flagship_learn",
                   planted: dict = LEARN_ROOT):
    """_flagship_learn with cuDNN deterministic (deterministic_cudnn): the
    phase's outcome then varies between runs only through the float
    atomics of the port's kernels and PyTorch's scatters."""
    with deterministic_cudnn():
        return _flagship_learn(smi, tmp, options, steps, phase, planted)


def _flagship_learn(smi, tmp: str, options, steps: int, phase: str,
                    planted: dict):
    """The flagship at full width learns planted boxes on the card: a
    seeded root (`planted`: write_nuscenes_root's arguments), training
    through the port's dataset (test pipeline: no paste, no random flips
    or rotations), loader and train_step, the test CLI's nuScenes
    evaluator on the same two frames before (the seeded random weights)
    and after.  Passes when the last
    step's loss is at most half the first's, mAP after >= max(100 x the
    random weights', 0.01), and each frame's top-scored box lies within 1 m
    BEV of a planted centre; launches equal the structure, every step and
    frame.  Returns the train step's launches."""
    from srfdet3d_torch.configs import get_config
    from srfdet3d_torch.data import NuScenesDataset, data_loader
    from srfdet3d_torch.data import synthetic_root
    from srfdet3d_torch.models.detector import SRFDet
    from srfdet3d_torch.tools.train import apply_cfg_options
    from srfdet3d_torch.train.trainer import (make_optimizer,
                                              step_generator, train_step)
    from srfdet3d_torch.utils.checkpoint import save_checkpoint
    t_phase = time.perf_counter()
    name = "srfdet_voxel_nusc_L"
    cfg = apply_cfg_options(get_config(name), options)
    root = synthetic_root.write_nuscenes_root(os.path.join(tmp, phase),
                                              **planted)
    ds = NuScenesDataset(cfg, info_path=root["train"], data_root=root["root"],
                         test_mode=False, augment=False)
    model = SRFDet(cfg, device="cuda", seed=0)
    opt = make_optimizer(model, cfg, steps)
    init = os.path.join(tmp, f"{phase}_init.pt")
    save_checkpoint(init, model)
    before, _, counts, before_ms = learn_eval(name, root, init, "init", tmp)
    frames = len(ds)
    check_launches(f"{phase} eval", counts, predict_launches(model), frames)

    losses, step_ms = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t_train = time.perf_counter()
    loader = data_loader(RepeatFrames(ds, 2 * steps), 2, shuffle=False)
    for step, batch in enumerate(loader):
        t0 = time.perf_counter()
        metrics = train_step(model, opt, {k: torch.from_numpy(v)
                                          for k, v in batch.items()},
                             step_generator(model, 0, step))
        losses.append(float(metrics["loss"]))          # syncs
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if step == 0:       # the learned proposal boxes get a gradient
            grad = model.bbox_head.init_proposal_boxes.grad
            init_grad = None if grad is None else float(grad.norm())
        if not math.isfinite(losses[-1]):
            raise AssertionError(f"{phase}: loss {losses[-1]} at step {step}")
        if step % 25 == 0 or step == steps - 1:
            emit(dict(phase=f"{phase}_loss", step=step, loss=losses[-1],
                      lr=opt.schedule(step)))
    train_s = time.perf_counter() - t_train
    peak = torch.cuda.max_memory_allocated() / 1e9
    want = train_launches(model)
    check_launches(phase, read_counts(), want, len(losses))
    trained = os.path.join(tmp, f"{phase}_trained.pt")
    save_checkpoint(trained, model)
    after, dump, counts, after_ms = learn_eval(name, root, trained, "trained",
                                               tmp)
    check_launches(f"{phase} eval", counts, predict_launches(model), frames)
    # each frame's top-scored box against the boxes planted in it (the
    # info's, in the dump's order: the test CLI does not shuffle); the five
    # best with their class, score and nearest planted box beside it
    top_err, top5 = [], []
    for info, pred in zip(ds.infos, dump["preds"]):
        order = np.argsort(-pred["scores"], kind="stable")[:5]
        rows = []
        for i in order:
            dist = np.linalg.norm(info["gt_boxes"][:, :2] -
                                  pred["boxes"][i, :2], axis=1)
            near = int(dist.argmin())
            rows.append(dict(label=str(pred["labels_name"][i]),
                             score=float(pred["scores"][i]),
                             bev_err_m=float(dist[near]),
                             nearest=str(info["gt_names"][near])))
        top5.append(rows)
        top_err.append(rows[0]["bev_err_m"] if rows else math.inf)
    bar = max(100 * before["mAP"], 0.01)
    ok = (losses[-1] <= 0.5 * losses[0] and after["mAP"] >= bar and
          len(top_err) == frames and max(top_err) < 1.0)
    emit(dict(phase=phase, config=name, options=options, lr=cfg.optim.lr,
              steps=len(losses),
              frames=frames, planted_per_box=planted["per_box"],
              gt_per_frame=[len(g["boxes"]) for g in dump["gts"]],
              loss_first=losses[0], loss_last=losses[-1],
              loss_every_25=losses[::25] + losses[-1:],
              map_random=before["mAP"], nds_random=before["NDS"],
              map_trained=after["mAP"], nds_trained=after["NDS"],
              map_bar=bar, top_box_bev_err_m=top_err, top5=top5,
              init_proposal_boxes_grad_norm=init_grad,
              step_p50_ms=statistics.median(step_ms), train_s=train_s,
              eval_ms=[before_ms, after_ms], peak_gb=peak,
              launches_per_step=want, passed=ok,
              cudnn=dict(deterministic=torch.backends.cudnn.deterministic,
                         benchmark=torch.backends.cudnn.benchmark),
              seconds=time.perf_counter() - t_phase, device=smi))
    if not ok:
        raise AssertionError(f"{phase}: did not learn: loss {losses[0]} -> "
                             f"{losses[-1]}, mAP {before['mAP']} -> "
                             f"{after['mAP']} (bar {bar}), top boxes "
                             f"{top_err} m off")
    return want


# data parallelism (srfdet3d_torch/parallel): the flagship's step on two
# ranks that share the card over gloo, against one process on the whole
# batch; an NCCL group of one; the launchers dist_train.sh and dist_test.sh

# two ranks at batch 2 each, against one process at batch 4, for DDP_STEPS
# steps; dropout off, as the JAX package's DP test runs it (each rank's
# masks fold in its rank, one process draws others)
DDP_RANK_BATCH, DDP_WORLD, DDP_STEPS = 2, 2, 3
# every subprocess of the DDP phases is killed at this many seconds
DDP_TIMEOUT = 300
# the tolerances of the DDP phases' steps, 2 ranks or an NCCL group of
# one against one process without a group, each step from the same
# state (the first from the seeded weights, each later one from rank
# 0's parameters, buffers and AdamW moments), the one process playing
# back the ranks' discrete decisions (Decisions).  At the flagship's
# random weights a rounding in the forward flips some ReLU inputs, and
# the flips alone moved the step-0 grads by 6.4-6.7% (PERF.md §6);
# played back, what remains is rounding: the ranks sum BN statistics,
# normalizers and grads in halves, the synced BatchNorm2d takes flax's
# mean-of-squares variance where cuDNN takes its own, each process times
# its own cuDNN algorithms, and the card's float atomics.  That rounding
# still moves the grads by 0.1-0.9% (|g - g_ref| / |g_ref|; a leaf's by
# up to 1.8% of its largest): the DPG's mixture softmax is saturated at
# these weights (logits up to 262), and its backward turns a 3e-4 change
# of its cotangent into a 4e-3 change of the logits' grad, which reaches
# every LiDAR leaf through the DPG staircase and the BEV neck.  A missing
# sync in the forward moves the losses by 1e-2 or more (half-batch BN
# statistics or normalizers), a missing or doubled grad all-reduce the
# grads by 50-100%; the exact semantics are held on the CPU
# (tests/test_torch_port_ddp.py, _sync_bn.py).  The flips each step are
# reported.
DDP_LOSS_RTOL = 2e-4          # each loss
DDP_GRAD_RTOL = 2e-2          # grad_norm, and |g - g_ref| / |g_ref|
DDP_LEAF_TOL = 5e-2           # the worst leaf's |g - g_ref| over its largest


def grad_errors(got, ref, sizes, names):
    """(|got - ref| / |ref|, the worst leaf's max |diff| over
    max(its largest |grad|, 1e-3 x the tree's), that leaf) of two flat
    grad vectors."""
    tree_max = float(ref.abs().max())
    worst, worst_leaf = 0.0, None
    for name, a, b in zip(names, torch.split(got, sizes),
                          torch.split(ref, sizes)):
        err = float((a - b).abs().max()) / max(float(b.abs().max()),
                                                1e-3 * tree_max)
        if err > worst:
            worst, worst_leaf = err, name
    return float((got - ref).norm() / ref.norm()), worst, worst_leaf


def ddp_config():
    from srfdet3d_torch.configs import srfdet_voxel_nusc_L
    cfg = srfdet_voxel_nusc_L()
    return cfg.replace(head=dataclasses.replace(cfg.head, dropout=0.0))


def ddp_batch(cfg):
    """The global batch: DDP_WORLD x DDP_RANK_BATCH rows of the synthetic
    scene with GT."""
    return synthetic_batch(cfg, DDP_WORLD * DDP_RANK_BATCH, seed=0,
                           with_gt=True)


class Decisions:
    """The train step's discrete decisions, recorded, and played back where
    asked: the branch of every kink and choice whose side a rounding can
    change.  Each ReLU's mask (F.relu), each RoI's FPN level
    (roi_align._level_geometry), each bilinear sample's corner cell and
    out-of-map flag along each axis (roi_align._axis_corners), the OTA
    matches (losses.ota_assign_batch), which box corners bound each BEV
    RoI (head.lidar_rois_from_boxes) and which refined centers and sizes
    are clipped (SingleSRFDetHead.apply_deltas), in call order.  At the
    flagship's random weights a rounding in the forward flips some of
    them, and a flip moves the step's grads by percents (one ReLU input
    within a rounding of zero carries its element's whole gradient); a
    run that plays back another run's decisions takes the same branch of
    each, so that what remains between the two is rounding.  `replay`:
    {kind: [tensor a call]} (kinds not named run as they are).  `calls`
    keeps every call's own decisions, played back or not, on the device;
    take() moves them to the host.  `blocks` tags each call made inside
    a refinement iteration (SingleSRFDetHead.forward) with its (B, n_p)
    proposals, a model rank's block under proposal sharding, and every
    other call (the encoder, the DPG, the assignment) with None
    (joined_decisions joins the model ranks by it)."""

    KINDS = ("level", "corners", "ota", "relu", "extreme", "clip")
    # the batch axis of each kind's record (joined_decisions)
    BATCH_AXIS = dict(level=0, corners=1, ota=1, relu=0, extreme=1, clip=1)

    def __init__(self, replay=None):
        import torch.nn.functional as F
        from srfdet3d_torch.models import head, losses
        from srfdet3d_torch.ops import roi_align
        self.roi_align, self.losses, self.F, self.head = (roi_align, losses,
                                                          F, head)
        self.orig = (roi_align._level_geometry, roi_align._axis_corners,
                     losses.ota_assign_batch, F.relu,
                     head.lidar_rois_from_boxes,
                     head.SingleSRFDetHead.apply_deltas,
                     head.SingleSRFDetHead.forward)
        self.replay = {k: list(v) for k, v in (replay or {}).items()}
        self.calls = {k: [] for k in self.KINDS}
        self.blocks = {k: [] for k in self.KINDS}
        self.block = None
        roi_align._level_geometry = self._level
        roi_align._axis_corners = self._corners
        losses.ota_assign_batch = self._ota
        F.relu = self._relu
        head.lidar_rois_from_boxes = self._rois
        head.SingleSRFDetHead.apply_deltas = \
            lambda mod, d, b: self._apply_deltas(mod, d, b)
        head.SingleSRFDetHead.forward = \
            lambda mod, *a, **k: self._iteration(mod, *a, **k)

    def close(self):
        (self.roi_align._level_geometry, self.roi_align._axis_corners,
         self.losses.ota_assign_batch, self.F.relu,
         self.head.lidar_rois_from_boxes,
         self.head.SingleSRFDetHead.apply_deltas,
         self.head.SingleSRFDetHead.forward) = self.orig

    def _iteration(self, mod, *args, **kwargs):
        """A refinement iteration, its calls tagged with its proposals'
        (B, n_p)."""
        outer, self.block = self.block, tuple(args[1].shape[:2])
        try:
            return self.orig[6](mod, *args, **kwargs)
        finally:
            self.block = outer

    def _next(self, kind, device):
        self.blocks[kind].append(self.block)
        if kind not in self.replay:
            return None
        if not self.replay[kind]:
            raise AssertionError(f"Decisions: no {kind} call left to play")
        return self.replay[kind].pop(0).to(device)

    def _level(self, shapes, rois, strides, finest_scale):
        out = self.orig[0](shapes, rois, strides, finest_scale)
        self.calls["level"].append(out[0].detach().clone())
        lvl = self._next("level", rois.device)
        if lvl is None:
            return out
        # the level's scale, extent and row offset, as _level_geometry
        # computes them
        dev = rois.device
        sizes = [h * w for h, w in shapes]
        hs = torch.tensor([float(h) for h, _ in shapes], device=dev)
        ws = torch.tensor([float(w) for _, w in shapes], device=dev)
        scales = torch.tensor([1.0 / s for s in strides],
                              dtype=torch.float32, device=dev)
        offsets = torch.tensor([sum(sizes[:i]) for i in range(len(shapes))],
                               device=dev)
        return lvl, scales[lvl], hs[lvl], ws[lvl], offsets[lvl]

    def _corners(self, pos, size):
        out = self.orig[1](pos, size)
        self.calls["corners"].append(torch.stack(
            [out[0], out[4].long()]).to(torch.int32))
        rec = self._next("corners", pos.device)
        if rec is None:
            return out
        # the recorded cell and flag, the weights linear in pos about that
        # cell, as _axis_corners computes them
        size = size[:, None]
        c0, oob = rec[0].float(), rec[1].bool()
        lc = torch.minimum(pos.clamp_min(0.0), size - 1.0) - c0
        c1 = torch.minimum(c0 + 1, size - 1.0)
        edge = c0 >= size - 1.0
        w0 = torch.where(oob, 0.0, torch.where(edge, 1.0, 1.0 - lc))
        w1 = torch.where(oob, 0.0, torch.where(edge, 0.0, lc))
        return c0.long(), c1.long(), w0, w1, oob

    def _ota(self, *args, **kwargs):
        out = self.orig[2](*args, **kwargs)
        self.calls["ota"].append(out.detach().clone())
        rec = self._next("ota", out.device)
        return out if rec is None else rec

    def _relu(self, x, inplace=False):
        self.calls["relu"].append(x > 0)
        rec = self._next("relu", x.device)
        if rec is None:
            return self.orig[3](x, inplace)
        return torch.where(rec, x, 0.0)

    def _rois(self, boxes_abs, pc_range, voxel_size):
        """lidar_rois_from_boxes, its extreme corners recorded (and played
        back through a gather)."""
        from srfdet3d_torch.geometry.boxes import boxes3d_to_corners3d
        corners = boxes3d_to_corners3d(boxes_abs[..., :8],
                                       bottom_center=False,
                                       yaw_as_sincos=True, log_size=True)
        lo = boxes_abs.new_tensor(pc_range[:2])
        vs = boxes_abs.new_tensor(voxel_size[:2])
        xy = (corners[..., :2] - lo) / vs
        self.calls["extreme"].append(torch.stack(
            [xy.argmin(-2), xy.argmax(-2)]).to(torch.int8))
        rec = self._next("extreme", xy.device)
        if rec is None:
            return self.orig[4](boxes_abs, pc_range, voxel_size)
        pick = [xy.gather(-2, i.long().unsqueeze(-2)).squeeze(-2)
                for i in rec]
        return torch.cat(pick, -1)

    def _apply_deltas(self, mod, d, b):
        """SingleSRFDetHead.apply_deltas, its clipped centers and sizes
        recorded (and played back)."""
        lo = b.new_tensor(mod.pc_range[:3])
        hi = b.new_tensor(mod.pc_range[3:6])
        raw = (b[..., 0:3] + d[..., 0:3] * torch.exp(b[..., 3:6]) - lo) / \
            (hi - lo)
        size = d[..., 3:6]
        self.calls["clip"].append(torch.stack(
            [raw < 0.0, raw > 1.0, size > mod.scale_clamp]))
        rec = self._next("clip", d.device)
        if rec is None:
            return self.orig[5](mod, d, b)
        low, high, big = rec
        ctr = torch.where(low, 0.0, torch.where(high, 1.0, raw))
        new_sizes = b[..., 3:6] + torch.where(big, mod.scale_clamp, size)
        return torch.cat([ctr, new_sizes, d[..., 6:]], -1)

    def take(self):
        """The calls since the last take, on the host, and their blocks."""
        out = {k: [t.cpu() for t in v] for k, v in self.calls.items()}
        out["blocks"] = self.blocks
        self.calls = {k: [] for k in self.KINDS}
        self.blocks = {k: [] for k in self.KINDS}
        return out


def decision_flips(a, b):
    """How many decisions differ between two runs' records of one step
    (take()'s dicts), by kind (a sample's corner counts once, for its cell
    or its flag), and the slots of each."""
    out = {}
    for kind in Decisions.KINDS:
        if len(a[kind]) != len(b[kind]):
            raise AssertionError(f"{kind}: {len(a[kind])} calls against "
                                 f"{len(b[kind])}")
        diff = [(x != y).reshape(x.shape[0], -1).any(0) if kind == "corners"
                else x != y for x, y in zip(a[kind], b[kind])]
        out[kind] = int(sum(int(d.sum()) for d in diff))
        out[kind + "_slots"] = int(sum(d.numel() for d in diff))
    return out


def joined_decisions(per_rank, n_model: int = 1):
    """The global batch's decisions from each rank's record of one step,
    rank by rank along each kind's batch axis (ranks hold contiguous
    rows).  With n_model > 1 the ranks are a (data, model) grid in world
    order: each data index's model ranks are joined first
    (joined_blocks), then the data indices along the batch."""
    if n_model > 1:
        per_rank = [joined_blocks(per_rank[d:d + n_model])
                    for d in range(0, len(per_rank), n_model)]
    return {kind: [torch.cat(parts, Decisions.BATCH_AXIS[kind])
                   for parts in zip(*(r[kind] for r in per_rank))]
            for kind in Decisions.KINDS}


def joined_blocks(per_block):
    """One data index's decisions from its model ranks' records: a call
    inside a refinement iteration (Decisions.blocks) joins the blocks
    along the proposal axis within each sample's rows; every other call
    is replicated on the model ranks and taken from model rank 0."""
    out = {}
    for kind in Decisions.KINDS:
        ax = Decisions.BATCH_AXIS[kind]
        calls = []
        for i, parts in enumerate(zip(*(r[kind] for r in per_block))):
            block = per_block[0]["blocks"][kind][i]
            if block is None:
                calls.append(parts[0])
                continue
            b, n = block
            shape = tuple(parts[0].shape)
            if kind in ("extreme", "clip"):        # (.., B, n_p, ..)
                calls.append(torch.cat(parts, ax + 1))
                continue
            if shape[ax] != b * n:                 # rows (B * n_p, ...)
                raise AssertionError(f"{kind} call {i}: {shape[ax]} rows, "
                                     f"not {b} x {n} proposals")
            split = [p.reshape(shape[:ax] + (b, n) + shape[ax + 1:])
                     for p in parts]
            calls.append(torch.cat(split, ax + 1).reshape(
                shape[:ax] + (-1,) + shape[ax + 1:]))
        out[kind] = calls
    return out


def flat_grads(params):
    return torch.cat([p.grad.reshape(-1) for p in params]).cpu()


def flat_state(model):
    return torch.cat([t.detach().float().reshape(-1)
                      for t in list(model.parameters()) +
                      list(model.buffers())]).cpu()


def ddp_steps(model, opt, batch, want, keep_grads: bool,
              steps: int = DDP_STEPS, replay=None, keep_states=False,
              first_offsets=None):
    """`steps` train steps on `batch`: per step the metrics, the launches
    (held against `want`), the ms, the step's own decisions (Decisions,
    on the host), with keep_grads the flat grads and the flat parameters
    after the update, with keep_states the state_dict and the AdamW
    moments before the step (host).  `replay`: a Decisions replay a step
    to play back.  `first_offsets`: an OffsetRecorder whose calls during
    the first step go into its row ("offsets")."""
    from srfdet3d_torch.train.trainer import train_step
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for step in range(steps):
        row = {}
        if keep_states:
            row["before"] = dict(
                state={k: v.detach().cpu().clone()
                       for k, v in model.state_dict().items()},
                mu=opt.mu.cpu().clone(), nu=opt.nu.cpu().clone(),
                count=opt.count)
        dec = Decisions(None if replay is None else replay[step])
        try:
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = train_step(model, opt, batch, gen)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        finally:
            dec.close()
        counts = read_counts()
        if counts != want:
            raise AssertionError(f"ddp step {step} launched {counts}, "
                                 f"the structure gives {want}")
        row.update(metrics={k: float(v) for k, v in metrics.items()},
                   launches=counts, ms=ms, decisions=dec.take())
        if first_offsets is not None and step == 0:
            row["offsets"] = list(first_offsets.calls)
        if keep_grads:
            row.update(grads=flat_grads(opt.params),
                       params=torch.cat([p.detach().reshape(-1)
                                         for p in opt.params]).cpu())
        out.append(row)
    return out


def load_step_state(model, opt, before) -> None:
    """A model and its optimizer at a state ddp_steps kept (keep_states)."""
    model.load_state_dict(before["state"])
    opt.mu.copy_(before["mu"])
    opt.nu.copy_(before["nu"])
    opt.count = before["count"]


class CollectiveCounter:
    """Counts the all-reduces and all-gathers this process issues (calls
    and the bytes of the tensor it contributes) by group: "world" (no
    group given), "data" and "model" (the 2-D mesh's groups).  close()
    puts torch.distributed's functions back."""

    def __init__(self, grid=None):
        import torch.distributed as dist
        self.dist, self.grid = dist, grid
        self.orig = (dist.all_reduce, dist.all_gather)
        self.tally = {}
        dist.all_reduce = self._wrap(self.orig[0], "all_reduce", 0)
        dist.all_gather = self._wrap(self.orig[1], "all_gather", 1)

    def _wrap(self, fn, op, arg):
        def call(*args, group=None, **kwargs):
            grid = self.grid
            who = ("world" if group is None else
                   "model" if grid is not None and group is grid.model_group
                   else "data")
            t = args[arg]
            row = self.tally.setdefault(f"{who}_{op}", dict(calls=0, bytes=0))
            row["calls"] += 1
            row["bytes"] += t.numel() * t.element_size()
            return fn(*args, group=group, **kwargs)
        return call

    def close(self):
        self.dist.all_reduce, self.dist.all_gather = self.orig


class OffsetRecorder:
    """Records each proposal_offsets call (the head's capacity-rule prefix
    over the model group): the block's per-sample counts and the offsets
    it got."""

    def __init__(self):
        from srfdet3d_torch.parallel import mesh
        self.mesh, self.orig = mesh, mesh.proposal_offsets
        self.calls = []
        mesh.proposal_offsets = self._offsets

    def _offsets(self, counts, grid=None):
        out = self.orig(counts, grid)
        self.calls.append((counts.tolist(), out.tolist()))
        return out

    def close(self):
        self.mesh.proposal_offsets = self.orig


def fallback_predicts(model, batch):
    """The model's predict at its own BEV patch window ("predict") and at
    a MODEL_AXIS_OVERFLOW_PATCH-cell one ("overflow"), both with the
    config's fallback slots: pred_logits, pred_boxes, the decoded boxes
    and the proposal_offsets calls, on the host."""
    heads = model.bbox_head.heads
    own = heads[0].roi_patch
    out = {}
    model.eval()
    with torch.no_grad():
        for name, window in (("predict", own),
                             ("overflow", MODEL_AXIS_OVERFLOW_PATCH)):
            for h in heads:
                h.roi_patch = window
            rec = OffsetRecorder()
            try:
                logits, boxes = model(batch)
                dec = model.decode((logits, boxes))
            finally:
                rec.close()
                for h in heads:
                    h.roi_patch = own
            out[name] = dict(logits=logits.cpu(), boxes=boxes.cpu(),
                             decoded={k: v.cpu() for k, v in dec.items()},
                             offsets=rec.calls)
    return out


def ddp_worker(work: str, n_model: int = 1) -> int:
    """One rank of ddp_flagship_train (RANK, WORLD_SIZE, MASTER_ADDR and
    MASTER_PORT from the parent; gloo on cuda:0), or with n_model > 1 of
    model_axis_flagship (a make_mesh_2d(WORLD_SIZE / n_model, n_model)
    grid, the steps under proposal_sharding, and first the two
    fallback_predicts, whose gathered outputs it keeps): the flagship's
    steps on its data index's
    rows of the global batch; every rank its decisions a step, its final
    state, launches, ms, peak memory and the collectives a step (on a grid
    by group, and the capacity rule's offsets of the first step); rank 0
    also the state before each step and the grads and parameters after
    it.  Writes <work>/rank<r>.pt."""
    import contextlib

    import torch.distributed as dist
    from srfdet3d_torch import set_backend_flags
    from srfdet3d_torch.models.detector import SRFDet
    from srfdet3d_torch.parallel import mesh
    from srfdet3d_torch.train.trainer import make_optimizer
    set_backend_flags()
    dev = torch.device("cuda:0")
    if not mesh.init_from_env(dev):
        raise RuntimeError("ddp worker: no group in the environment")
    rank, world = mesh.rank(), mesh.world()
    grid = mesh.make_mesh_2d(world // n_model, n_model) if n_model > 1 \
        else None
    cfg = ddp_config()
    model = SRFDet(cfg, device=dev, seed=0)
    mesh.broadcast_module(model)
    opt = make_optimizer(model, cfg, total_steps=1000)
    batch = {k: v.to(dev) for k, v in
             mesh.shard_rows(ddp_batch(cfg)).items()}
    out = dict(rank=rank)
    with (mesh.proposal_sharding(grid) if grid is not None
          else contextlib.nullcontext()):
        if grid is not None:
            out["predicts"] = fallback_predicts(model, batch)
        counter = CollectiveCounter(grid)
        offsets = OffsetRecorder()
        torch.cuda.reset_peak_memory_stats()
        try:
            steps = ddp_steps(model, opt, batch, train_launches(model),
                              keep_grads=rank == 0, keep_states=rank == 0,
                              first_offsets=offsets)
        finally:
            counter.close()
            offsets.close()
        peak = torch.cuda.max_memory_allocated() / 1e9
        # the grad all-reduce alone (one flat buffer: over the whole world
        # on a grid) and a BN-sized one
        times = {}
        for what, tensors in (("grads", None),
                              ("stats_257", [torch.ones(257, device=dev)])):
            reps = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if tensors is None:
                    mesh.all_reduce_grads(opt.params)
                else:
                    dist.all_reduce(tensors[0])
                torch.cuda.synchronize()
                reps.append((time.perf_counter() - t0) * 1e3)
            times[what] = statistics.median(reps[1:])
    tally = {k: {f: v // DDP_STEPS for f, v in row.items()}
             for k, row in counter.tally.items()}
    if grid is None:
        out["collectives_per_step"] = tally.get("world_all_reduce",
                                                dict(calls=0, bytes=0))
    else:
        out["collectives_per_step"] = tally
        out["offsets"] = steps[0].pop("offsets")
        out["grid"] = dict(n_data=grid.n_data, n_model=grid.n_model,
                           data_index=grid.data_index,
                           model_index=grid.model_index)
    out.update(steps=steps, final=flat_state(model), peak_gb=peak,
               allreduce_ms=times,
               grad_mb=sum(p.numel() for p in opt.params) * 4 / 1e6)
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    mesh.barrier()
    mesh.shutdown()
    return 0


def run_group(cmds, envs, timeout: float, logs):
    """Start every command at once (its own session), wait for all of them
    up to `timeout` seconds, kill every process group still running, and
    raise unless each exited 0 (with the end of its log)."""
    import signal
    procs = []
    try:
        for cmd, env, log in zip(cmds, envs, logs):
            with open(log, "w") as f:
                procs.append(subprocess.Popen(
                    cmd, env=env, stdout=f, stderr=subprocess.STDOUT,
                    start_new_session=True))
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    bad = [(cmd, p.returncode, log) for cmd, p, log in zip(cmds, procs, logs)
           if p.returncode != 0]
    if bad:
        tails = []
        for cmd, code, log in bad:
            with open(log) as f:
                tails.append(f"{' '.join(cmd[-3:])} exited {code}:\n"
                             f"{f.read()[-3000:]}")
        raise AssertionError("\n".join(tails))


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def step_errors(got, want, sizes, names, lr):
    """One step of the run under test against the reference's from the
    same state: each loss's, grad_norm's and the grads' relative error,
    the worst leaf's, and the largest parameter difference after the
    update against its bound (2 lr where a grad sits inside the rounding:
    Adam's first moves flip with its sign)."""
    loss_err = {k: abs(got["metrics"][k] - v) / max(abs(v), 1e-12)
                for k, v in want["metrics"].items()}
    rel, worst, leaf = grad_errors(got["grads"], want["grads"], sizes, names)
    return dict(max_loss_rel_err=max(v for k, v in loss_err.items()
                                     if k != "grad_norm"),
                grad_norm_rel_err=loss_err["grad_norm"],
                global_grad_rel_err=rel, worst_leaf_grad_err=worst,
                worst_leaf=leaf,
                max_param_diff=float((got["params"] -
                                      want["params"]).abs().max()),
                param_bound=2 * lr + 1e-6)


def step_ok(err) -> bool:
    return (err["max_loss_rel_err"] <= DDP_LOSS_RTOL and
            err["grad_norm_rel_err"] <= DDP_GRAD_RTOL and
            err["global_grad_rel_err"] <= DDP_GRAD_RTOL and
            err["worst_leaf_grad_err"] <= DDP_LEAF_TOL and
            err["max_param_diff"] <= err["param_bound"])


DDP_TOLERANCES = dict(loss_rtol=DDP_LOSS_RTOL, grad_norm_rtol=DDP_GRAD_RTOL,
                      grad_rel=DDP_GRAD_RTOL, worst_leaf=DDP_LEAF_TOL,
                      param="2 lr + 1e-6",
                      reference="one process from the same state, playing "
                                "back the decisions")


def run_ranks(work: str, world: int, *args: str):
    """`world` ranks of `chip_smoke.py --ddp-worker work *args` over gloo
    on cuda:0 (killed at DDP_TIMEOUT); returns each rank's record and the
    seconds they took."""
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()), WORLD_SIZE=str(world),
               SRFDET_DIST_BACKEND="gloo")
    t0 = time.perf_counter()
    run_group([[sys.executable, os.path.abspath(__file__), "--ddp-worker",
                work, *args]] * world,
              [dict(env, RANK=str(r), LOCAL_RANK="0") for r in range(world)],
              DDP_TIMEOUT,
              [os.path.join(work, f"rank{r}.log") for r in range(world)])
    ranks_s = time.perf_counter() - t0
    return [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
            for r in range(world)], ranks_s


def replayed_steps(cfg, batch, want, ranks, sizes, names, n_model=1):
    """Each of the ranks' DDP_STEPS steps again in this process on the
    whole batch, from rank 0's state before it, playing back the ranks'
    decisions of that step (joined_decisions), held at step_errors: a
    row a step with the losses, the errors and the decisions that still
    differ."""
    from srfdet3d_torch.models.detector import SRFDet
    from srfdet3d_torch.train.trainer import make_lr_schedule, make_optimizer
    lr = make_lr_schedule(cfg.optim, 1000)
    rows = []
    for step in range(DDP_STEPS):
        got = ranks[0]["steps"][step]
        played = joined_decisions([r["steps"][step]["decisions"]
                                   for r in ranks], n_model)
        model = SRFDet(cfg, device="cuda", seed=0)
        opt = make_optimizer(model, cfg, total_steps=1000)
        if step:
            load_step_state(model, opt, got["before"])
        again = ddp_steps(model, opt, batch, want, keep_grads=True, steps=1,
                          replay=[played])[0]
        del model, opt
        free_cache()
        rows.append(dict(step=step, losses=got["metrics"],
                         ref_losses=again["metrics"],
                         **step_errors(got, again, sizes, names, lr(step)),
                         flips=decision_flips(again["decisions"], played)))
    return rows


def ddp_flagship_train(smi, tmp: str):
    """The flagship at full width, DDP_WORLD ranks sharing the card over
    gloo (host-staged collectives), DDP_RANK_BATCH rows each, for
    DDP_STEPS steps, against one process on the whole batch: a timed run
    of the same steps from the same weights (its p50 and peak, and at the
    first step the decisions that differ from the ranks' and the grads'
    error, unchecked), then each step again from the ranks' state before
    it, playing back the ranks' decisions of that step, each within the
    DDP_* tolerances (step_errors); the ranks' final parameters and
    buffers bit for bit equal; each rank's launches a step equal to the
    structure, its p50 and peak.  Returns each rank's launches a step and
    the ranks' p50 and peak."""
    from srfdet3d_torch.models.detector import SRFDet
    from srfdet3d_torch.train.trainer import make_lr_schedule, make_optimizer
    t_phase = time.perf_counter()
    cfg = ddp_config()
    model = SRFDet(cfg, device="cuda", seed=0)
    opt = make_optimizer(model, cfg, total_steps=1000)
    want = train_launches(model)
    batch = {k: v.cuda() for k, v in ddp_batch(cfg).items()}
    torch.cuda.reset_peak_memory_stats()
    ref = ddp_steps(model, opt, batch, want, keep_grads=True)
    ref_peak = torch.cuda.max_memory_allocated() / 1e9
    sizes = [p.numel() for p in opt.params]
    names = [n for n, p in model.named_parameters()
             if any(p is q for q in opt.params)]
    del model, opt
    free_cache()
    work = os.path.join(tmp, "ddp_flagship")
    os.makedirs(work)
    ranks, ranks_s = run_ranks(work, DDP_WORLD)
    lr = make_lr_schedule(cfg.optim, 1000)
    rows = replayed_steps(cfg, batch, want, ranks, sizes, names)
    unplayed = dict(step_errors(ranks[0]["steps"][0], ref[0], sizes, names,
                                lr(0)),
                    flips=decision_flips(ref[0]["decisions"], joined_decisions(
                        [r["steps"][0]["decisions"] for r in ranks])))
    identical = all(torch.equal(ranks[0]["final"], r["final"])
                    for r in ranks[1:])
    summary = dict(
        rank_p50_ms=[statistics.median(s["ms"] for s in r["steps"])
                     for r in ranks],
        rank_peak_gb=[r["peak_gb"] for r in ranks],
        ref_p50_ms=statistics.median(s["ms"] for s in ref),
        ref_peak_gb=ref_peak)
    emit(dict(phase="ddp_flagship_train", config=cfg.name, dropout=0.0,
              ranks=DDP_WORLD, backend="gloo (host-staged, one card)",
              batch_per_rank=DDP_RANK_BATCH,
              global_batch=DDP_WORLD * DDP_RANK_BATCH, steps=DDP_STEPS,
              tolerances=DDP_TOLERANCES, per_step=rows,
              first_step_without_playback=unplayed,
              ranks_bit_identical=identical,
              rank_step_ms=[[s["ms"] for s in r["steps"]] for r in ranks],
              rank_launches=[r["steps"][-1]["launches"] for r in ranks],
              collectives_per_step=ranks[0]["collectives_per_step"],
              gloo_one_card_allreduce_ms=ranks[0]["allreduce_ms"],
              grad_mb=ranks[0]["grad_mb"],
              ref_step_ms=[s["ms"] for s in ref], **summary,
              ranks_s=ranks_s, seconds=time.perf_counter() - t_phase,
              device=smi))
    bad = [r for r in rows if not step_ok(r)]
    if bad:
        raise AssertionError(f"ddp_flagship_train: off the one-process "
                             f"step: {bad[0]}")
    if not identical:
        raise AssertionError("ddp_flagship_train: the ranks' parameters "
                             "and buffers differ")
    return ({f"rank{r['rank']}": r["steps"][-1]["launches"] for r in ranks},
            summary)


# the model axis (parallel.make_mesh_2d, proposal_sharding): the flagship's
# 900 proposals over MODEL_AXIS_GRID = (data, model) ranks on the card,
# DDP_RANK_BATCH rows a data index, against one process at the global
# batch.  The predicts' gathered outputs are held field by field (each
# class logit, each box code): the largest |difference| within
# MODEL_AXIS_PRED_TOL of max(1, the field's largest |value|) of the
# one-process predict's.  A block's queries attend to the gathered keys
# in products of other shapes than the whole run's, so cuBLAS may sum in
# another order (float32 rounding, 6e-8 relative an operation), and five
# iterations carry it: the largest field error measured on the H100 is
# 1.25e-5 (PERF.md); a wrong block, order or offset moves an output by
# O(0.1-1).  At the flagship's 32-cell window the predict's misfits
# (0-3 a sample) never fill the 64 fallback slots, so the second predict
# narrows the window to MODEL_AXIS_OVERFLOW_PATCH cells: ~100 misfits a
# sample in the last iteration, ~50 a block, so model rank 1's offset
# decides which of its misfits drop; the phase fails if it decided none.
MODEL_AXIS_GRID = (2, 2)
MODEL_AXIS_PRED_TOL = 1e-4
MODEL_AXIS_OVERFLOW_PATCH = 16


def field_errors(got: torch.Tensor, ref: torch.Tensor):
    """Per field of the last axis: max |got - ref| / max(1, max |ref|)."""
    scale = ref.abs().flatten(0, -2).amax(0).clamp_min(1.0)
    return ((got - ref).abs().flatten(0, -2).amax(0) / scale).tolist()


def offsets_decide(calls, slots: int) -> int:
    """The proposal_offsets calls (per-row counts, offsets) whose offset
    decides a drop: some misfit in the row's first `slots` local slots
    sits past the slots once the offset is added."""
    return sum(o > 0 and c > max(0, slots - o)
               for counts, offs in calls for c, o in zip(counts, offs))


def model_axis_flagship(smi, tmp: str, ddp_summary):
    """The flagship at full width on a MODEL_AXIS_GRID of gloo ranks
    sharing the card, its proposals sharded over the model axis: one
    predict (its gathered pred_logits and pred_boxes against this process's
    predict on the whole batch at the same weights, and the decoded boxes
    that differ), then DDP_STEPS train steps, each held against this
    process at the global batch from rank 0's state before it, playing
    back the grid's decisions joined along the proposals and the batch
    (replayed_steps); the ranks' final states bit for bit equal; each
    rank's launches a step equal to the structure (K5 over its block), its
    p50 and peak beside ddp_flagship_train's, the collectives a step by
    group with their bytes, and the BEV patch rule's misfits a sample
    against its fallback slots.  Returns each rank's launches a step."""
    from srfdet3d_torch.models.detector import SRFDet
    from srfdet3d_torch.train.trainer import make_optimizer
    t_phase = time.perf_counter()
    n_data, n_model = MODEL_AXIS_GRID
    cfg = ddp_config()
    model = SRFDet(cfg, device="cuda", seed=0)
    opt = make_optimizer(model, cfg, total_steps=1000)
    want = train_launches(model)
    batch = {k: v.cuda() for k, v in ddp_batch(cfg).items()}
    refs = fallback_predicts(model, batch)
    sizes = [p.numel() for p in opt.params]
    names = [n for n, p in model.named_parameters()
             if any(p is q for q in opt.params)]
    del model, opt
    free_cache()
    work = os.path.join(tmp, "model_axis_flagship")
    os.makedirs(work)
    ranks, ranks_s = run_ranks(work, n_data * n_model, str(n_model))
    rows = replayed_steps(cfg, batch, want, ranks, sizes, names, n_model)
    # the predicts: model rank 0 of each data index, joined along the
    # batch, field by field; the decoded boxes that differ
    leads = ranks[::n_model]
    errs, differ, decoded = {}, {}, {}
    for name, ref in refs.items():
        errs[name] = {k: field_errors(
            torch.cat([r["predicts"][name][k] for r in leads], 1), ref[k])
            for k in ("logits", "boxes")}
        dec = {k: torch.cat([r["predicts"][name]["decoded"][k]
                             for r in leads]) for k in ref["decoded"]}
        rd = ref["decoded"]
        box_diff = (dec["boxes"] - rd["boxes"]).abs().amax(-1)
        differ[name] = int(((dec["valid"] != rd["valid"]) |
                            ((dec["valid"] | rd["valid"]) &
                             ((dec["labels"] != rd["labels"]) |
                              (box_diff > 1e-3)))).sum())
        decoded[name] = int(rd["valid"].sum())
    worst = max(max(v) for e in errs.values() for v in e.values())
    same_blocks = all(torch.equal(r["predicts"][name][k],
                                  ranks[(i // n_model) * n_model]
                                  ["predicts"][name][k])
                      for i, r in enumerate(ranks) for name in refs
                      for k in ("logits", "boxes"))
    fallback = cfg.head.roi_patch_fallback
    decided = sum(offsets_decide(r["predicts"]["overflow"]["offsets"],
                                 fallback) for r in ranks)

    def misfits_of(calls):
        # the BEV patch rule a sample and iteration: the last model
        # rank's offset plus its count is the sample's misfits
        return [[o + c for c, o in zip(counts, offs)]
                for counts, offs in calls]
    misfits = misfits_of(ranks[n_model - 1]["offsets"])
    straddles = sum(o < fallback < o + c for r in ranks[:n_model]
                    for counts, offs in r["offsets"]
                    for c, o in zip(counts, offs))
    identical = all(torch.equal(ranks[0]["final"], r["final"])
                    for r in ranks[1:])
    emit(dict(phase="model_axis_flagship", config=cfg.name, dropout=0.0,
              grid=dict(n_data=n_data, n_model=n_model),
              proposals=cfg.head.num_proposals,
              proposals_per_rank=cfg.head.num_proposals // n_model,
              backend="gloo (host-staged, one card)",
              batch_per_data_rank=DDP_RANK_BATCH,
              global_batch=n_data * DDP_RANK_BATCH, steps=DDP_STEPS,
              tolerances=dict(DDP_TOLERANCES,
                              predict=f"{MODEL_AXIS_PRED_TOL} x max(1, "
                                      f"max |ref|) a field"),
              per_step=rows, ranks_bit_identical=identical,
              predict_field_err=errs, predict_worst_field_err=worst,
              predict_model_ranks_equal=same_blocks,
              decoded_boxes=decoded, decoded_boxes_differ=differ,
              overflow_patch=MODEL_AXIS_OVERFLOW_PATCH,
              overflow_misfits_per_sample=misfits_of(
                  ranks[n_model - 1]["predicts"]["overflow"]["offsets"]),
              overflow_rows_offset_decides=decided,
              overflow_moved_predict=max(
                  float((refs["overflow"][k] - refs["predict"][k])
                        .abs().max()) for k in ("logits", "boxes")),
              rank_p50_ms=[statistics.median(s["ms"] for s in r["steps"])
                           for r in ranks],
              rank_step_ms=[[s["ms"] for s in r["steps"]] for r in ranks],
              rank_peak_gb=[r["peak_gb"] for r in ranks],
              ddp_flagship_train=ddp_summary,
              rank_launches=[r["steps"][-1]["launches"] for r in ranks],
              collectives_per_step=[r["collectives_per_step"]
                                    for r in ranks],
              allreduce_ms=ranks[0]["allreduce_ms"],
              grad_mb=ranks[0]["grad_mb"],
              patch_misfits_per_sample=misfits, patch_fallback=fallback,
              misfits_past_fallback=sum(m > fallback for row in misfits
                                        for m in row),
              blocks_straddling_fallback=straddles,
              ranks_s=ranks_s, seconds=time.perf_counter() - t_phase,
              device=smi))
    bad = [r for r in rows if not step_ok(r)]
    if bad:
        raise AssertionError(f"model_axis_flagship: off the one-process "
                             f"step: {bad[0]}")
    if not identical:
        raise AssertionError("model_axis_flagship: the ranks' parameters "
                             "and buffers differ")
    if worst > MODEL_AXIS_PRED_TOL or not same_blocks:
        raise AssertionError(f"model_axis_flagship: a predict is off the "
                             f"one-process predict: {errs}, model ranks "
                             f"equal {same_blocks}")
    if not decided:
        raise AssertionError("model_axis_flagship: no model rank's offset "
                             "decided a drop in the overflow predict")
    return {f"rank{r['rank']}": r["steps"][-1]["launches"] for r in ranks}


def ddp_nccl_world1(smi):
    """One process in an NCCL group of one: DDP_STEPS flagship steps at
    batch 2 (the config's dropout, one generator seed on every run) with
    every collective issued, between two runs of the same steps with no
    group (the card's float atomics make two runs of one program
    differ), all from the same seeded weights: the p50 of each, per step
    each loss's and grad_norm's relative difference from the first
    no-group run, the first step's grads' error and the decisions that
    differ.  The group's first step is held within the DDP_* tolerances
    against one more no-group step from the same weights that plays back
    its decisions: the synced BatchNorm2d computes flax's statistics, not
    cuDNN's, so the two are not expected to agree bit for bit."""
    import datetime

    import torch.distributed as dist
    from srfdet3d_torch.configs import srfdet_voxel_nusc_L
    from srfdet3d_torch.models.detector import SRFDet
    from srfdet3d_torch.parallel import mesh
    from srfdet3d_torch.train.trainer import make_lr_schedule, make_optimizer
    t_phase = time.perf_counter()
    cfg = srfdet_voxel_nusc_L()
    batch = {k: v.cuda() for k, v in
             synthetic_batch(cfg, 2, seed=0, with_gt=True).items()}
    runs, init_s = {}, None
    for name, steps in (("no_group", DDP_STEPS), ("nccl_world1", DDP_STEPS),
                        ("no_group_again", DDP_STEPS), ("played_back", 1)):
        if name == "nccl_world1":
            t0 = time.perf_counter()
            dist.init_process_group(
                "nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                world_size=1, rank=0,
                timeout=datetime.timedelta(seconds=120))
            init_s = time.perf_counter() - t0
        try:
            model = SRFDet(cfg, device="cuda", seed=0)
            opt = make_optimizer(model, cfg, total_steps=1000)
            calls = {"n": 0}
            plain = dist.all_reduce

            def counted(*args, **kwargs):
                calls["n"] += 1
                return plain(*args, **kwargs)
            dist.all_reduce = counted
            try:
                rows = ddp_steps(
                    model, opt, batch, train_launches(model),
                    keep_grads=True, steps=steps,
                    replay=([runs["nccl_world1"]["rows"][0]["decisions"]]
                            if name == "played_back" else None))
            finally:
                dist.all_reduce = plain
            runs[name] = dict(rows=rows, collectives=calls["n"],
                              state=flat_state(model),
                              backend=(dist.get_backend() if mesh.active()
                                       else None))
            sizes = [p.numel() for p in opt.params]
            names = [n for n, p in model.named_parameters()
                     if any(p is q for q in opt.params)]
            del model, opt
        finally:
            if name == "nccl_world1":
                dist.destroy_process_group()
        free_cache()
    lr = make_lr_schedule(cfg.optim, 1000)
    base = runs["no_group"]["rows"]

    def against(other):
        rows = runs[other]["rows"]
        return dict(rel_diff_per_step=[
            {k: abs(o["metrics"][k] - b["metrics"][k]) /
             max(abs(b["metrics"][k]), 1e-12) for k in b["metrics"]}
            for o, b in zip(rows, base)],
            first_step=dict(step_errors(rows[0], base[0], sizes, names,
                                        lr(0)),
                            flips=decision_flips(rows[0]["decisions"],
                                                 base[0]["decisions"])),
            max_state_diff=float((runs[other]["state"] -
                                  runs["no_group"]["state"]).abs().max()))
    nccl = runs["nccl_world1"]
    checked = dict(step_errors(nccl["rows"][0], runs["played_back"]["rows"][0],
                               sizes, names, lr(0)),
                   flips=decision_flips(runs["played_back"]["rows"][0][
                       "decisions"], nccl["rows"][0]["decisions"]))
    ms = {k: [r["ms"] for r in v["rows"]] for k, v in runs.items()}
    emit(dict(phase="ddp_nccl_world1", config=cfg.name, batch=2,
              steps=DDP_STEPS, init_s=init_s,
              p50_ms=statistics.median(ms["nccl_world1"]),
              no_group_p50_ms=statistics.median(ms["no_group"]),
              no_group_again_p50_ms=statistics.median(ms["no_group_again"]),
              step_ms=ms["nccl_world1"], no_group_step_ms=ms["no_group"],
              no_group_again_step_ms=ms["no_group_again"],
              collectives_per_step=nccl["collectives"] // DDP_STEPS,
              nccl_vs_no_group=against("nccl_world1"),
              no_group_vs_no_group=against("no_group_again"),
              first_step_checked=checked, tolerances=DDP_TOLERANCES,
              losses=[r["metrics"] for r in nccl["rows"]],
              no_group_losses=[r["metrics"] for r in base],
              seconds=time.perf_counter() - t_phase, device=smi))
    if any(runs[n]["collectives"] for n in ["no_group", "no_group_again",
                                            "played_back"]) or \
            nccl["collectives"] == 0 or nccl["backend"] != "nccl":
        raise AssertionError(f"ddp_nccl_world1: collectives "
                             f"{runs['no_group']['collectives']} without a "
                             f"group, {nccl['collectives']} with "
                             f"{nccl['backend']}")
    if not step_ok(checked):
        raise AssertionError(f"ddp_nccl_world1: the first step is off the "
                             f"no-group step: {checked}")


# ddp_cli: a flagship root at data_phases' sizes with three val frames
# (an odd count: rank 0 evaluates two, rank 1 one), trained by
# dist_train.sh on 2 ranks (gloo on the card) for 2 epochs of 2 steps at a
# global batch of 2, then evaluated by dist_test.sh on 2 ranks and by the
# test CLI in one process from the same checkpoint
DDP_CLI_ROOT = dict(DATA_ROOTS["nus"], n_val=3)


def ddp_cli(smi, tmp: str):
    """The launchers: dist_train.sh and dist_test.sh, 2 ranks, gloo on the
    card, each process killed at DDP_TIMEOUT.  The train run's log shows
    every step's finite losses and both ranks' steps; its checkpoint
    loads; dist_test.sh's dump (rank 0) holds the val frames in dataset
    order, equal to the one-process test CLI's (labels exactly, boxes and
    scores within 1e-4: the card's float atomics in the point scatters),
    its metrics (re-evaluated from the dump, and each rank's printed line)
    equal the one-process metrics within 1e-4."""
    import re

    from srfdet3d_torch.configs import get_config
    from srfdet3d_torch.data import synthetic_root
    from srfdet3d_torch.tools import test as test_cli
    from srfdet3d_torch.tools.train import apply_cfg_options
    t_phase = time.perf_counter()
    name = "srfdet_voxel_nusc_L"
    nus = synthetic_root.write_nuscenes_root(os.path.join(tmp, "ddp_nus"),
                                             **DDP_CLI_ROOT)
    here = os.path.dirname(os.path.abspath(__file__))
    tools = os.path.join(here, "srfdet3d_torch", "tools")
    env = dict(os.environ, NPROC=str(DDP_WORLD), BACKEND="gloo",
               PYTHON=sys.executable)
    work = os.path.join(tmp, "ddp_cli")
    os.makedirs(work)
    t0 = time.perf_counter()
    train_log = os.path.join(work, "train.log")
    run_group([["bash", os.path.join(tools, "dist_train.sh"), name,
                "--data-root", nus["root"], "--db-info", nus["db"],
                "--no-cbgs", "--batch-size", "2", "--epochs", "2",
                "--log-interval", "1", "--device", "cuda:0",
                "--work-dir", os.path.join(work, "wd")]], [env],
              DDP_TIMEOUT, [train_log])
    train_s = time.perf_counter() - t0
    with open(train_log) as f:
        log = f.read()
    steps = [float(m) for m in re.findall(r"^iter \d+ .* loss (\S+)", log,
                                          re.M)]
    done = re.findall(r"rank (\d): training done: (\d+) steps", log)
    ckpt = os.path.join(work, "wd", name, "epoch_2.pt")
    if len(steps) != 4 or not all(map(math.isfinite, steps)) or \
            sorted(done) != [("0", "4"), ("1", "4")] or \
            not os.path.exists(ckpt):
        raise AssertionError(f"ddp_cli train: losses {steps}, done {done}, "
                             f"checkpoint {os.path.exists(ckpt)}:\n"
                             f"{log[-3000:]}")
    options = ["--cfg-options", *TEST_OPTIONS]
    dist_out = os.path.join(work, "dist.pkl")
    test_log = os.path.join(work, "test.log")
    t0 = time.perf_counter()
    run_group([["bash", os.path.join(tools, "dist_test.sh"), name, ckpt,
                "--data-root", nus["root"], "--batch-size", "1",
                "--device", "cuda:0", "--out", dist_out, *options]], [env],
              DDP_TIMEOUT, [test_log])
    test_s = time.perf_counter() - t0
    with open(test_log) as f:
        tlog = f.read()
    printed = re.findall(r"^rank (\d): (\{.*\})$", tlog, re.M)
    one_out = os.path.join(work, "one.pkl")
    t0 = time.perf_counter()
    one = test_cli.main([name, ckpt, "--data-root", nus["root"],
                         "--batch-size", "1", "--device", "cuda",
                         "--out", one_out, *options])
    one_s = time.perf_counter() - t0
    with open(dist_out, "rb") as f:
        dist_dump = pickle.load(f)
    with open(one_out, "rb") as f:
        one_dump = pickle.load(f)
    cfg = apply_cfg_options(get_config(name), TEST_OPTIONS)
    dist_res = test_cli.evaluate(cfg, dist_dump["gts"], dist_dump["preds"],
                                 device="cuda")
    frames = len(dist_dump["preds"])
    worst = 0.0
    for part in ("gts", "preds"):
        for x, y in zip(dist_dump[part], one_dump[part]):
            if list(x["labels_name"]) != list(y["labels_name"]) or \
                    x["boxes"].shape != y["boxes"].shape:
                raise AssertionError(f"ddp_cli: a {part} frame differs")
            for k in ("boxes", "scores"):
                if k in x and x[k].size:
                    worst = max(worst, float(np.abs(x[k] - y[k]).max()))
    scalars = {k: v for k, v in one.items() if isinstance(v, float)}
    metric_diff = max(abs(dist_res[k] - v) for k, v in scalars.items())
    if frames != DDP_CLI_ROOT["n_val"] or len(one_dump["preds"]) != frames \
            or worst > 1e-4 or metric_diff > 1e-4 or \
            sorted(r for r, _ in printed) != ["0", "1"] or \
            printed[0][1] != printed[1][1]:
        raise AssertionError(f"ddp_cli test: {frames} frames, dump off by "
                             f"{worst}, metrics by {metric_diff}, printed "
                             f"{printed}:\n{tlog[-3000:]}")
    emit(dict(phase="ddp_cli", config=name, ranks=DDP_WORLD,
              backend="gloo (host-staged, one card)", train_steps=len(steps),
              train_losses=steps, train_s=train_s, val_frames=frames,
              test_s=test_s, one_process_test_s=one_s,
              dump_vs_one_process_max_abs=worst,
              metrics=scalars, metrics_max_abs_diff=metric_diff,
              metrics_equal=metric_diff == 0.0,
              detections=sum(len(p["boxes"]) for p in dist_dump["preds"]),
              seconds=time.perf_counter() - t_phase, device=smi))


# ---------------------------------------------------------------------------
# the options no shipped config turns on, at the flagship's full width

IMG_PATCH_VARIANTS = (
    ("xpatch32_fallback-1", ("head.img_roi_xpatch=32",)),
    ("xpatch32_fallback0", ("head.img_roi_xpatch=32",
                            "head.img_roi_xpatch_fallback=0")),
    ("patch32_fallback-1", ("head.img_roi_patch=32",)))


def option_config(name: str, *options: str):
    """A shipped config with the train CLI's --cfg-options applied."""
    from srfdet3d_torch.configs import get_config
    from srfdet3d_torch.tools.train import apply_cfg_options
    return apply_cfg_options(get_config(name), list(options))


def options_encoder(smi):
    """srfdet_voxel_nusc_L with head.with_lidar_encoder=true: one predict
    phase at batch 1 (launches K1 21 and K2 4), then train steps at batch
    2 (2 warm-up, 5 timed) with loss.assigner=hungarian (K1 21, K2 4, K3
    17, K4 4 and K5 5 a step, finite losses), the host ms of the scipy
    solves a step and of the one device-to-host copy of every layer's and
    sample's costs a step (which waits for the forward queued before
    it)."""
    t0 = time.perf_counter()
    cfg = option_config("srfdet_voxel_nusc_L", "head.with_lidar_encoder=true")
    none = dict.fromkeys(COUNTED, 0)
    counts, _ = predict_phase("options_encoder_predict", cfg,
                              synthetic_batch(cfg, 1, seed=0), smi,
                              dict(none, gather_conv=21, eqmatch=4))
    free_cache()
    cfg = option_config("srfdet_voxel_nusc_L", "head.with_lidar_encoder=true",
                        "loss.assigner=hungarian")
    # scipy's first import (~2 s, inside the first solve) is not a solve
    import scipy.optimize  # noqa: F401
    reset_counts("hungarian.")
    per_step = train_phase("options_encoder_train", cfg, smi, warmup=2,
                           steps=5)
    check_launches("options_encoder_train", per_step,
                   FLAGSHIP_STEP_LAUNCHES, 1)
    st = hungarian_stats()
    # srfdet_losses calls: each solves every layer's and sample's problem
    calls = st["solves"] / (cfg.head.num_heads * 2)
    free_cache()
    emit(dict(phase="options_encoder", config=cfg.name,
              options=["head.with_lidar_encoder=true",
                       "loss.assigner=hungarian"],
              predict_launches=counts, train_launches=per_step,
              loss_evaluations=calls, solves=st["solves"],
              hungarian_solve_ms_per_step=st["host_ms"] / calls,
              hungarian_copy_ms_per_step=st["copy_ms"] / calls,
              seconds=time.perf_counter() - t0, device=smi))
    return counts, per_step


def remat_grads(cfg, batch, seed: int):
    """One step's grads of the model with head.remat off, off again and
    on, on the same weights, batch and dropout generator seed: the LiDAR
    branch's forward runs once and every head reads its maps (its float
    atomics, the VFE's and the sparse encoder's scatters, would otherwise
    round differently in two forwards and flip ReLUs, which moves the
    flagship's grads by percents), then the head, the losses and the
    whole backward run three times; the two runs without remat show what
    the backward's float atomics alone move.  Returns, for (off, off) and (on, off): the worst leaf's
    |g_a - g_b| over its largest grad (the attention key biases, zero but
    for rounding, over the largest grad of all) with its name, among the
    head's leaves and among the rest, and the losses' worst relative
    difference; and each run's peak bytes from the head on."""
    from srfdet3d_torch.models.detector import SRFDet
    from srfdet3d_torch.models.losses import srfdet_losses
    model = SRFDet(cfg, device="cuda", seed=0)
    model.train()
    batch = {k: v.cuda() for k, v in batch.items()}
    points, mask = model._inputs(batch)
    maps = model.extract_point_features(points, mask)
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    runs, peaks = [], []
    for i, remat in enumerate((False, False, True)):
        model.bbox_head.remat = remat
        gen = torch.Generator(device="cuda").manual_seed(seed)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        logits, boxes = model.bbox_head(maps, gen)
        losses = srfdet_losses(logits, boxes, batch["gt_boxes"],
                               batch["gt_labels"], batch["gt_mask"].bool(),
                               cfg.loss, cfg.ota,
                               decoder_num_heads=cfg.head.num_heads)
        grads = torch.autograd.grad(sum(losses.values()),
                                    [p for _, p in named],
                                    retain_graph=i < 2, allow_unused=True)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated())
        runs.append(({k: float(v.detach()) for k, v in losses.items()},
                     grads))
    model.bbox_head.remat = cfg.head.remat

    def diff(a, b):
        """Per part (the head's leaves, which remat recomputes, and the
        rest, whose grads pass through K5's float atomics first)."""
        loss_err = max(abs(a[0][k] - v) / max(abs(v), 1e-12)
                       for k, v in b[0].items())
        tree_max = max(float(g.abs().max()) for g in b[1] if g is not None)
        out = {part: dict(max_grad_rel_err=0.0, worst_leaf=None)
               for part in ("head", "rest")}
        for (name, _), ga, gb in zip(named, a[1], b[1]):
            if (ga is None) != (gb is None):
                raise AssertionError(f"{name}: a grad in one run only")
            if ga is None:
                continue
            scale = (tree_max if name.endswith("k_proj.bias")
                     else max(float(gb.abs().max()), 1e-30))
            err = float((ga - gb).abs().max()) / scale
            part = out["head" if name.startswith("bbox_head.") else "rest"]
            if err >= part["max_grad_rel_err"]:
                part.update(max_grad_rel_err=err, worst_leaf=name)
        return dict(out, max_loss_rel_err=loss_err)
    return diff(runs[1], runs[0]), diff(runs[2], runs[0]), peaks


def options_auction_nodpg(smi):
    """srfdet_voxel_nusc_L with head.with_dpg=false, loss.assigner=auction
    and head.remat=true: train steps at batch 2 (launches as the
    flagship's, finite losses), the auction's rounds a step and the
    budgets it spent; then remat_grads: one step's grads with remat on
    against the same step's with it off, each leaf against its largest:
    the head's (what remat recomputes) within 1e-5, the LiDAR branch's
    within 1e-5 or twice what the same step run twice without remat moves
    them (K5's float atomics feed their backward), and both peaks."""
    t0 = time.perf_counter()
    cfg = option_config("srfdet_voxel_nusc_L", "head.with_dpg=false",
                        "loss.assigner=auction", "head.remat=true")
    reset_counts("hungarian.")
    per_step = train_phase("options_auction_nodpg_train", cfg, smi,
                           warmup=1, steps=3)
    check_launches("options_auction_nodpg_train", per_step,
                   FLAGSHIP_STEP_LAUNCHES, 1)
    st = hungarian_stats()
    free_cache()
    with deterministic_cudnn():
        again, remat, peaks = remat_grads(cfg, train_batch(cfg, 2, seed=1),
                                          seed=3)
    # the head's grads within 1e-5; the rest within 1e-5 or twice what
    # the backward's float atomics alone move them (plain against plain)
    rest_tol = max(1e-5, 2 * again["rest"]["max_grad_rel_err"])
    if (remat["head"]["max_grad_rel_err"] > 1e-5 or
            remat["rest"]["max_grad_rel_err"] > rest_tol or
            remat["max_loss_rel_err"] > 1e-6):
        raise AssertionError(f"options_auction_nodpg: remat's step off the "
                             f"plain one: {remat}; plain against plain: "
                             f"{again}")
    free_cache()
    emit(dict(phase="options_auction_nodpg", config=cfg.name,
              options=["head.with_dpg=false", "loss.assigner=auction",
                       "head.remat=true"],
              train_launches=per_step, auctions=st["auctions"],
              auction_rounds_per_step=st["rounds"] / st["auctions"],
              budgets_spent=st["exhausted"],
              remat_against_plain=remat, plain_against_plain=again,
              peak_mem_bytes_plain=peaks[0],
              peak_mem_bytes_remat=peaks[2],
              seconds=time.perf_counter() - t0, device=smi))
    return per_step


@torch.no_grad()
def zeroed_pairs(model, batch, patch: int, x_only: bool):
    """The (camera, RoI) pairs a fallback of 0 zeroes in each head
    iteration of one predict: the pooled pairs (the image cap's compacted
    ones, or all) whose RoI misfits the patch (x_only: its x extent), a
    list per iteration of counts per (sample, camera)."""
    from srfdet3d_torch.models.head import (compact_pairs,
                                            denormalize_centers,
                                            img_rois_from_boxes)
    from srfdet3d_torch.ops.roi_align import patch_fits
    cfg, head = model.cfg, model.bbox_head
    points, mask = model._inputs(batch)
    maps = model.extract_point_features(points, mask)
    img_maps = head.image_maps(model.extract_img_features(
        model.image_tensor(batch)))
    shapes = [tuple(f.shape[-2:]) for f in img_maps]
    boxes0, _ = head.init_proposals(maps, img_maps)
    _, boxes = model(batch)
    l2i = batch["lidar2img"].float()
    strides, cap = cfg.head.img_strides, cfg.head.img_roi_cap
    out = []
    for b in [denormalize_centers(boxes0, cfg.pc_range)] + list(boxes[:-1]):
        cam_rois = img_rois_from_boxes(b, l2i)
        bs, n_cam, n_p, _ = cam_rois.shape
        if cap:
            rois, src = compact_pairs(cam_rois, cfg.img.img_shape, strides,
                                      cap)
            real = src < n_p
        else:
            rois = cam_rois.reshape(bs * n_cam, n_p, 4)
            real = torch.ones(rois.shape[:2], dtype=torch.bool,
                              device=rois.device)
        fits = patch_fits(shapes, rois.reshape(-1, 4), strides, patch,
                          x_only=x_only).reshape(real.shape)
        out.append((~fits & real).sum(1).tolist())
    return out


def options_img_patch(smi):
    """srfdet_voxel_nusc_LC's predict (batch 1, lc_batch) with the image
    RoIAlign's capacity rules (IMG_PATCH_VARIANTS): xpatch 32 with fallback
    -1 and with fallback 0, patch 32 with fallback -1, each on the default
    model's weights: launches K1 21 and K2 4; with fallback -1 the forward
    within 1e-4 of the default pairs route's; with fallback 0 the pairs
    zeroed a camera in each head iteration (zeroed_pairs), and the outputs
    move iff some pair was zeroed; p50 of 5 predicts each."""
    from srfdet3d_torch.models.detector import SRFDet
    t0 = time.perf_counter()
    base = option_config("srfdet_voxel_nusc_LC")
    batch = {k: v.cuda() for k, v in lc_batch(base, 1, seed=0).items()}
    ref_model = SRFDet(base, device="cuda", seed=0)
    with torch.no_grad():
        ref = ref_model(batch)
    state = ref_model.state_dict()
    del ref_model
    want = dict(dict.fromkeys(COUNTED, 0), gather_conv=21, eqmatch=4)
    rows = {}
    for name, opts in IMG_PATCH_VARIANTS:
        cfg = option_config("srfdet_voxel_nusc_LC", *opts)
        model = SRFDet(cfg, device="cuda", seed=0)
        model.load_state_dict(state)
        reset_counts()
        with torch.no_grad():
            got = model(batch)
        torch.cuda.synchronize()
        counts = read_counts()
        if counts != want:
            raise AssertionError(f"options_img_patch {name} launched "
                                 f"{counts}, expected {want}")
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        row = dict(launches=counts, max_abs_diff_to_pairs=err)
        hc = cfg.head
        fallback = (hc.img_roi_patch_fallback if hc.img_roi_patch
                    else hc.img_roi_xpatch_fallback)
        if fallback < 0:
            for g, r in zip(got, ref):
                torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)
        else:
            zeroed = zeroed_pairs(model, batch, hc.img_roi_xpatch,
                                  x_only=True)
            total = sum(sum(it) for it in zeroed)
            if (total > 0) != (err > 0):
                raise AssertionError(f"options_img_patch {name}: {total} "
                                     f"pairs zeroed, outputs moved {err}")
            row.update(zeroed_per_camera=zeroed, zeroed_pairs=total)
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            model.predict(batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
        row["p50_ms"] = statistics.median(times)
        rows[name] = row
        del model
        free_cache()
    emit(dict(phase="options_img_patch", config=base.name,
              img_roi_cap=base.head.img_roi_cap, batch=1, variants=rows,
              seconds=time.perf_counter() - t0, device=smi))
    return {name: row["launches"] for name, row in rows.items()}


def all_options_tiny():
    """The tiny VoVNet LC config (tiny_lc_configs) with every option no
    shipped config turns on that a predict runs: the deformable BEV
    encoder, no DPG, head remat, and the image RoIAlign's xpatch (4
    cells, 2 fallback slots a camera); tiny_end_to_end adds the BEV
    patch (8 cells, 2 slots)."""
    import dataclasses
    cfg = tiny_lc_configs()[0]
    return cfg.replace(name="tiny_lc_all_options", head=dataclasses.replace(
        cfg.head, with_lidar_encoder=True, with_dpg=False, remat=True,
        img_roi_xpatch=4, img_roi_xpatch_fallback=2))


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
                "prep_ms", "prep_device_ms", "builds", "bf16_launches",
                "lc_launches",
                "lc_train_launches", "data_launches", "convert_launches",
                "learn_launches", "ddp_launches", "model_axis_launches",
                "options_launches",
                "export_launches", "img_geometry"):
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
    # the C++ point route of the data pipeline: g++ at first use
    from srfdet3d_torch.data import native
    host_built = not native.library_path().exists()
    t0 = time.perf_counter()
    native.build()
    host_build_s = time.perf_counter() - t0

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
        # K1-bf16 at the same 21 convs (the bf16 model's encoder)
        k1b_err, k1b = check_gather_conv_bf16(cfg.name, conv_cases, dev, gen)
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
        # K4-bf16 at the step's 4 strided and conv_out convs
        k4b = check_conv_bwd_bf16(train_cases, dev, gen)
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
    tail_graph_phase(smi)
    torch.cuda.empty_cache()
    # the bf16 model (compute_dtype="bfloat16"): K1-bf16 in its encoder;
    # its boxes against the float32 model's on the same weights
    bf16_launches = {}
    counts, _ = predict_phase("flagship_bf16_predict", bf16_config(cfg),
                              batch, smi,
                              dict(none, gather_conv_bf16=21, eqmatch=4))
    bf16_launches["flagship_bf16_predict"] = counts
    bf16_centre_gap("flagship_bf16_vs_f32", cfg, batch, smi)
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
    # the image branch alone in bf16 (img.compute_dtype) on nuScenes LC:
    # the launches of nusc_lc_predict
    nusc_lc = CONFIGS["srfdet_voxel_nusc_LC"]()
    counts, _ = predict_phase("nusc_lc_img_bf16_predict",
                              bf16_config(nusc_lc, model=False),
                              lc_batch(nusc_lc, 1, seed=0), smi,
                              dict(none, gather_conv=21, eqmatch=4))
    bf16_launches["nusc_lc_img_bf16_predict"] = counts
    torch.cuda.empty_cache()
    per_step = train_phase("flagship_train", cfg, smi)
    torch.cuda.empty_cache()
    # the bf16 flagship step: K1-bf16 and K2 forward, K3 on float32 upcasts,
    # K4-bf16, and no K5 (bf16 RoIAlign tables take the plain route)
    step16 = train_phase("flagship_bf16_train", bf16_config(cfg), smi)
    if step16 != dict(none, gather_conv_bf16=21, eqmatch=4, subm_bwd=17,
                      strided_bwd_bf16=4):
        raise AssertionError(f"flagship_bf16_train: structure {step16}")
    bf16_launches["flagship_bf16_train"] = step16
    torch.cuda.empty_cache()
    train_phase("kitti_train", kcfg, smi, warmup=1, steps=3)
    torch.cuda.empty_cache()
    train_phase("pillar_train", pcfg, smi, warmup=1, steps=3)
    torch.cuda.empty_cache()
    # the six LC train steps at full width, each at its own batch size,
    # the LiDAR branch frozen: K1 and K2 in the frozen voxel encoders'
    # forward, K5 once a head iteration for the image RoIAlign, no K3 or
    # K4 and no BEV K5 (the BEV table needs no grad)
    lc_train = {}
    for phase, name in LC_TRAIN_PHASES:
        c = CONFIGS[name]()
        lc_train[phase] = train_phase(
            phase, c, smi, warmup=1, steps=2,
            batch_size=c.optim.batch_size_per_device,
            prepare=seed_dcn_offsets)
        torch.cuda.empty_cache()
    bf16_launches["nusc_lc_img_bf16_train"] = train_phase(
        "nusc_lc_img_bf16_train", bf16_config(nusc_lc, model=False), smi,
        warmup=1, steps=2, batch_size=nusc_lc.optim.batch_size_per_device)
    if bf16_launches["nusc_lc_img_bf16_train"] != lc_train["nusc_lc_train"]:
        raise AssertionError(f"nusc_lc_img_bf16_train launched "
                             f"{bf16_launches['nusc_lc_img_bf16_train']}, "
                             f"nusc_lc_train {lc_train['nusc_lc_train']}")
    torch.cuda.empty_cache()
    # the runtime around the model: train and test from files on disk;
    # a reference-format checkpoint through the convert and test CLIs; the
    # flagship learning planted boxes
    with tempfile.TemporaryDirectory() as tmp:
        data_launches, roots = data_phases(smi, tmp)
        free_cache()
        # the host side: the point routes, the step from files profiled
        # three ways
        data_route(smi, roots, host_build_s, host_built)
        data_step_profile(smi, roots, tmp)
        free_cache()
        # from here to the tiny train steps the phases are checks whose
        # times are not kept as the port's: flagship_learn trains beside
        # them in a process of its own (learn_worker), and the export
        # worker traces, saves and loads the flagship's predict (weights
        # passed in) and KITTI's on the table backend (baked)
        learner = LearnWorker()
        exporter = ExportWorker()
        raw_tree_train(smi, tmp)
        free_cache()
        convert_launches = convert_roundtrip(smi, tmp)
        free_cache()
        # data parallelism: two ranks against one process, an NCCL group
        # of one, and the launchers
        ddp_launches, ddp_summary = ddp_flagship_train(smi, tmp)
        free_cache()
        # the model axis: the flagship's proposals over a 2 x 2 grid
        model_axis_launches = model_axis_flagship(smi, tmp, ddp_summary)
        free_cache()
        ddp_nccl_world1(smi)
        free_cache()
        ddp_cli(smi, tmp)
    free_cache()
    # the options no shipped config turns on, at full width
    options_launches = {}
    (options_launches["options_encoder_predict"],
     options_launches["options_encoder_train"]) = options_encoder(smi)
    options_launches["options_auction_nodpg_train"] = \
        options_auction_nodpg(smi)
    for name, c in options_img_patch(smi).items():
        options_launches[f"options_img_patch_{name}"] = c
    free_cache()
    tiny_end_to_end(tiny_test_config())
    tiny_end_to_end(table_backend(tiny_kitti_test_config()))
    tiny_end_to_end(table_backend(tiny_test_config()))
    tiny_end_to_end(tiny_pillar_test_config(), patch=False)
    for c, seed in zip(tiny_lc_configs(), TINY_LC_SEEDS):
        tiny_end_to_end(c, prepare=seed_dcn_offsets, seed=seed)
    tiny_end_to_end(all_options_tiny())
    # both bf16 modes, card against CPU
    tiny_bf16_end_to_end(bf16_config(tiny_test_config()))
    tiny_bf16_end_to_end(bf16_config(tiny_lc_test_config("vovnet"),
                                     model=False))
    tiny_train(*tiny_train_setup())
    tiny_train(*tiny_kitti_train_setup())
    for backbone, opts, model_seed, batch_seed, steps in TINY_LC_TRAIN:
        tiny_train(tiny_lc_test_config(backbone, **opts), model_seed,
                   batch_seed, steps, prepare=seed_dcn_offsets)
    learn_launches = learner.result()
    learner.close()
    free_cache()
    # each artifact on the card alone: the live predict's launches
    records, ready_wait_s, card_s = exporter.checks()
    exporter.close()
    export_launches = {}
    for rec in records:
        emit(dict(rec, ready_wait_s=ready_wait_s, card_s=card_s))
        export_launches[rec["phase"]] = rec["launches"]
    if records[1]["builds"]["key_hash"] != k6["builds"]:
        raise AssertionError(f"kitti_table_export built "
                             f"{records[1]['builds']} hash tables, "
                             f"the lookup walk {k6['builds']}")
    free_cache()
    for phase, c, b in (("flagship", cfg, batch),
                        ("flagship_bf16", bf16_config(cfg), batch),
                        ("kitti", kcfg, kbatch),
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
    predict_busy("nusc_lc_img_bf16_predict_busy",
                 bf16_config(nusc_lc, model=False),
                 lc_batch(nusc_lc, 1, seed=0), smi)
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
                       (k5_step, "roi_scatter"), (k6, "rulebook_lookup"),
                       (k1b, "gather_conv_bf16"),
                       (k4b, "strided_bwd_bf16")):
        entry["bf16_launches"] = {ph: c[key]
                                  for ph, c in bf16_launches.items()}
        entry["lc_launches"] = {ph: c[key] for ph, c in lc_launches.items()}
        entry["lc_train_launches"] = {ph: c[key]
                                      for ph, c in lc_train.items()}
        entry["data_launches"] = {ph: c[key]
                                  for ph, c in data_launches.items()}
        entry["convert_launches"] = {ph: c[key]
                                     for ph, c in convert_launches.items()}
        entry["learn_launches"] = learn_launches[key]
        entry["ddp_launches"] = {rank: c[key]
                                 for rank, c in ddp_launches.items()}
        entry["model_axis_launches"] = {
            rank: c[key] for rank, c in model_axis_launches.items()}
        entry["options_launches"] = {ph: c[key]
                                     for ph, c in options_launches.items()}
        entry["export_launches"] = {ph: c[key]
                                    for ph, c in export_launches.items()}
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
                     dict(k6, bound_by="bytes"), 0.0),
        kernel_entry("gather_conv_bf16", "srfdet3d_torch/csrc/gather_conv.cu",
                     "srfdet3d_tpu/ops/pallas_onehot.py:67",
                     bf16_launches["flagship_bf16_predict"][
                         "gather_conv_bf16"], k1b, k1b_err),
        kernel_entry("conv_bwd_strided_bf16",
                     "srfdet3d_torch/csrc/gather_conv_bwd.cu",
                     "srfdet3d_tpu/ops/pallas_onehot_bwd.py:33",
                     bf16_launches["flagship_bf16_train"]["strided_bwd_bf16"],
                     k4b, k4b["max_abs_err"])]})
    print(smi)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ddp-worker"]:
        sys.exit(ddp_worker(sys.argv[2], *map(int, sys.argv[3:4])))
    workers = {"--export-worker": export_worker,
               "--learn-worker": learn_worker}
    if sys.argv[1:2] and sys.argv[1] in workers:
        _START = float(sys.argv[3])
        sys.exit(workers[sys.argv[1]](sys.argv[2]))
    sys.exit(main())
