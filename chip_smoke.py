"""Smoke test of the PyTorch port on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and exits non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: both CUDA kernels from srfdet3d_torch/csrc, in parallel;
3. gather_conv (K1) against its plain version on real flagship rulebooks,
   at every conv shape of the sparse encoder;
4. eqmatch (K2) against subm_rulebook_bitmap at the 4 flagship stages,
   exact;
5. flagship srfdet_voxel_nusc_L predict at full width, batch 1, on a
   synthetic scene and seeded random weights: launch counts, finite
   outputs, p50 latency, valid boxes, peak memory; plus decode_boxes with
   score_thr=0 so NMS sees its full 900 x 10 load; then the same predict
   split at its layer boundaries (time and peak memory of each part);
6. tiny_test_config predict with the kernels on the card against the same
   weights on the CPU with the plain versions;
7. the `kernels` line: per kernel, launches per predict, max error against
   the plain version, and per-predict times (kernel, plain version, bound,
   one PyTorch library call).

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
# CUDA-core flop/s, the bound of a float32 kernel without tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# K1: rtol + atol * sqrt(K * Cin); the kernel sums over offsets then
# channels, the plain matmul in another order, so float32 rounding differs
# by a few ulps per term of the K * Cin-term sums
K1_RTOL, K1_ATOL = 1e-5, 1e-5


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


def synthetic_batch(cfg, seed: int = 0):
    """The JAX package's synthetic scene (__graft_entry__._synthetic_batch):
    half of points_cap real, uniform in pc_range, seeded."""
    rng = np.random.default_rng(seed)
    p = cfg.points_cap
    pts = np.zeros((1, p, cfg.points_dim), np.float32)
    n = p // 2
    lo, hi = cfg.pc_range[:3], cfg.pc_range[3:6]
    for d in range(3):
        pts[:, :n, d] = rng.uniform(lo[d], hi[d], (1, n))
    pts[:, :n, 3:] = rng.uniform(0, 1, (1, n, cfg.points_dim - 3))
    mask = np.zeros((1, p), bool)
    mask[:, :n] = True
    return {"points": torch.from_numpy(pts), "points_mask":
            torch.from_numpy(mask)}


def flagship_rulebooks(cfg, batch, dev):
    """Walk the flagship encoder's rulebooks on the card.  Returns the
    gather_conv cases [(name, rows N, rulebook (M, K), Cin, Cout, launches
    per predict)] and the eq-match cases [(stage, ColumnSet, vcol, vz,
    vyx, mask)], one per subm stage."""
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

    rows = spec.max_voxels
    gidx = stage_subm(0)
    conv.append(("conv_input", rows, gidx, m.in_channels, m.base_channels, 1))
    cin = m.base_channels
    n_stages = len(m.encoder_channels)
    for i, blocks in enumerate(m.encoder_channels):
        n_sub = 2 * (len(blocks) - (1 if i < n_stages - 1 else 0))
        conv.append((f"stage{i}_subm", rows, gidx, cin, cin, n_sub))
        if i < n_stages - 1:
            pad = m.encoder_paddings[i][len(blocks) - 1]
            down = rb.downsample(pad, m.capacities[i]).reshape(-1, 27)
            conv.append((f"down{i}", rows, down, cin, blocks[-1], 1))
            rows, cin = m.capacities[i], blocks[-1]
            gidx = stage_subm(i + 1)
    out = rb.convout(m.capacities[-1]).reshape(-1, 3)
    conv.append(("conv_out", rows, out, cin, m.output_channels, 1))
    return conv, subm


def check_gather_conv(cases, dev, gen):
    from srfdet3d_torch.ops.gather_conv import gather_conv, gather_conv_plain
    totals = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
                  flop_bound_ms=0.0, byte_bound_ms=0.0)
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
        tol = K1_RTOL * ref.abs() + K1_ATOL * math.sqrt(k * cin)
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
        fb, bb = flops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
        row = dict(phase="gather_conv", conv=name, n=n, m=m, k=k, cin=cin,
                   cout=cout, launches_per_predict=per_predict,
                   max_abs_err=float(err.max()), ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=max(fb, bb),
                   bound_by="operations" if fb >= bb else "bytes",
                   nnz=nnz)
        emit(row)
        for key, val in (("ms", ms), ("plain_ms", plain_ms),
                         ("library_ms", lib_ms), ("bound_ms", max(fb, bb)),
                         ("flop_bound_ms", fb if fb >= bb else 0.0),
                         ("byte_bound_ms", bb if bb > fb else 0.0)):
            totals[key] += per_predict * val
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


def reset_counts():
    from srfdet3d_torch.ops import eqmatch, gather_conv
    gather_conv.launches = 0
    eqmatch.launches = 0


def read_counts():
    from srfdet3d_torch.ops import eqmatch, gather_conv
    return gather_conv.launches, eqmatch.launches


def all_finite(out) -> bool:
    return all(bool(torch.isfinite(v.float()).all()) for v in out.values())


def flagship_predict(cfg, batch, smi):
    from srfdet3d_torch.geometry import iou
    from srfdet3d_torch.models.detector import SRFDet
    from srfdet3d_torch.models.head import decode_boxes
    model = SRFDet(cfg, device="cuda", seed=0)
    dev_batch = {k: v.cuda() for k, v in batch.items()}
    torch.cuda.synchronize()
    reset_counts()
    out = model.predict(dev_batch)
    torch.cuda.synchronize()
    k1, k2 = read_counts()
    predict_sweeps = iou.last_nms_sweeps
    if (k1, k2) != (21, 4):
        raise AssertionError(f"flagship predict launched gather_conv {k1} "
                             f"and eqmatch {k2} times, expected 21 and 4")
    if not all_finite(out):
        raise AssertionError("flagship predict gave non-finite outputs")
    with torch.no_grad():
        logits, boxes = model(dev_batch)
    if not (bool(torch.isfinite(logits).all()) and
            bool(torch.isfinite(boxes).all())):
        raise AssertionError("flagship forward gave non-finite outputs")
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
    emit(dict(phase="flagship_predict", config=cfg.name, batch=1,
              points=cfg.points_cap, gather_conv_launches=k1,
              eqmatch_launches=k2, finite=True,
              p50_ms=statistics.median(times), min_ms=min(times),
              max_ms=max(times), runs=len(times),
              valid_boxes=int(out["valid"].sum()),
              max_score=float(torch.sigmoid(logits[-1]).max()),
              nms_sweeps=predict_sweeps,
              full_nms_valid_boxes=int(full["valid"].sum()),
              full_nms_sweeps=full_sweeps,
              full_nms_decode_p50_ms=statistics.median(decode_ms),
              peak_mem_bytes=peak, device=smi))
    flagship_parts(model, dev_batch, smi)
    return k1, k2


def flagship_parts(model, batch, smi, runs: int = 5):
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
    emit(dict(phase="flagship_parts", device=smi,
              p50_ms={k: statistics.median(v) for k, v in ms.items()},
              peak_mem_bytes=peak))


def tiny_end_to_end():
    """tiny_test_config predict: kernels on the card vs plain versions on
    the CPU, same weights (same seed).  Forward outputs agree within
    rtol = atol = 1e-4 (float32 op order); decoded valid flags exactly and
    scores within 1e-5; labels exactly and boxes within 1e-4 at every valid
    detection whose score is more than 1e-4 from its neighbours' (closer
    scores may swap order)."""
    import dataclasses
    from srfdet3d_torch.configs import tiny_test_config
    from srfdet3d_torch.models.detector import SRFDet
    from srfdet3d_torch.models.head import decode_boxes
    cfg = tiny_test_config()
    cfg = cfg.replace(head=dataclasses.replace(cfg.head, roi_patch=8,
                                               roi_patch_fallback=2))
    rng = np.random.default_rng(0)
    p = cfg.points_cap
    pts = np.zeros((2, p, 5), np.float32)
    pts[:, :p // 2, :2] = rng.uniform(-9, 9, (2, p // 2, 2))
    pts[:, :p // 2, 2] = rng.uniform(-3, 1, (2, p // 2))
    pts[:, :p // 2, 3:] = rng.uniform(0, 1, (2, p // 2, 2))
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
        lc, bc = cpu(batch)
    k1, k2 = read_counts()
    if k1 == 0 or k2 == 0:
        raise AssertionError("tiny predict on the card skipped a kernel")
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
    emit(dict(phase="tiny_end_to_end", gather_conv_launches=k1,
              eqmatch_launches=k2, forward_max_abs_err=ferr, **worst))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from srfdet3d_torch import set_backend_flags
    from srfdet3d_torch.configs import srfdet_voxel_nusc_L
    from srfdet3d_torch.ops import cuda_build
    set_backend_flags()
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit(dict(phase="device", nvidia_smi=smi, kind=kind,
              count=torch.cuda.device_count(), torch=torch.__version__,
              cuda=torch.version.cuda))
    secs = cuda_build.build_kernels(["gather_conv", "eqmatch"])
    emit(dict(phase="build", seconds=secs))

    cfg = srfdet_voxel_nusc_L()
    batch = synthetic_batch(cfg, seed=0)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        conv_cases, subm_cases = flagship_rulebooks(cfg, batch, dev)
        k1_err, k1 = check_gather_conv(conv_cases, dev, gen)
        k2 = check_eqmatch(subm_cases)
    del conv_cases, subm_cases
    torch.cuda.empty_cache()

    k1_launches, k2_launches = flagship_predict(cfg, batch, smi)
    tiny_end_to_end()

    emit({"kernels": [
        dict(name="gather_conv", route="cuda",
             source="srfdet3d_torch/csrc/gather_conv.cu",
             replaces="srfdet3d_tpu/ops/pallas_onehot.py:67",
             launches=k1_launches, max_abs_err=k1_err, ms=k1["ms"],
             plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by=("operations" if k1["flop_bound_ms"] >=
                       k1["byte_bound_ms"] else "bytes"),
             library_ms=k1["library_ms"]),
        dict(name="eqmatch", route="cuda",
             source="srfdet3d_torch/csrc/eqmatch.cu",
             replaces="srfdet3d_tpu/ops/pallas_eqmatch.py:53",
             launches=k2_launches, max_abs_err=0.0, ms=k2["ms"],
             plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"],
             bound_by="bytes", library_ms=None)]})
    print(smi)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
