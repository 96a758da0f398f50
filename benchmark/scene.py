"""Sensor-like LiDAR scenes, the one generator behind every traffic mix.

A frame is what a nuScenes-style detector receives: `sweeps` sweeps of a
32-beam spinning LiDAR on a moving car, aggregated into the newest sweep's
frame with each point's time lag as its 5th channel (mmdet3d's
LoadPointsFromMultiSweeps, `sweeps_num=10`), then range-filtered, shuffled
and cut to the config's `points_cap` as a random subset, the way the
port's `filter_pad` cuts a frame that is over capacity.

The world is a ground plane at the sensor's mounting height below it,
20-60 objects of nuScenes' ten classes (their shares and typical sizes,
with yaw, on the ground, some moving along their heading) and a few walls
near the edge of the range.  Every beam of every sweep is cast against it
(ray against plane and against rotated boxes), so points lie on the
surfaces that face the sensor, and their density falls with range as the
beams fan out.  All parameters come from the traffic file; the draws come
from `--seed` and the frame's index alone, on the device the frames are
made on (the same seed gives the same frames on a device).

Box convention (the detector's): [cx, cy, cz, w, l, h, yaw, vx, vy], cz
the gravity centre; `w` lies along the box's local x axis, `l` along its
local y axis, and a box's heading is its local y axis, rotated from the
LiDAR frame as x = sx cos(yaw) + sy sin(yaw), y = -sx sin(yaw) + sy
cos(yaw).
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch


def derived_seed(*key: int) -> int:
    """A 63-bit seed from a tuple of whole numbers (any size)."""
    words = np.random.SeedSequence([int(k) for k in key]).generate_state(
        2, np.uint32)
    return (int(words[0]) << 31) | (int(words[1]) >> 1)


def _uniform(g, n, lo, hi, dev):
    return lo + (hi - lo) * torch.rand(n, generator=g, device=dev)


def stratum(lo, hi, k: int, n: int) -> float:
    """The middle of the k-th of n equal parts of [lo, hi]."""
    return lo + (hi - lo) * (k + 0.5) / n


def draw_world(p: dict, g: torch.Generator, dev, k: int = 0, n: int = 1
               ) -> dict:
    """One scene's objects and walls, in the newest sweep's frame.  Its
    object count and the car's speed are the k-th of n strata of their
    ranges, so that every seed's pool holds the same sizes (in its own
    order) and the seed does not change the amount of work."""
    classes = p["classes"]
    n_obj = int(round(stratum(*p["objects"], k, n)))
    share = torch.tensor([c["share"] for c in classes], device=dev)
    label = torch.multinomial(share, n_obj, replacement=True, generator=g)
    size = torch.tensor([c["wlh"] for c in classes], device=dev)[label]
    size = size * (1 + p["size_jitter"] * torch.randn(
        n_obj, 3, generator=g, device=dev)).clamp(0.7, 1.3)
    half = p["object_area"] / 2
    xy = _uniform(g, (n_obj, 2), -half, half, dev)
    # keep the ego car's footprint free
    near = (xy[:, 0].abs() < 4.0) & (xy[:, 1].abs() < 3.0)
    xy[:, 0] = torch.where(near, xy[:, 0] + 8.0 * torch.sign(xy[:, 0] + 1e-6),
                           xy[:, 0])
    yaw = _uniform(g, n_obj, -math.pi, math.pi, dev)
    speed_max = torch.tensor([c["speed"] for c in classes], device=dev)[label]
    moving = torch.rand(n_obj, generator=g, device=dev) < torch.tensor(
        [c["moving"] for c in classes], device=dev)[label]
    speed = torch.where(moving, speed_max * torch.rand(
        n_obj, generator=g, device=dev), 0.0)
    vel = speed[:, None] * torch.stack([torch.sin(yaw), torch.cos(yaw)], 1)
    ground = -p["mount_height"]
    z = ground + size[:, 2] / 2
    boxes = torch.cat([xy, z[:, None], size, yaw[:, None], vel], 1)
    refl = _uniform(g, n_obj, *p["object_reflectivity"], dev)

    n_wall = int(torch.randint(p["walls"][0], p["walls"][1] + 1, (1,),
                               generator=g, device=dev))
    ang = _uniform(g, n_wall, -math.pi, math.pi, dev)
    dist = _uniform(g, n_wall, *p["wall_distance"], dev)
    length = _uniform(g, n_wall, *p["wall_length"], dev)
    height = _uniform(g, n_wall, *p["wall_height"], dev)
    wall_xy = dist[:, None] * torch.stack([torch.cos(ang), torch.sin(ang)], 1)
    # a wall's length (its local y axis, (sin yaw, cos yaw)) runs
    # tangentially, along (-sin ang, cos ang)
    wall_yaw = -ang
    walls = torch.cat([
        wall_xy, (ground + height / 2)[:, None],
        torch.full_like(length, p["wall_thickness"])[:, None],
        length[:, None], height[:, None], wall_yaw[:, None],
        torch.zeros(n_wall, 2, device=dev)], 1)
    wall_refl = _uniform(g, n_wall, *p["wall_reflectivity"], dev)
    ego_speed = stratum(*p["ego_speed"], k, n)
    return dict(boxes=boxes, labels=label, refl=refl, walls=walls,
                wall_refl=wall_refl, ego_speed=ego_speed, ground=ground)


def _ray_boxes(origin, dirs, boxes):
    """Entry distance of each ray into each rotated box ((R, N), inf where
    it misses or starts inside)."""
    c, s = torch.cos(boxes[:, 6]), torch.sin(boxes[:, 6])
    ox = origin[0] - boxes[:, 0]
    oy = origin[1] - boxes[:, 1]
    # LiDAR frame -> box frame: sx = x cos - y sin, sy = x sin + y cos
    lo = torch.stack([ox * c - oy * s, ox * s + oy * c,
                      origin[2] - boxes[:, 2]], 1)              # (N, 3)
    dx = dirs[:, 0:1] * c - dirs[:, 1:2] * s                    # (R, N)
    dy = dirs[:, 0:1] * s + dirs[:, 1:2] * c
    dz = dirs[:, 2:3].expand_as(dx)
    half = boxes[:, 3:6] / 2
    t_in = torch.zeros_like(dx)
    t_out = torch.full_like(dx, float("inf"))
    for d, o, h in ((dx, lo[:, 0], half[:, 0]), (dy, lo[:, 1], half[:, 1]),
                    (dz, lo[:, 2], half[:, 2])):
        inv = 1.0 / torch.where(d.abs() < 1e-9, torch.full_like(d, 1e-9), d)
        t1 = (-h - o) * inv
        t2 = (h - o) * inv
        t_in = torch.maximum(t_in, torch.minimum(t1, t2))
        t_out = torch.minimum(t_out, torch.maximum(t1, t2))
    hit = (t_in < t_out) & (t_in > 0)
    return torch.where(hit, t_in, float("inf"))


def cast_sweep(p: dict, world: dict, lag: float, g: torch.Generator, dev):
    """The returns of one sweep taken `lag` seconds before the newest, in
    the newest sweep's frame: (n, 5) x, y, z, intensity, lag, and the
    index of the object each return hit (-1: ground or wall)."""
    n_az = p["azimuth_steps"]
    elev = torch.deg2rad(torch.linspace(p["elevation_deg"][0],
                                        p["elevation_deg"][1], p["beams"],
                                        device=dev))
    az0 = float(_uniform(g, 1, 0.0, 2 * math.pi / n_az, dev))
    az = az0 + torch.arange(n_az, device=dev) * (2 * math.pi / n_az)
    ce, se = torch.cos(elev), torch.sin(elev)
    dirs = torch.stack([ce[:, None] * torch.cos(az)[None],
                        ce[:, None] * torch.sin(az)[None],
                        se[:, None].expand(-1, n_az)], -1).reshape(-1, 3)
    # the car drives along +x: `lag` seconds ago it was behind
    origin = torch.tensor([-world["ego_speed"] * lag, 0.0, 0.0], device=dev)
    boxes = world["boxes"].clone()
    boxes[:, 0:2] -= lag * boxes[:, 7:9]
    solids = torch.cat([boxes, world["walls"]], 0)
    t_solid = _ray_boxes(origin, dirs, solids)
    t_best, which = t_solid.min(1)
    t_ground = torch.where(dirs[:, 2] < -1e-6,
                           (world["ground"] - origin[2]) / dirs[:, 2],
                           torch.full_like(dirs[:, 2], float("inf")))
    on_ground = t_ground < t_best
    t = torch.minimum(t_best, t_ground)
    n_obj = boxes.shape[0]
    refl = torch.cat([world["refl"], world["wall_refl"]])[which]
    ground_refl = _uniform(g, t.shape[0], *p["ground_reflectivity"], dev)
    refl = torch.where(on_ground, ground_refl, refl)
    keep = (t < p["max_range"]) & (torch.rand(t.shape[0], generator=g,
                                              device=dev) < p["return_rate"])
    t = t + p["range_noise"] * torch.randn(t.shape[0], generator=g,
                                           device=dev)
    pts = origin + t[:, None] * dirs
    intensity = p["intensity_scale"] * refl * _uniform(
        g, t.shape[0], 0.5, 1.0, dev)
    out = torch.cat([pts, intensity[:, None],
                     torch.full_like(t, lag)[:, None]], 1)
    hit_obj = torch.where(on_ground | (which >= n_obj), -1, which)
    return out[keep], hit_obj[keep]


def make_sample(p: dict, cfg: dict, g: torch.Generator, dev, k: int = 0,
                n: int = 1) -> dict:
    """One frame (the k-th stratum of n): the padded points and its GT
    boxes."""
    world = draw_world(p, g, dev, k, n)
    sweeps, hits = [], []
    for k in range(p["sweeps"]):
        pts, hit = cast_sweep(p, world, k * p["sweep_interval_s"], g, dev)
        sweeps.append(pts)
        hits.append(hit if k == 0 else torch.full_like(hit, -2))
    pts = torch.cat(sweeps)
    hit = torch.cat(hits)
    pc = cfg["pc_range"]
    r_xy = torch.linalg.norm(pts[:, :2], dim=1)
    inside = ((pts[:, 0] >= pc[0]) & (pts[:, 0] <= pc[3]) &
              (pts[:, 1] >= pc[1]) & (pts[:, 1] <= pc[4]) &
              (pts[:, 2] >= pc[2]) & (pts[:, 2] <= pc[5]) &
              (r_xy > p["min_range"]))
    pts, hit = pts[inside], hit[inside]
    returns = pts.shape[0]
    cap = cfg["points_cap"]
    order = torch.randperm(returns, generator=g, device=dev)[:cap]
    pts, hit = pts[order], hit[order]
    n = pts.shape[0]
    points = torch.zeros(cap, cfg["points_dim"], device=dev)
    points[:n] = pts[:, :cfg["points_dim"]]
    mask = torch.zeros(cap, dtype=torch.bool, device=dev)
    mask[:n] = True
    boxes = world["boxes"]
    g_cap = cfg["gt_cap"]
    k = min(boxes.shape[0], g_cap)
    gt = torch.zeros(g_cap, 9, device=dev)
    gt[:k] = boxes[:k]
    labels = torch.zeros(g_cap, dtype=torch.int32, device=dev)
    labels[:k] = world["labels"][:k].int()
    gmask = torch.zeros(g_cap, dtype=torch.bool, device=dev)
    gmask[:k] = True
    return dict(points=points, points_mask=mask, gt_boxes=gt,
                gt_labels=labels, gt_mask=gmask, hit=torch.cat(
                    [hit, hit.new_full((cap - n,), -3)]),
                returns=returns)


def camera_rig(img_shape, num_cams: int, seed: int) -> np.ndarray:
    """(n_cam, 4, 4) float32 lidar2img of a seeded surround rig: pinholes
    evenly spaced in yaw (camera k looks along 2 pi k / n_cam, +-2
    degrees), nuScenes' field of view (f = 1266 px at 1600 px wide, scaled
    with the image width; the principal point at the image centre),
    mounted 1.5 m above the ground with the LiDAR at 1.84 m (z = -0.34 in
    the LiDAR frame), +-5 cm (a copy of chip_smoke.camera_rig)."""
    rng = np.random.default_rng(seed)
    h, w = img_shape
    f = 1266.0 * w / 1600.0
    k = np.array([[f, 0, w / 2, 0], [0, f, h / 2, 0], [0, 0, 1, 0],
                  [0, 0, 0, 1]])
    out = np.zeros((num_cams, 4, 4), np.float32)
    for cam in range(num_cams):
        yaw = 2 * np.pi * cam / num_cams + np.deg2rad(rng.uniform(-2, 2))
        pos = np.array([0.0, 0.0, -0.34]) + rng.uniform(-0.05, 0.05, 3)
        # camera axes in the LiDAR frame: x right, y down, z forward
        rot = np.array([[np.sin(yaw), -np.cos(yaw), 0.0],
                        [0.0, 0.0, -1.0],
                        [np.cos(yaw), np.sin(yaw), 0.0]])
        ext = np.eye(4)
        ext[:3, :3], ext[:3, 3] = rot, -rot @ pos
        out[cam] = k @ ext
    return out


BATCH_KEYS = ("points", "points_mask")
GT_KEYS = ("gt_boxes", "gt_labels", "gt_mask")


def make_pool(traffic: dict, cfg: dict, seed: int, dev) -> List[dict]:
    """The traffic's pool of distinct inputs: `pool` batches of `batch`
    frames each (with GT for a train mix, with camera images and rigs for
    a config that has an image branch), made on `dev` from (seed, batch,
    frame) and kept on the host, pinned where there is a card, as a loader
    hands them over.  Each batch also carries its scene statistics under
    `stats` (host numbers).  The pool's frames take the n strata of the
    object count and the car's speed, in an order drawn from the seed."""
    p = traffic["scene"]
    pool = []
    n = traffic["pool"] * traffic["batch"]
    order = np.random.default_rng(derived_seed(seed, 1 << 21)).permutation(n)
    for i in range(traffic["pool"]):
        frames = []
        for j in range(traffic["batch"]):
            g = torch.Generator(device=dev)
            g.manual_seed(derived_seed(seed, i, j))
            k = int(order[i * traffic["batch"] + j])
            frames.append(make_sample(p, cfg, g, dev, k, n))
        keys = BATCH_KEYS + (GT_KEYS if traffic["mode"] == "train" else ())
        batch = {k: torch.stack([f[k] for f in frames]) for k in keys}
        img = cfg.get("img")
        if img is not None:
            g = torch.Generator(device=dev)
            g.manual_seed(derived_seed(seed, i, 1 << 20))
            h, w = img["img_shape"]
            b, n_cam = traffic["batch"], img["num_cams"]
            batch["images"] = torch.randn(b, n_cam, h, w, 3, generator=g,
                                          device=dev)
            batch["lidar2img"] = torch.from_numpy(np.stack([
                camera_rig((h, w), n_cam, derived_seed(seed, i, j, 1))
                for j in range(b)]))
        host = {}
        for k, v in batch.items():
            v = v.cpu()
            host[k] = v.pin_memory() if torch.cuda.is_available() else v
        host["stats"] = dict(
            returns=[int(f["returns"]) for f in frames],
            points=[int(f["points_mask"].sum()) for f in frames],
            objects=[int(f["gt_mask"].sum()) for f in frames])
        pool.append(host)
    return pool
