"""Synthetic scenes for tests and for driving the port on the card.

NumPy generators that give, for the same seed, the same arrays as the JAX
package's test fixtures (``make_scene``, ``make_lidar_scene``,
``make_camera_data``, ``with_noaug_channels``); masks are packed by
``data/masks.py::pack_mask_scores``.
The ``*_arrays`` functions return plain NumPy dicts; ``to_point_batch`` /
``to_camera_data`` / ``to_ground_truth`` move them into the port's
containers on a device.
``make_av2_scene_arrays`` is the JAX package's Argoverse 2 bench scene and
its seven ring cameras. ``ccl_problem_arrays`` builds the CCL kernel's hard
inputs.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .data.masks import pack_mask_scores
from .utils.containers import CameraData, GroundTruth, PointBatch


def make_scene_arrays(
    seed=0,
    batch_size=2,
    boxes_per_sample=3,
    pts_per_box=80,
    bg_points=400,
    n_cap=2048,
    max_gt=16,
    num_classes=10,
    point_dim=5,
    extent=10.0,
) -> Dict[str, np.ndarray]:
    """A few boxes with sampled interior points plus volumetric clutter."""
    rng = np.random.default_rng(seed)
    all_pts, all_batch = [], []
    gt_boxes = np.zeros((batch_size, max_gt, 10), np.float32)
    gt_labels = np.full((batch_size, max_gt), -1, np.int32)
    gt_valid = np.zeros((batch_size, max_gt), bool)

    for b in range(batch_size):
        for j in range(boxes_per_sample):
            cx, cy = rng.uniform(-extent, extent, 2)
            cz = rng.uniform(-1.5, -0.5)
            dx, dy, dz = rng.uniform(1.5, 4.0), rng.uniform(1.5, 3.0), rng.uniform(1.2, 2.0)
            yaw = rng.uniform(-np.pi, np.pi)
            label = rng.integers(0, num_classes)
            gt_boxes[b, j] = [cx, cy, cz, dx, dy, dz, yaw, 0, 0, 1]
            gt_labels[b, j] = label
            gt_valid[b, j] = True
            local = rng.uniform(-0.5, 0.5, (pts_per_box, 3)) * [dx, dy, dz]
            c, s = np.cos(yaw), np.sin(yaw)
            world = np.stack(
                [
                    local[:, 0] * c - local[:, 1] * s + cx,
                    local[:, 0] * s + local[:, 1] * c + cy,
                    local[:, 2] + cz + dz / 2,
                ],
                1,
            )
            extra = rng.random((pts_per_box, point_dim - 3)).astype(np.float32)
            all_pts.append(np.concatenate([world, extra], 1))
            all_batch.append(np.full(pts_per_box, b))
        bg = np.concatenate(
            [
                rng.uniform(-extent, extent, (bg_points, 2)),
                rng.uniform(-2.5, 2.5, (bg_points, 1)),
                rng.random((bg_points, point_dim - 3)),
            ],
            1,
        )
        all_pts.append(bg)
        all_batch.append(np.full(bg_points, b))

    pts = np.concatenate(all_pts).astype(np.float32)
    batch = np.concatenate(all_batch).astype(np.int32)
    n = len(pts)
    if n > n_cap:
        raise ValueError(f"scene has {n} points, capacity {n_cap}")
    pad = n_cap - n
    return dict(
        points=np.concatenate([pts, np.zeros((pad, point_dim), np.float32)]),
        batch_idx=np.concatenate([batch, np.zeros(pad, np.int32)]),
        valid=np.concatenate([np.ones(n, bool), np.zeros(pad, bool)]),
        gt_boxes=gt_boxes, gt_labels=gt_labels, gt_valid=gt_valid,
    )


def make_lidar_scene_arrays(
    seed=0,
    n_cap=131072,
    max_gt=128,
    n_boxes=32,
    num_classes=10,
    point_dim=5,
    extent=50.0,
    n_rings=40,
    pts_per_ring=2200,
    n_walls=24,
    sweeps=10,
) -> Dict[str, np.ndarray]:
    """Surface-like multi-sweep LiDAR scene: ground rings, facades and box
    shells, re-scanned by every sweep (nuScenes-like voxel occupancy)."""
    rng = np.random.default_rng(seed)
    base_sites = []
    n_ground = n_rings * pts_per_ring // 4
    r = extent * np.sqrt(rng.uniform(0.02, 1.0, n_ground))
    th = rng.uniform(-np.pi, np.pi, n_ground)
    base_sites.append(np.stack([
        r * np.cos(th), r * np.sin(th), rng.normal(-1.8, 0.03, n_ground)
    ], 1))
    for _ in range(n_walls):
        cx, cy = rng.uniform(-extent, extent, 2)
        yaw = rng.uniform(-np.pi, np.pi)
        L, H = rng.uniform(6, 20), rng.uniform(2, 6)
        n = int(L * H * 7)
        u = rng.uniform(-0.5, 0.5, n) * L
        z = rng.uniform(-1.8, -1.8 + H, n)
        base_sites.append(np.stack([
            cx + u * np.cos(yaw), cy + u * np.sin(yaw), z,
        ], 1))
    base = np.concatenate(base_sites)
    pts_list = []
    for _ in range(sweeps):
        take = rng.random(len(base)) < 0.55
        p = base[take] + rng.normal(0, 0.015, (int(take.sum()), 3))
        pts_list.append(p)

    gt_boxes = np.zeros((1, max_gt, 10), np.float32)
    gt_labels = np.full((1, max_gt), -1, np.int32)
    gt_valid = np.zeros((1, max_gt), bool)
    for j in range(n_boxes):
        cx, cy = rng.uniform(-extent * 0.9, extent * 0.9, 2)
        cz = rng.uniform(-1.8, -1.2)
        dxl, dyl, dzl = rng.uniform(1.5, 5.0), rng.uniform(1.5, 2.5), rng.uniform(1.2, 2.2)
        yaw = rng.uniform(-np.pi, np.pi)
        gt_boxes[0, j] = [cx, cy, cz, dxl, dyl, dzl, yaw, 0, 0, 1]
        gt_labels[0, j] = rng.integers(0, num_classes)
        gt_valid[0, j] = True
        n = 350
        face = rng.integers(0, 3, n)
        u = rng.uniform(-0.5, 0.5, n)
        v = rng.uniform(-0.5, 0.5, n)
        lx = np.where(face == 0, u * dxl, np.where(face == 1, -dxl / 2, u * dxl))
        ly = np.where(face == 0, -dyl / 2, np.where(face == 1, u * dyl, v * dyl))
        lz = np.where(face < 2, (v + 0.5) * dzl, dzl)
        c, s = np.cos(yaw), np.sin(yaw)
        world = np.stack([
            lx * c - ly * s + cx, lx * s + ly * c + cy, lz + cz,
        ], 1)
        pts_list.append(world)

    xyz = np.concatenate(pts_list)
    if len(xyz) > n_cap:
        xyz = xyz[rng.permutation(len(xyz))[:n_cap]]
    extra = rng.random((len(xyz), point_dim - 3)).astype(np.float32)
    pts = np.concatenate([xyz, extra], 1).astype(np.float32)
    n = len(pts)
    pad = n_cap - n
    return dict(
        points=np.concatenate([pts, np.zeros((pad, point_dim), np.float32)]),
        batch_idx=np.zeros(n_cap, np.int32),
        valid=np.concatenate([np.ones(n, bool), np.zeros(pad, bool)]),
        gt_boxes=gt_boxes, gt_labels=gt_labels, gt_valid=gt_valid,
    )


def with_noaug_channels_array(points: np.ndarray) -> np.ndarray:
    """Append a copy of xyz as the last-3 'no-augmentation' channels."""
    return np.concatenate([points, points[:, :3]], axis=1)


def make_camera_arrays(
    gt_boxes: np.ndarray,
    gt_labels: np.ndarray,
    gt_valid: np.ndarray,
    batch_size=2,
    num_cams=2,
    num_classes=10,
    img_h=64,
    img_w=96,
    max_anno=32,
    fx=40.0,
) -> Dict[str, np.ndarray]:
    """Synthetic cameras + instance masks consistent with the GT boxes.

    Camera 0 looks along +x and every other camera along −x. Each visible
    GT box gets an anno row and a painted rectangle around its projected
    gravity center. Returns packed masks [B, cams, H, W, cls] uint16,
    anno [B, A, 9] and lidar2img [B, cams, 4, 4].
    """
    cams = []
    for ci in range(num_cams):
        s = 1.0 if ci == 0 else -1.0
        P = np.array(
            [
                [s * img_w / 2, s * fx, 0, 0],
                [s * img_h / 2, 0, fx, 0],
                [s, 0, 0, 0],
                [0, 0, 0, 1],
            ],
            np.float32,
        )
        cams.append(P)
    lidar2img = np.broadcast_to(
        np.stack(cams)[None], (batch_size, num_cams, 4, 4)
    ).copy()

    masks = np.zeros((batch_size, num_cams, img_h, img_w, num_classes), np.uint8)
    anno = np.zeros((batch_size, max_anno, 9), np.float32)
    for b in range(batch_size):
        row = 0
        for j in range(gt_boxes.shape[1]):
            if not gt_valid[b, j] or row >= max_anno:
                continue
            cx, cy = gt_boxes[b, j, 0], gt_boxes[b, j, 1]
            cz = gt_boxes[b, j, 2] + gt_boxes[b, j, 5] / 2
            ci = 0 if cx > 0 else 1
            s = 1.0 if ci == 0 else -1.0
            depth = s * cx
            if depth < 0.5:
                continue
            u = int(img_w / 2 + fx * s * cy / depth)
            v = int(img_h / 2 + fx * cz / depth)
            if not (0 <= u < img_w and 0 <= v < img_h):
                continue
            r = max(3, int(fx * max(gt_boxes[b, j, 3], gt_boxes[b, j, 4]) / depth / 2))
            u0, u1 = max(0, u - r), min(img_w, u + r + 1)
            v0, v1 = max(0, v - r), min(img_h, v + r + 1)
            cls = int(gt_labels[b, j])
            masks[b, ci, v0:v1, u0:u1, cls] = row + 1
            anno[b, row] = [u0, v0, u1, v1, 0.9, cls, ci, row, 1]
            row += 1
    return dict(masks=pack_mask_scores(masks, anno), anno=anno, lidar2img=lidar2img)


def make_av2_scene_arrays(seed=0, n_cap=131072, max_gt=128, num_classes=26):
    """(scene, cameras) of the JAX package's AV2 bench (``tools/bench_av2.py``),
    batch 1: one dual-LiDAR frame over the larger area (±190 m, 64 rings,
    48 facades, the two stacked LiDARs as 2 sweeps, 4-dim points, 48 GT
    boxes) and seven ring cameras at 1,024 x 775 with fx 900."""
    sc = make_lidar_scene_arrays(seed=seed, n_cap=n_cap, max_gt=max_gt, n_boxes=48,
                                 num_classes=num_classes, point_dim=4, extent=190.0, n_rings=64,
                                 pts_per_ring=1600, n_walls=48, sweeps=2)
    cam = make_camera_arrays(sc["gt_boxes"], sc["gt_labels"], sc["gt_valid"], batch_size=1,
                             num_cams=7, num_classes=num_classes, img_h=1024, img_w=775,
                             max_anno=250, fx=900.0)
    return sc, cam


CCL_CASES = ("random", "reversed_chain", "grid", "coincident", "mixed_batch", "all_invalid")


def ccl_problem_arrays(case: str, g: int, n: int, seed: int = 0):
    """(xy [g, n, 2] f32, batch [g, n] i32, valid [g, n] bool): G connected-
    component problems in the pre-scaled units of ``ops.ccl`` (adjacent iff
    dist < 1), built to stress a CCL kernel:

    - ``random``: uniform points at mean degree ~3 (near percolation, so long
      components), batch ids 0/1, 15 % invalid, problem 1 (if any) all
      invalid;
    - ``reversed_chain``: one chain 0.9 apart with node 0 at one end and the
      others numbered down from the far end (n-1, n-2, ..., 1), so the
      component minimum sits a whole chain away from most of its indices;
    - ``grid``: one component of all n nodes, a square grid 0.9 apart with
      shuffled indices;
    - ``coincident``: 8 stacks of identical points (d² = 0, complete graphs);
    - ``mixed_batch``: the stacks with batch ids 0/1/2 in one problem, which
      split each stack into three components;
    - ``all_invalid``: ``random`` with every node invalid.
    """
    rng = np.random.default_rng(seed)
    xy = np.zeros((g, n, 2), np.float32)
    batch = np.zeros((g, n), np.int32)
    valid = np.ones((g, n), bool)
    if case in ("random", "all_invalid"):
        side = np.sqrt(n * np.pi / 3.0)
        xy[:] = rng.uniform(0, side, (g, n, 2))
        batch[:] = rng.integers(0, 2, (g, n))
        valid[:] = rng.random((g, n)) > 0.15
        if g > 1:
            valid[1] = False
        if case == "all_invalid":
            valid[:] = False
    elif case == "reversed_chain":
        xy[:, 1:, 0] = 0.9 * (n - np.arange(1, n))
    elif case == "grid":
        w = int(np.ceil(np.sqrt(n)))
        pos = np.stack([np.arange(n) % w, np.arange(n) // w], -1) * 0.9
        for gi in range(g):
            xy[gi] = pos[rng.permutation(n)]
    elif case in ("coincident", "mixed_batch"):
        xy[:] = (rng.integers(0, 8, (g, n)) * 10.0)[..., None]
        if case == "mixed_batch":
            batch[:] = rng.integers(0, 3, (g, n))
    else:
        raise ValueError(f"unknown CCL case {case!r}; one of {CCL_CASES}")
    return xy, batch, valid


def ccl_known_components(n: int, seed: int = 0, chain: int = 100, stack: int = 50):
    """(xy [1, n, 2] f32, batch [1, n] i32, valid [1, n] bool, roots [1, n]
    i32): one CCL problem (units of ``ops.ccl``) whose components are known
    by construction, for N past what the plain version's [N, N] distances
    allow. Nine in ten nodes form, in turn, chains of ``chain`` nodes 0.9
    apart along x (only neighbours join) and stacks of ``stack`` coincident
    points (complete graphs), each structure on its own line 3 apart in y;
    the rest are invalid nodes at random places. Indices are shuffled, so a
    component's minimum lies anywhere in it. ``roots`` is each valid node's
    component minimum, -1 for an invalid node."""
    rng = np.random.default_rng(seed)
    n_valid = n - n // 10
    comp = np.empty(n_valid, np.int64)
    pos = np.zeros((n_valid, 2), np.float32)
    k = c = 0
    while k < n_valid:
        size = min(chain if c % 2 == 0 else stack, n_valid - k)
        comp[k:k + size] = c
        if c % 2 == 0:
            pos[k:k + size, 0] = np.arange(size, dtype=np.float32) * np.float32(0.9)
        pos[k:k + size, 1] = np.float32(3.0 * c)
        k += size
        c += 1
    node = rng.permutation(n)                 # slot i of the layout is node node[i]
    xy = rng.uniform(-50.0, 0.0, (n, 2)).astype(np.float32)
    valid = np.zeros(n, bool)
    xy[node[:n_valid]] = pos
    valid[node[:n_valid]] = True
    first = np.full(c, n, np.int64)
    np.minimum.at(first, comp, node[:n_valid])
    roots = np.full(n, -1, np.int32)
    roots[node[:n_valid]] = first[comp]
    return xy[None], np.zeros((1, n), np.int32), valid[None], roots[None]


def to_point_batch(arrays: Dict[str, np.ndarray], device="cuda") -> PointBatch:
    return PointBatch(
        points=torch.as_tensor(arrays["points"], device=device),
        batch_idx=torch.as_tensor(arrays["batch_idx"], device=device),
        valid=torch.as_tensor(arrays["valid"], device=device),
    )


def to_ground_truth(arrays: Dict[str, np.ndarray], device="cuda") -> GroundTruth:
    """The scene's padded GT (``gt_boxes``, ``gt_labels``, ``gt_valid``)."""
    return GroundTruth(
        boxes=torch.as_tensor(arrays["gt_boxes"], device=device),
        labels=torch.as_tensor(arrays["gt_labels"], device=device),
        valid=torch.as_tensor(arrays["gt_valid"], device=device),
    )


def to_camera_data(arrays: Dict[str, np.ndarray], device="cuda") -> CameraData:
    return CameraData.build(
        arrays["masks"], arrays["anno"], arrays["lidar2img"], device=device)


def fsf_inputs(scene: Dict[str, np.ndarray], cam: Dict[str, np.ndarray],
               device="cuda"):
    """(PointBatch with no-aug channels, CameraData) on ``device``."""
    pts = dict(scene, points=with_noaug_channels_array(scene["points"]))
    return to_point_batch(pts, device), to_camera_data(cam, device)


def train_scene(seed: int, cfg, batch_size: int = 2, scene_classes=None, device="cuda"):
    """(PointBatch with no-aug channels, CameraData, GroundTruth) of the JAX
    package's test scene (``make_scene_arrays``) at ``cfg``'s capacities,
    GT labels drawn from the first ``scene_classes`` classes (default all),
    and its cameras."""
    sc = make_scene_arrays(seed=seed, batch_size=batch_size, n_cap=cfg.caps.points,
                           max_gt=cfg.caps.max_gt, num_classes=scene_classes or cfg.num_classes)
    cam = make_camera_arrays(sc["gt_boxes"], sc["gt_labels"], sc["gt_valid"],
                             batch_size=batch_size, num_classes=cfg.num_classes)
    return (*fsf_inputs(sc, cam, device), to_ground_truth(sc, device))
