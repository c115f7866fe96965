"""Frozen copies of the program's scene and camera generators.

``make_lidar_scene_arrays``, ``make_camera_arrays``, ``pack_mask_scores`` and
``with_noaug_channels_array`` are copied from the program (``synthetic.py``,
``data/masks.py``) so that a later change to the program cannot change the
benchmark's inputs; ``tests/test_bench_scenes.py`` pins their seed-0
checksums. :func:`camera_tensors` paints the same packed planes as
``make_camera_arrays`` + ``pack_mask_scores``, but on the device, from the
host's list of rectangles: the planes are hundreds of MiB a frame.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch


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


def pack_mask_scores(masks_u8: np.ndarray, anno: np.ndarray) -> np.ndarray:
    """Pack per-pixel (instance id, quantized score) into one uint16:
    value = id | round(score·255) << 8, id = anno row + 1 (0 = background).
    anno may be [A, 9] or [B, A, 9] matching masks [cams, ...] or [B, cams, ...]."""
    masks_u8 = np.asarray(masks_u8)
    anno = np.asarray(anno)
    if anno.ndim == 2:
        score_u8 = np.zeros(anno.shape[0] + 1, np.uint16)
        score_u8[1:] = np.round(anno[:, 4] * 255).astype(np.uint16)
        packed = masks_u8.astype(np.uint16) | (score_u8[masks_u8] << 8)
        return packed
    if anno.ndim != 3 or masks_u8.shape[0] != anno.shape[0]:
        raise ValueError("anno must be [A, 9] or [B, A, 9] matching masks")
    return np.stack(
        [pack_mask_scores(masks_u8[b], anno[b]) for b in range(anno.shape[0])]
    )


def _lidar2img(batch_size: int, num_cams: int, img_h: int, img_w: int, fx: float) -> np.ndarray:
    cams = []
    for ci in range(num_cams):
        s = 1.0 if ci == 0 else -1.0
        cams.append(np.array([
            [s * img_w / 2, s * fx, 0, 0],
            [s * img_h / 2, 0, fx, 0],
            [s, 0, 0, 0],
            [0, 0, 0, 1],
        ], np.float32))
    return np.broadcast_to(np.stack(cams)[None], (batch_size, num_cams, 4, 4)).copy()


def camera_rectangles(gt_boxes, gt_labels, gt_valid, batch_size=2, num_cams=2, img_h=64,
                      img_w=96, max_anno=32, fx=40.0) -> Tuple[np.ndarray, np.ndarray,
                                                                List[Tuple[int, ...]]]:
    """(anno [B, A, 9], lidar2img [B, cams, 4, 4], rectangles): camera 0
    looks along +x, every other camera along −x; each visible GT box gets an
    anno row and a rectangle ``(b, cam, v0, v1, u0, u1, cls, row)`` around
    its projected gravity center, painted in this order."""
    lidar2img = _lidar2img(batch_size, num_cams, img_h, img_w, fx)
    anno = np.zeros((batch_size, max_anno, 9), np.float32)
    rects = []
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
            rects.append((b, ci, v0, v1, u0, u1, cls, row))
            anno[b, row] = [u0, v0, u1, v1, 0.9, cls, ci, row, 1]
            row += 1
    return anno, lidar2img, rects


def make_camera_arrays(gt_boxes, gt_labels, gt_valid, batch_size=2, num_cams=2,
                       num_classes=10, img_h=64, img_w=96, max_anno=32,
                       fx=40.0) -> Dict[str, np.ndarray]:
    """Synthetic cameras + instance masks consistent with the GT boxes (the
    program's generator): packed masks [B, cams, H, W, cls] uint16, anno
    [B, A, 9] and lidar2img [B, cams, 4, 4]."""
    anno, lidar2img, rects = camera_rectangles(gt_boxes, gt_labels, gt_valid, batch_size,
                                               num_cams, img_h, img_w, max_anno, fx)
    masks = np.zeros((batch_size, num_cams, img_h, img_w, num_classes), np.uint8)
    for b, ci, v0, v1, u0, u1, cls, row in rects:
        masks[b, ci, v0:v1, u0:u1, cls] = row + 1
    return dict(masks=pack_mask_scores(masks, anno), anno=anno, lidar2img=lidar2img)


def camera_tensors(gt_boxes, gt_labels, gt_valid, device, batch_size=1, num_cams=6,
                   num_classes=10, img_h=450, img_w=800, max_anno=250,
                   fx=400.0) -> Dict[str, object]:
    """:func:`make_camera_arrays`'s cameras as the model reads them, painted
    on ``device``: masks ``[B·cams·H·W, cls]`` int32 (the packed planes,
    flat and channel-last), anno, lidar2img, img_h, img_w."""
    anno, lidar2img, rects = camera_rectangles(gt_boxes, gt_labels, gt_valid, batch_size,
                                               num_cams, img_h, img_w, max_anno, fx)
    planes = torch.zeros(batch_size, num_cams, img_h, img_w, num_classes, dtype=torch.int32,
                         device=device)
    for b, ci, v0, v1, u0, u1, cls, row in rects:
        score = int(np.round(np.float32(anno[b, row, 4]) * 255))
        planes[b, ci, v0:v1, u0:u1, cls] = (row + 1) | (score << 8)
    return dict(masks=planes.view(-1, num_classes),
                anno=torch.as_tensor(anno, device=device),
                lidar2img=torch.as_tensor(lidar2img, device=device),
                img_h=int(img_h), img_w=int(img_w))
