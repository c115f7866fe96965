"""Data pipeline transforms, NumPy on the host (the port's copy of the JAX
package's ``data/pipelines.py``: the same rng gives the same arrays). The
model consumes fixed-shape padded batches; augmentation runs on the host like
the reference's CPU workers.

Replaces the reference pipeline stages (SURVEY.md §2.6):
  * GlobalRotScaleTrans / RandomFlip3D (transforms_3d.py / mmdet3d stock)
  * SaveNoAugPoints (loading.py:342-354) — raw xyz appended as the last 3
    point channels *before* augmentation so mask projection stays in camera
    geometry;
  * MyObjectRangeFilter (loading.py:356-414) — range filter keeping the
    no-aug GT table row-aligned;
  * NormalizePoints (loading.py:536-570) — intensity / 255;
  * PointShuffle, and final fixed-capacity collation.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class TransformParams:
    rotation: float = 0.0          # radians around +z
    scale: float = 1.0
    translation: np.ndarray = None  # [3]
    flip_x: bool = False            # flip over x axis (y → −y)
    flip_y: bool = False            # flip over y axis (x → −x)

    def __post_init__(self):
        if self.translation is None:
            self.translation = np.zeros(3, np.float32)


def sample_transform_params(
    rng: np.random.Generator,
    rot_range=(-0.78539816, 0.78539816),
    scale_range=(0.95, 1.05),
    translation_std=(0.0, 0.0, 0.0),
    flip_ratio_bev_horizontal=0.5,
    flip_ratio_bev_vertical=0.5,
) -> TransformParams:
    """Matches the nuScenes train pipeline aug ranges
    (configs/_base_/datasets/nuscenes_dataloader.py:72-80 semantics)."""
    return TransformParams(
        rotation=float(rng.uniform(*rot_range)),
        scale=float(rng.uniform(*scale_range)),
        translation=rng.normal(0, translation_std, 3).astype(np.float32),
        flip_x=bool(rng.random() < flip_ratio_bev_horizontal),
        flip_y=bool(rng.random() < flip_ratio_bev_vertical),
    )


def _rot_z(xyz: np.ndarray, angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    out = xyz.copy()
    out[:, 0] = xyz[:, 0] * c - xyz[:, 1] * s
    out[:, 1] = xyz[:, 0] * s + xyz[:, 1] * c
    return out


def apply_points_transform(points: np.ndarray, tp: TransformParams) -> np.ndarray:
    """Rotate→scale→translate→flip the xyz channels (mmdet3d order)."""
    out = points.copy()
    xyz = _rot_z(out[:, :3], tp.rotation) * tp.scale + tp.translation
    if tp.flip_x:
        xyz[:, 1] = -xyz[:, 1]
    if tp.flip_y:
        xyz[:, 0] = -xyz[:, 0]
    out[:, :3] = xyz
    return out


def apply_boxes_transform(boxes: np.ndarray, tp: TransformParams) -> np.ndarray:
    """Same transform on [M, 7+] boxes (bottom-center, yaw, velocity)."""
    out = boxes.copy()
    out[:, :3] = _rot_z(out[:, :3], tp.rotation) * tp.scale + tp.translation
    out[:, 3:6] *= tp.scale
    out[:, 6] += tp.rotation
    if out.shape[1] >= 9:
        out[:, 7:9] = _rot_z(
            np.concatenate([out[:, 7:9], np.zeros((len(out), 1))], 1), tp.rotation
        )[:, :2] * tp.scale
    if tp.flip_x:
        out[:, 1] = -out[:, 1]
        out[:, 6] = -out[:, 6]
        if out.shape[1] >= 9:
            out[:, 8] = -out[:, 8]
    if tp.flip_y:
        out[:, 0] = -out[:, 0]
        out[:, 6] = np.pi - out[:, 6]
        if out.shape[1] >= 9:
            out[:, 7] = -out[:, 7]
    return out


def save_noaug_channels(points: np.ndarray) -> np.ndarray:
    """Append raw xyz as extra channels BEFORE augmentation
    (SaveNoAugPoints, loading.py:342-354)."""
    return np.concatenate([points, points[:, :3].copy()], axis=1)


def filter_points_range(points: np.ndarray, pc_range: Sequence[float]) -> np.ndarray:
    xyz = points[:, :3]
    m = (
        (xyz[:, 0] >= pc_range[0]) & (xyz[:, 0] < pc_range[3])
        & (xyz[:, 1] >= pc_range[1]) & (xyz[:, 1] < pc_range[4])
        & (xyz[:, 2] >= pc_range[2]) & (xyz[:, 2] < pc_range[5])
    )
    return points[m]


def filter_boxes_range(
    boxes: np.ndarray,
    labels: np.ndarray,
    bev_range: Sequence[float],
    extra: Optional[List[np.ndarray]] = None,
):
    """BEV range filter keeping auxiliary (e.g. no-aug) tables row-aligned
    (MyObjectRangeFilter, loading.py:356-414)."""
    m = (
        (boxes[:, 0] >= bev_range[0]) & (boxes[:, 0] < bev_range[2])
        & (boxes[:, 1] >= bev_range[1]) & (boxes[:, 1] < bev_range[3])
    )
    out_extra = [e[m] for e in extra] if extra is not None else None
    return boxes[m], labels[m], out_extra


def normalize_intensity(points: np.ndarray, dim: int = 3, divisor: float = 255.0):
    out = points.copy()
    out[:, dim] = out[:, dim] / divisor
    return out


def shuffle_points(points: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    return points[rng.permutation(len(points))]


def collate_scene(
    samples: List[Dict[str, np.ndarray]],
    n_points_cap: int,
    max_gt: int,
):
    """Pad a list of per-sample dicts into fixed-shape batch arrays.

    Each sample: {"points": [Ni, D], "gt_boxes": [Mi, ≤10], "gt_labels": [Mi]}
    (optionally "no_aug_gt_boxes"). Returns dict of stacked numpy arrays
    ready to wrap into PointBatch / GroundTruth.
    """
    b = len(samples)
    d = samples[0]["points"].shape[1]
    points = np.zeros((n_points_cap, d), np.float32)
    batch_idx = np.zeros(n_points_cap, np.int32)
    valid = np.zeros(n_points_cap, bool)
    cursor = 0
    for i, s in enumerate(samples):
        p = s["points"]
        take = min(len(p), n_points_cap - cursor)
        points[cursor:cursor + take] = p[:take]
        batch_idx[cursor:cursor + take] = i
        valid[cursor:cursor + take] = True
        cursor += take

    def pad_gt(key):
        boxes = np.zeros((b, max_gt, 10), np.float32)
        labels = np.full((b, max_gt), -1, np.int32)
        gvalid = np.zeros((b, max_gt), bool)
        for i, s in enumerate(samples):
            gb = np.asarray(s[key], np.float32)
            gl = np.asarray(s["gt_labels"], np.int32)
            m = min(len(gb), max_gt)
            if gb.shape[1] < 10:  # pad vel / flag columns
                pad_cols = np.zeros((len(gb), 10 - gb.shape[1]), np.float32)
                if gb.shape[1] <= 9:
                    pad_cols[:, -1] = 1.0  # vel-valid flag default
                gb = np.concatenate([gb, pad_cols], 1)
            boxes[i, :m] = gb[:m]
            labels[i, :m] = gl[:m]
            gvalid[i, :m] = True
        return boxes, labels, gvalid

    out = dict(points=points, batch_idx=batch_idx, valid=valid)
    if "gt_boxes" in samples[0]:
        out["gt_boxes"], out["gt_labels"], out["gt_valid"] = pad_gt("gt_boxes")
    if "no_aug_gt_boxes" in samples[0]:
        out["no_aug_gt_boxes"], _, _ = pad_gt("no_aug_gt_boxes")
    return out
