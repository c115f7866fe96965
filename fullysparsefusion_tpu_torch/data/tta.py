"""Test-time augmentation (the port's copy of the JAX package's
``data/tta.py``, plus :func:`fuse_union`, the rotated-NMS fusion that the
JAX test tool runs on the union).

Replaces MyMultiScaleFlipAug3D + MyGlobalRotScaleTrans's pinned-rotation
path (datasets/pipelines/test_time_aug.py:10-127, transforms_3d.py:90-94):
inference runs over a grid of (scale, rotation, flip) variants; each
variant's detections are transformed back into the original frame and the
union is fused with rotated NMS.
"""
from __future__ import annotations

from dataclasses import dataclass
from itertools import product
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from ..ops.nms import NMSResult, multiclass_nms_bev
from . import pipelines as P


@dataclass(frozen=True)
class TTAVariant:
    scale: float = 1.0
    rotation: float = 0.0
    flip_x: bool = False
    flip_y: bool = False

    def to_params(self) -> P.TransformParams:
        return P.TransformParams(
            rotation=self.rotation, scale=self.scale,
            flip_x=self.flip_x, flip_y=self.flip_y,
        )


def tta_grid(
    scales: Sequence[float] = (1.0,),
    rotations: Sequence[float] = (0.0,),
    flip_horizontal: bool = True,
    flip_vertical: bool = True,
) -> List[TTAVariant]:
    """The reference's scale × rotation × flip grid (test_time_aug.py:41-87)."""
    flips_x = [False, True] if flip_horizontal else [False]
    flips_y = [False, True] if flip_vertical else [False]
    return [
        TTAVariant(s, r, fx, fy)
        for s, r, fx, fy in product(scales, rotations, flips_x, flips_y)
    ]


def invert_boxes(boxes: np.ndarray, v: TTAVariant) -> np.ndarray:
    """Map detections from the augmented frame back to the original frame
    (inverse order: unflip → unrotate/unscale)."""
    out = boxes.copy()
    if v.flip_y:
        out = P.apply_boxes_transform(out, P.TransformParams(flip_y=True))
    if v.flip_x:
        out = P.apply_boxes_transform(out, P.TransformParams(flip_x=True))
    inv = P.TransformParams(rotation=-v.rotation, scale=1.0 / v.scale)
    out = P.apply_boxes_transform(out, inv)
    return out


def run_tta(
    points: np.ndarray,
    variants: Sequence[TTAVariant],
    infer_fn: Callable[[np.ndarray], Tuple[np.ndarray, np.ndarray, np.ndarray]],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Run ``infer_fn(points) -> (boxes, scores, labels)`` per variant and
    return the candidate union in the original frame (:func:`fuse_union`
    applies the final NMS)."""
    all_b, all_s, all_l = [], [], []
    for v in variants:
        aug = P.apply_points_transform(points, v.to_params())
        boxes, scores, labels = infer_fn(aug)
        if len(boxes):
            all_b.append(invert_boxes(boxes, v))
            all_s.append(scores)
            all_l.append(labels)
    if not all_b:
        return np.zeros((0, 9), np.float32), np.zeros(0, np.float32), np.zeros(0, np.int32)
    return np.concatenate(all_b), np.concatenate(all_s), np.concatenate(all_l)


def fuse_union(boxes: np.ndarray, scores: np.ndarray, labels: np.ndarray, num_classes: int,
               iou_thr: float, score_thr: float, max_num: int, device="cuda") -> NMSResult:
    """Fuse the union of :func:`run_tta` by per-class rotated NMS on
    ``device`` (one ``multiclass_nms_bev`` call, one K3 launch over C =
    ``num_classes`` and N = the union's size): each box scores only under
    its own label. Returns ``[max_num]`` leaves on ``device``."""
    n = len(boxes)
    smat = np.zeros((n, num_classes), np.float32)
    smat[np.arange(n), labels] = scores
    return multiclass_nms_bev(
        torch.as_tensor(np.asarray(boxes, np.float32), device=device),
        torch.as_tensor(smat, device=device), torch.ones(n, dtype=torch.bool, device=device),
        iou_thr, score_thr, max_num)
