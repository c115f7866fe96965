"""Greedy NMS of axis-aligned 2D boxes, one class at a time (the benchmark's
HTC reference).

The IoU matrix is computed in f32 where the boxes are; the greedy scan runs
on the host: rows in descending score order (the lower index first among
ties), invalid rows never kept and never suppressing, and a kept row
suppresses every later row whose IoU with it exceeds the threshold."""
from __future__ import annotations

import numpy as np
import torch


def iou_2d(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU [N, M] of xyxy boxes (an empty overlap is 0; areas as ``x2 − x1``
    times ``y2 − y1``)."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / (area_a[:, None] + area_b[None, :] - inter).clamp(min=1e-8)


def greedy_keep(iou: np.ndarray, scores: np.ndarray, valid: np.ndarray,
                thr: float) -> np.ndarray:
    """Keep mask [N] (original order) of one class's greedy NMS."""
    order = np.argsort(-np.where(valid, scores, -np.inf), kind="stable")
    keep = np.zeros(len(scores), bool)
    suppressed = np.zeros(len(scores), bool)
    for i in order:
        if not valid[i]:
            break
        if suppressed[i]:
            continue
        keep[i] = True
        suppressed |= iou[i] > thr
    return keep
