"""Detections through the full decode path, as the evaluation's records
(the port's counterparts of ``tools/train_to_map.py``'s helpers): the
model's eval-form forward, ``FSF.get_bboxes`` (rotated NMS), and one
:class:`DetectionRecord` per sample with its valid ground truth."""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from ..models.camera import CameraData
from ..utils.containers import GroundTruth, PointBatch
from .detection import DetectionRecord, evaluate_detections

Scene = Tuple[PointBatch, CameraData, GroundTruth]


def records_from_bboxes(res, gt: GroundTruth, batch_size: int) -> List[DetectionRecord]:
    """``FSF.get_bboxes`` result + ``GroundTruth`` → one record per sample:
    the valid detections (boxes, scores, labels) and the valid GT's first 9
    box columns and labels."""
    res = type(res)(*(t.cpu().numpy() for t in res))
    gt_boxes, gt_labels, gt_valid = (t.cpu().numpy() for t in (gt.boxes, gt.labels, gt.valid))
    recs = []
    for b in range(batch_size):
        v, gv = res.valid[b], gt_valid[b]
        recs.append(DetectionRecord(
            boxes=res.boxes[b][v], scores=res.scores[b][v], labels=res.labels[b][v],
            gt_boxes=gt_boxes[b][gv, :9], gt_labels=gt_labels[b][gv]))
    return recs


def scene_records(model, scenes: Sequence[Scene], batch_size: int) -> List[DetectionRecord]:
    """The records of every scene, through the eval-form forward and
    ``get_bboxes``."""
    recs: List[DetectionRecord] = []
    with torch.inference_mode():
        for pb, cam, gt in scenes:
            res = model.get_bboxes(model(pb, cam, batch_size, train=False), batch_size)
            recs.extend(records_from_bboxes(res, gt, batch_size))
    return recs


def eval_map(model, scenes: Sequence[Scene], batch_size: int,
             class_names: Sequence[str]) -> Dict:
    """The detection metrics (``mAP``, per-class AP and TP errors) over a
    pool of scenes through the full decode path."""
    return evaluate_detections(scene_records(model, scenes, batch_size), len(class_names),
                               class_names)

