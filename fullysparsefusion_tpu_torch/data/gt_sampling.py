"""GT-database copy-paste augmentation (the port's copy of the JAX package's
``data/gt_sampling.py``: the same database pickle, and with one seed the
same pasted samples).

Replaces mmdet3d's ObjectSample + the reference's MyObjectSample
(loading.py:416-533): a database of per-object point crops is pasted into
training scenes with BEV collision checks. Pasted objects carry a
velocity-validity flag of 0 (their velocity loss is masked —
sparse_cluster_head_v2.py:425-432) and their no-aug xyz channels are set to
a far-away sentinel so camera-mask projection never matches them
(encode_sampled_pts semantics, loading.py:450-465).
"""
from __future__ import annotations

import os
import pickle
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

NOAUG_SENTINEL = 1e4  # projected far outside every camera


def build_gt_database(
    samples,
    class_names: Sequence[str],
    out_path: str,
    min_points: int = 5,
):
    """Crop per-object points from training samples into a database pickle.

    ``samples`` yields dicts with "points" [N, D], "gt_boxes" [M, 7+],
    "gt_labels" [M].
    """
    db: Dict[int, List[Dict]] = {i: [] for i in range(len(class_names))}
    for s in samples:
        pts = s["points"]
        for j in range(len(s["gt_boxes"])):
            box = s["gt_boxes"][j]
            label = int(s["gt_labels"][j])
            if label < 0:
                continue
            m = _points_in_box_np(pts[:, :3], box)
            if m.sum() < min_points:
                continue
            local = pts[m].copy()
            local[:, :3] -= box[:3]
            db[label].append(dict(points=local, box=box.copy()))
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "wb") as f:
        pickle.dump(db, f)
    return {k: len(v) for k, v in db.items()}


def _points_in_box_np(xyz: np.ndarray, box: np.ndarray) -> np.ndarray:
    c, s = np.cos(-box[6]), np.sin(-box[6])
    rel = xyz - np.array([box[0], box[1], box[2] + box[5] / 2])
    lx = rel[:, 0] * c - rel[:, 1] * s
    ly = rel[:, 0] * s + rel[:, 1] * c
    return (
        (np.abs(lx) <= box[3] / 2)
        & (np.abs(ly) <= box[4] / 2)
        & (np.abs(rel[:, 2]) <= box[5] / 2)
    )


def _bev_overlap(a: np.ndarray, boxes: np.ndarray) -> bool:
    """Cheap circle-overlap collision test in BEV."""
    if len(boxes) == 0:
        return False
    ra = 0.5 * np.hypot(a[3], a[4])
    rb = 0.5 * np.hypot(boxes[:, 3], boxes[:, 4])
    d = np.hypot(boxes[:, 0] - a[0], boxes[:, 1] - a[1])
    return bool((d < ra + rb).any())


@dataclass
class GTPasteSampler:
    """Paste up to ``max_per_class[c]`` extra objects of each class."""

    db_path: str
    max_per_class: Dict[int, int]
    seed: int = 0

    def __post_init__(self):
        with open(self.db_path, "rb") as f:
            self.db = pickle.load(f)
        self.rng = np.random.default_rng(self.seed)

    def __call__(self, sample: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        points = sample["points"]
        gt_boxes = sample["gt_boxes"]
        gt_labels = sample["gt_labels"]
        point_dim = points.shape[1]
        has_noaug = point_dim >= 8  # xyz + feats + saved noaug xyz

        new_pts, new_boxes, new_labels = [], [], []
        occupied = (
            gt_boxes[:, :7].copy() if len(gt_boxes) else np.zeros((0, 7), np.float32)
        )
        for cls, k in self.max_per_class.items():
            pool = self.db.get(cls, [])
            if not pool:
                continue
            picks = self.rng.choice(len(pool), size=min(k, len(pool)), replace=False)
            for pi in picks:
                obj = pool[pi]
                box = obj["box"].copy()
                if _bev_overlap(box, occupied):
                    continue
                occupied = np.concatenate([occupied, box[None, :7]])
                pts = obj["points"].copy()
                pts[:, :3] += box[:3]
                if pts.shape[1] < point_dim:
                    pad = np.zeros((len(pts), point_dim - pts.shape[1]), np.float32)
                    pts = np.concatenate([pts, pad], 1)
                elif pts.shape[1] > point_dim:
                    pts = pts[:, :point_dim]
                if has_noaug:
                    pts[:, -3:] = NOAUG_SENTINEL  # never hits a camera mask
                new_pts.append(pts)
                b10 = np.zeros(10, np.float32)
                b10[: min(len(box), 9)] = box[: min(len(box), 9)]
                b10[9] = 0.0  # pasted: velocity loss masked
                new_boxes.append(b10)
                new_labels.append(cls)

        if not new_pts:
            return sample
        out = dict(sample)
        out["points"] = np.concatenate([points] + new_pts)
        gb = gt_boxes
        if gb.shape[1] < 10:
            pad = np.zeros((len(gb), 10 - gb.shape[1]), np.float32)
            if gb.shape[1] <= 9:
                pad[:, -1] = 1.0
            gb = np.concatenate([gb, pad], 1)
        out["gt_boxes"] = np.concatenate([gb, np.stack(new_boxes)])
        out["gt_labels"] = np.concatenate([gt_labels, np.asarray(new_labels, np.int32)])
        if "no_aug_gt_boxes" in out:
            na = out["no_aug_gt_boxes"]
            if len(na) and na.shape[1] < 10:
                pad = np.zeros((len(na), 10 - na.shape[1]), np.float32)
                na = np.concatenate([na, pad], 1)
            sentinel_rows = np.stack(new_boxes).copy()
            sentinel_rows[:, :2] = NOAUG_SENTINEL  # off-camera in no-aug frame
            out["no_aug_gt_boxes"] = (
                np.concatenate([na, sentinel_rows]) if len(na) else sentinel_rows
            )
        return out
