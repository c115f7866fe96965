"""Argoverse 2 dataset: info-pkl reader + AV2-format feather export (the
port's copy of the JAX package's ``data/av2.py``, NumPy only).

Replaces Argo2Dataset (datasets/argo2_dataset.py:25-705): consumes the
KITTI-style info pickles produced by the AV2 preparation tool
(tools/AV2/argo2_pickle_mmdet_fusion.py — re-implemented in
``cli/prepare_av2.py``), emits fixed-shape batches, and formats detections
back into the av2 evaluation feather schema (lidar_box_to_argo2 semantics:
bottom-center xyz → gravity center, yaw → quaternion wxyz).
"""
from __future__ import annotations

import os
import pickle
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from . import feather
from . import pipelines as P

LABEL_ATTR = (
    "tx_m", "ty_m", "tz_m", "length_m", "width_m", "height_m",
    "qw", "qx", "qy", "qz",
)


def yaw_to_quat_wxyz(yaw: np.ndarray) -> np.ndarray:
    """[N] yaw around +z → [N, 4] (w, x, y, z) (argo2_utils.py:5-59)."""
    half = yaw * 0.5
    return np.stack(
        [np.cos(half), np.zeros_like(half), np.zeros_like(half), np.sin(half)], 1
    )


def boxes_to_av2_rows(
    boxes: np.ndarray,    # [N, 7+] bottom-center LiDAR boxes
    scores: np.ndarray,
    labels: np.ndarray,
    class_names: Sequence[str],
    log_id: str,
    timestamp_ns: int,
):
    """Detection rows in av2.evaluation.detection feather schema."""
    rows = []
    quat = yaw_to_quat_wxyz(boxes[:, 6])
    for i in range(len(boxes)):
        rows.append(
            dict(
                tx_m=float(boxes[i, 0]),
                ty_m=float(boxes[i, 1]),
                tz_m=float(boxes[i, 2] + boxes[i, 5] / 2),
                length_m=float(boxes[i, 3]),
                width_m=float(boxes[i, 4]),
                height_m=float(boxes[i, 5]),
                qw=float(quat[i, 0]), qx=float(quat[i, 1]),
                qy=float(quat[i, 2]), qz=float(quat[i, 3]),
                score=float(scores[i]),
                category=class_names[int(labels[i])].upper(),
                log_id=log_id,
                timestamp_ns=int(timestamp_ns),
            )
        )
    return rows


def write_feather(rows: List[dict], path: str) -> None:
    """The rows as a Feather V2 file, the one ``pd.DataFrame(rows).to_feather``
    writes (``data/feather.py``; no pandas)."""
    feather.write_feather(rows, path)


@dataclass
class AV2Reader:
    """Single-frame AV2 samples from prepared info pickles (4-dim points)."""

    info_path: str
    data_root: str
    class_names: Sequence[str]
    training: bool = True
    point_cloud_range: Sequence[float] = (-204.8, -204.8, -3.2, 204.8, 204.8, 3.2)
    seed: int = 0

    def __post_init__(self):
        with open(self.info_path, "rb") as f:
            data = pickle.load(f)
        self.infos = data["infos"] if isinstance(data, dict) else data
        self.rng = np.random.default_rng(self.seed)

    def __len__(self):
        return len(self.infos)

    def sample(self, i: int, augment: bool = True) -> Dict[str, np.ndarray]:
        info = self.infos[i]
        pts_path = os.path.join(
            self.data_root, info.get("lidar_path", info.get("velodyne_path", ""))
        )
        points = np.fromfile(pts_path, dtype=np.float32).reshape(-1, 4)
        name_to_id = {n: j for j, n in enumerate(self.class_names)}
        gt_boxes = np.asarray(info.get("gt_boxes", np.zeros((0, 7))), np.float32)
        gt_labels = np.asarray(
            [name_to_id.get(n, -1) for n in info.get("gt_names", [])], np.int32
        )
        keep = gt_labels >= 0
        gt_boxes, gt_labels = gt_boxes[keep], gt_labels[keep]

        points = P.save_noaug_channels(points)
        no_aug_gt = gt_boxes.copy()
        if self.training and augment:
            tp = P.sample_transform_params(self.rng)
            live = P.apply_points_transform(points[:, :-3], tp)
            points = np.concatenate([live, points[:, -3:]], 1)
            gt_boxes = P.apply_boxes_transform(gt_boxes, tp)
        points = P.filter_points_range(points, self.point_cloud_range)
        r = self.point_cloud_range
        gt_boxes, gt_labels, (no_aug_gt,) = P.filter_boxes_range(
            gt_boxes, gt_labels, (r[0], r[1], r[3], r[4]), [no_aug_gt]
        )
        if self.training:
            points = P.shuffle_points(points, self.rng)
        return dict(
            points=points,
            gt_boxes=gt_boxes,
            gt_labels=gt_labels,
            no_aug_gt_boxes=no_aug_gt,
            log_id=info.get("log_id", ""),
            timestamp_ns=info.get("timestamp_ns", 0),
            lidar2img=np.asarray(info["lidar2img"], np.float32)
            if "lidar2img" in info
            else None,
        )

    def format_results(self, detections, out_path: str, class_names=None):
        """Detections [(boxes, scores, labels, log_id, ts)] → feather file
        compatible with av2.evaluation.detection.evaluate."""
        class_names = class_names or self.class_names
        rows: List[dict] = []
        for boxes, scores, labels, log_id, ts in detections:
            rows.extend(
                boxes_to_av2_rows(boxes, scores, labels, class_names, log_id, ts)
            )
        write_feather(rows, out_path)
        return out_path
