"""nuScenes dataset reader: info pickles → fixed-shape training batches (the
port's copy of the JAX package's ``data/nuscenes.py``: with the same seed it
draws the same generator sequence and gives the same samples, bitwise; the
``.bin`` files are read by the host library, ``native.read_points``).

Replaces the reference's mmdet3d NuScenesDataset + pipeline stack
(configs/_base_/datasets/nuscenes_dataloader.py:53-95): load points (5-dim)
→ aggregate 9 past sweeps with per-sweep ego-motion transform and Δt channel
→ annotations → SaveNoAugPoints → geometric aug → range filter → shuffle →
intensity normalize → fixed-capacity collation. Mask data comes from the
offline 2D pre-inference directory (see ``masks.py``).
"""
from __future__ import annotations

import os
import pickle
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..eval.detection import ATTR_ID
from . import native
from . import pipelines as P
from .cbgs import class_balanced_indices

NUSC_CLASS_MAP = {
    "vehicle.car": "car", "vehicle.truck": "truck", "vehicle.trailer": "trailer",
    "vehicle.bus.bendy": "bus", "vehicle.bus.rigid": "bus",
    "vehicle.construction": "construction_vehicle",
    "vehicle.bicycle": "bicycle", "vehicle.motorcycle": "motorcycle",
    "human.pedestrian.adult": "pedestrian", "human.pedestrian.child": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "human.pedestrian.police_officer": "pedestrian",
    "movable_object.trafficcone": "traffic_cone",
    "movable_object.barrier": "barrier",
}


# mmdet3d create_data camera enumeration order — masks and lidar2img rows
# must align per camera index (nuscenes_converter.py camera_types)
NUSC_CAMERA_ORDER = (
    "CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_FRONT_LEFT",
    "CAM_BACK", "CAM_BACK_LEFT", "CAM_BACK_RIGHT",
)


def ordered_cam_names(cams: Dict[str, Dict]) -> List[str]:
    """Canonical camera enumeration shared by every consumer of a ``cams``
    dict (this reader and tools/generate_masks.py): standard nuScenes
    names first in NUSC_CAMERA_ORDER, then any non-standard names sorted —
    deterministic regardless of dict insertion order, so mask rows and
    lidar2img rows always pair up."""
    std = [n for n in NUSC_CAMERA_ORDER if n in cams]
    extra = sorted(n for n in cams if n not in NUSC_CAMERA_ORDER)
    return std + extra


def lidar2img_from_cams(cams: Dict[str, Dict]) -> np.ndarray:
    """[num_cams, 4, 4] lidar→image matrices from an mmdet3d info pickle's
    per-camera ``cams`` entries.

    Real ``NuScenesDataset`` pickles do NOT store ``lidar2img``; the
    reference derives it in ``get_data_info`` (mmdet3d
    nuscenes_dataset.py) from ``sensor2lidar_rotation/translation`` and
    ``cam_intrinsic`` — this reproduces that math exactly (row-vector
    build, transposed at the end). Camera rows follow ordered_cam_names.
    """
    names = ordered_cam_names(cams)
    mats = []
    for name in names:
        ci = cams[name]
        r = np.asarray(ci["sensor2lidar_rotation"], np.float64)
        t = np.asarray(ci["sensor2lidar_translation"], np.float64)
        lidar2cam_r = np.linalg.inv(r)
        lidar2cam_t = t @ lidar2cam_r.T
        rt = np.eye(4)
        rt[:3, :3] = lidar2cam_r.T
        rt[3, :3] = -lidar2cam_t
        intrinsic = np.asarray(ci["cam_intrinsic"], np.float64)
        viewpad = np.eye(4)
        viewpad[: intrinsic.shape[0], : intrinsic.shape[1]] = intrinsic
        mats.append(viewpad @ rt.T)
    return np.asarray(mats, np.float32)


def load_points_bin(path: str, load_dim: int = 5, use_dim: int = 5) -> np.ndarray:
    pts = native.read_points(path, load_dim)
    return pts[:, :use_dim]


def load_virtual_points(path: str, point_dim: int = 5) -> np.ndarray:
    """MVP-style virtual points stored alongside the sweep (reference
    load_vpts, loading.py:644-659): .npy/.bin files of painted points that
    concatenate with the real returns."""
    if path.endswith(".npy"):
        vp = np.load(path)
    else:
        vp = np.fromfile(path, dtype=np.float32).reshape(-1, point_dim)
    return vp[:, :point_dim].astype(np.float32)


def aggregate_sweeps(
    info: Dict,
    data_root: str,
    num_sweeps: int = 9,
    rng: Optional[np.random.Generator] = None,
    virtual_points_dir: Optional[str] = None,
) -> np.ndarray:
    """Key frame + up to ``num_sweeps`` past sweeps in key-frame coordinates,
    with a Δt (time-lag) channel appended (mmdet3d LoadPointsFromMultiSweeps
    semantics used by the shipped configs)."""
    key = load_points_bin(os.path.join(data_root, info["lidar_path"]))
    if virtual_points_dir:
        vp_path = os.path.join(
            virtual_points_dir,
            os.path.basename(info["lidar_path"]) + ".vp.npy",
        )
        if os.path.isfile(vp_path):
            key = np.concatenate([key, load_virtual_points(vp_path, key.shape[1])])
    key_time = info["timestamp"] / 1e6
    out = [np.concatenate([key, np.zeros((len(key), 1), np.float32)], 1)]
    sweeps = info.get("sweeps", [])
    if rng is not None and len(sweeps) > num_sweeps:
        # training: random sweep subset (LoadPointsFromMultiSweeps, mmdet3d
        # loading.py: np.random.choice without replacement when not test_mode)
        chosen = [sweeps[i] for i in sorted(
            rng.choice(len(sweeps), num_sweeps, replace=False)
        )]
    else:
        chosen = sweeps[:num_sweeps]
    for sw in chosen:
        pts = load_points_bin(os.path.join(data_root, sw["data_path"]))
        # remove_close=True (reference nuscenes_dataloader.py:70): drop
        # near-ego returns in the SENSOR frame before ego-motion compensation
        # so past ego/vehicle body points don't smear through the key frame.
        close = (np.abs(pts[:, 0]) < 1.0) & (np.abs(pts[:, 1]) < 1.0)
        pts = pts[~close]
        r = np.asarray(sw["sensor2lidar_rotation"], np.float32)
        t = np.asarray(sw["sensor2lidar_translation"], np.float32)
        xyz = pts[:, :3] @ r.T + t
        dt = key_time - sw["timestamp"] / 1e6
        out.append(
            np.concatenate(
                [xyz, pts[:, 3:], np.full((len(pts), 1), dt, np.float32)], 1
            )
        )
    return np.concatenate(out)


@dataclass
class NuScenesReader:
    """Iterates info-pkl samples into the collated training dicts."""

    info_path: str
    data_root: str
    class_names: Sequence[str]
    num_sweeps: int = 9
    training: bool = True
    point_cloud_range: Sequence[float] = (-51.2, -51.2, -5.0, 51.2, 51.2, 3.0)
    with_cbgs: bool = True
    seed: int = 0
    # GT-paste augmentation (MyObjectSample, loading.py:416-533): a
    # GTPasteSampler instance; ``paste_enabled`` is flipped by the train loop
    # from RuntimeSchedule.augmentation_enabled (DisableAugmentationHook).
    gt_sampler: Optional[object] = None
    paste_enabled: bool = True
    # host time spent so far, ms: "read" (``sample`` without the paste),
    # "paste" (the GT sampler) and "collate" (``batches``' collation)
    host_ms: Dict[str, float] = field(
        default_factory=lambda: {"read": 0.0, "paste": 0.0, "collate": 0.0})

    def __post_init__(self):
        with open(self.info_path, "rb") as f:
            data = pickle.load(f)
        self.infos = data["infos"] if isinstance(data, dict) else data
        self.rng = np.random.default_rng(self.seed)
        self._indices = np.arange(len(self.infos))
        if self.training and self.with_cbgs:
            name_to_id = {n: i for i, n in enumerate(self.class_names)}
            sample_classes = []
            for info in self.infos:
                ids = []
                for name in info.get("gt_names", []):
                    mapped = NUSC_CLASS_MAP.get(name, name)
                    if mapped in name_to_id:
                        ids.append(name_to_id[mapped])
                sample_classes.append(ids)
            self._indices = class_balanced_indices(
                sample_classes, len(self.class_names), self.rng
            )

    def __len__(self):
        return len(self._indices)

    def sample(self, i: int, augment: bool = True) -> Dict[str, np.ndarray]:
        t0 = time.perf_counter()
        paste0 = self.host_ms["paste"]
        out = self._sample(i, augment)
        self.host_ms["read"] += ((time.perf_counter() - t0) * 1e3
                                 - (self.host_ms["paste"] - paste0))
        return out

    def _sample(self, i: int, augment: bool) -> Dict[str, np.ndarray]:
        info = self.infos[self._indices[i]]
        points = aggregate_sweeps(
            info, self.data_root, self.num_sweeps,
            self.rng if self.training else None,
        )
        name_to_id = {n: i for i, n in enumerate(self.class_names)}
        gt_boxes = np.asarray(info.get("gt_boxes", np.zeros((0, 7))), np.float32)
        names = [NUSC_CLASS_MAP.get(n, n) for n in info.get("gt_names", [])]
        gt_labels = np.asarray(
            [name_to_id.get(n, -1) for n in names], np.int32
        )
        if "gt_velocity" in info and len(gt_boxes):
            vel = np.nan_to_num(np.asarray(info["gt_velocity"], np.float32))
            gt_boxes = np.concatenate([gt_boxes[:, :7], vel], 1)
        # optional attribute ids for AAE-complete evaluation: plain mmdet3d
        # infos don't store them; extended pickles may carry ids
        # ("gt_attrs") or devkit names ("gt_attribute_names")
        gt_attrs = None
        if "gt_attrs" in info:
            gt_attrs = np.asarray(info["gt_attrs"], np.int32)
        elif "gt_attribute_names" in info:
            gt_attrs = np.asarray(
                [ATTR_ID.get(n, -1) for n in info["gt_attribute_names"]],
                np.int32)
        keep = gt_labels >= 0
        gt_boxes, gt_labels = gt_boxes[keep], gt_labels[keep]
        if gt_attrs is not None:
            gt_attrs = gt_attrs[keep]

        points = P.normalize_intensity(points, dim=3)
        points = P.save_noaug_channels(points)
        if (self.training and augment and self.paste_enabled
                and self.gt_sampler is not None):
            # paste BEFORE the global transforms (reference pipeline order:
            # MyObjectSample precedes MyGlobalRotScaleTrans)
            t0 = time.perf_counter()
            pasted = self.gt_sampler(dict(
                points=points, gt_boxes=gt_boxes, gt_labels=gt_labels,
                no_aug_gt_boxes=gt_boxes.copy(),
            ))
            self.host_ms["paste"] += (time.perf_counter() - t0) * 1e3
            points = pasted["points"]
            gt_boxes = pasted["gt_boxes"]
            gt_labels = pasted["gt_labels"]
            no_aug_gt = pasted["no_aug_gt_boxes"]
        else:
            no_aug_gt = gt_boxes.copy()
        if self.training and augment:
            tp = P.sample_transform_params(self.rng)
            # transform only the live xyz channels, not the saved no-aug tail
            live = P.apply_points_transform(points[:, :-3], tp)
            points = np.concatenate([live, points[:, -3:]], 1)
            gt_boxes = P.apply_boxes_transform(gt_boxes, tp)
        points = P.filter_points_range(points, self.point_cloud_range)
        r = self.point_cloud_range
        if gt_attrs is not None and len(gt_attrs) < len(gt_boxes):
            # GT-paste appended boxes with no attribute annotation
            gt_attrs = np.concatenate([
                gt_attrs,
                np.full(len(gt_boxes) - len(gt_attrs), -1, np.int32)])
        aux = [no_aug_gt] + ([gt_attrs] if gt_attrs is not None else [])
        gt_boxes, gt_labels, aux = P.filter_boxes_range(
            gt_boxes, gt_labels, (r[0], r[1], r[3], r[4]), aux
        )
        no_aug_gt = aux[0]
        if gt_attrs is not None:
            gt_attrs = aux[1]
        if self.training:
            points = P.shuffle_points(points, self.rng)
        return dict(
            points=points,
            gt_boxes=gt_boxes,
            gt_labels=gt_labels,
            gt_attrs=gt_attrs,
            no_aug_gt_boxes=no_aug_gt,
            token=info.get("token", ""),
            lidar2img=(
                np.asarray(info["lidar2img"], np.float32)
                if "lidar2img" in info
                else lidar2img_from_cams(info["cams"])
                if info.get("cams")
                else None
            ),
        )

    def batches(self, batch_size: int, n_points_cap: int, max_gt: int):
        order = self.rng.permutation(len(self)) if self.training else np.arange(len(self))
        for s in range(0, len(order) - batch_size + 1, batch_size):
            samples = [self.sample(int(j)) for j in order[s:s + batch_size]]
            t0 = time.perf_counter()
            batch = P.collate_scene(samples, n_points_cap, max_gt)
            self.host_ms["collate"] += (time.perf_counter() - t0) * 1e3
            yield batch, samples
