"""Argoverse 2 data preparation: sensor logs → info pickle + point bins (the
port's counterpart of the JAX package's ``tools/prepare_av2.py``, reading the
logs' ``.feather`` files with ``data/feather.py`` instead of pandas).

Per log directory: ``annotations.feather`` (a log without it gives no
frames), ``city_SE3_egovehicle.feather`` (read, and it must have a
``timestamp_ns`` column, as the tool's ``set_index`` demands), and every
``sensors/lidar/{timestamp_ns}.feather`` sweep in name order. Each sweep's
``x, y, z`` (float16 in AV2) and ``intensity / 255`` (uint8, divided in
float64) are stacked and cast to float32 and written to
``{points_out}/{log_id}_{ts}.bin``; the annotation rows of that timestamp
(in file order) give the boxes: gravity centre → bottom centre (``tz_m -
height_m / 2`` in the columns' dtype), the yaw of the wxyz quaternion, the
category through ``str(c).title()``. The arithmetic follows pandas' dtype
rules, so the pickle and the ``.bin`` files are the JAX tool's, bitwise.

Like the JAX tool, it defines :func:`build_lidar2img` but writes no camera
entries, so ``data/av2.AV2Reader`` gives ``lidar2img`` None for the frames.

    python -m fullysparsefusion_tpu_torch.cli.prepare_av2 --av2-root data/av2/sensor/val \
        --out data/av2/av2_infos_val.pkl --points-out data/av2/points
"""
from __future__ import annotations

import argparse
import os
import pickle
from typing import Dict, List, Optional

import numpy as np

from ..config import AV2_CLASS_NAMES
from ..data.feather import read_feather


def quat_wxyz_to_yaw(q: np.ndarray) -> np.ndarray:
    """[N, 4] (w,x,y,z) → yaw around +z (inverse of av2.py yaw_to_quat)."""
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))


def quat_to_rot(q: np.ndarray) -> np.ndarray:
    """[4] (w,x,y,z) → [3,3] rotation matrix."""
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def se3(rot: np.ndarray, t: np.ndarray) -> np.ndarray:
    m = np.eye(4)
    m[:3, :3] = rot
    m[:3, 3] = t
    return m


def build_lidar2img(
    ego_se3_at_lidar: np.ndarray,      # lidar-ego → city
    ego_se3_at_cam: np.ndarray,        # cam-ego → city (at the cam timestamp)
    cam_from_ego: np.ndarray,          # ego → camera extrinsics
    intrinsics: np.ndarray,            # [3, 3]
) -> np.ndarray:
    """4×4 lidar-frame → image-plane projection with ego-motion compensation
    (argo2_pickle_mmdet_fusion.py:50-99 chain)."""
    k4 = np.eye(4)
    k4[:3, :3] = intrinsics
    lidar_to_cam = cam_from_ego @ np.linalg.inv(ego_se3_at_cam) @ ego_se3_at_lidar
    return k4 @ lidar_to_cam


def process_log(log_dir: str, out_points_dir: str, class_names) -> List[Dict]:
    """One log's frames as info dicts; writes each sweep's ``.bin``."""
    ann_path = os.path.join(log_dir, "annotations.feather")
    if not os.path.isfile(ann_path):
        return []
    ann = read_feather(ann_path)
    pose_path = os.path.join(log_dir, "city_SE3_egovehicle.feather")
    if "timestamp_ns" not in read_feather(pose_path):
        raise KeyError(f"{pose_path} has no 'timestamp_ns' column")
    log_id = os.path.basename(os.path.normpath(log_dir))

    infos = []
    lidar_dir = os.path.join(log_dir, "sensors", "lidar")
    for fname in sorted(os.listdir(lidar_dir)):
        if not fname.endswith(".feather"):
            continue
        ts = int(fname[:-8])
        sweep = read_feather(os.path.join(lidar_dir, fname))
        pts = np.stack(
            [sweep["x"], sweep["y"], sweep["z"], sweep["intensity"] / 255.0], 1
        ).astype(np.float32)
        os.makedirs(out_points_dir, exist_ok=True)
        bin_path = os.path.join(out_points_dir, f"{log_id}_{ts}.bin")
        pts.tofile(bin_path)

        sel = ann["timestamp_ns"] == ts
        frame = {k: v[sel] for k, v in ann.items()}
        n = int(sel.sum())
        quats = np.stack([frame["qw"], frame["qx"], frame["qy"], frame["qz"]], 1)
        yaw = quat_wxyz_to_yaw(quats) if n else np.zeros(0)
        boxes = np.stack(
            [
                frame["tx_m"], frame["ty_m"],
                frame["tz_m"] - frame["height_m"] / 2,  # gravity → bottom center
                frame["length_m"], frame["width_m"], frame["height_m"], yaw,
            ],
            1,
        ).astype(np.float32) if n else np.zeros((0, 7), np.float32)
        names = [str(c).title() for c in frame["category"]] if n else []
        infos.append(
            dict(
                log_id=log_id,
                timestamp_ns=ts,
                lidar_path=os.path.relpath(bin_path, os.path.dirname(out_points_dir)),
                gt_boxes=boxes,
                gt_names=names,
            )
        )
    return infos


def parse_args(argv: Optional[list] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--av2-root", required=True, help="sensor dataset split dir")
    ap.add_argument("--out", required=True, help="output info pickle")
    ap.add_argument("--points-out", required=True, help="output .bin dir")
    return ap.parse_args(argv)


def main(argv: Optional[list] = None) -> List[Dict]:
    """Runs the CLI; returns the infos it wrote."""
    args = parse_args(argv)
    all_infos = []
    for log in sorted(os.listdir(args.av2_root)):
        log_dir = os.path.join(args.av2_root, log)
        if os.path.isdir(log_dir):
            all_infos.extend(process_log(log_dir, args.points_out, AV2_CLASS_NAMES))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "wb") as f:
        pickle.dump({"infos": all_infos}, f)
    print(f"wrote {len(all_infos)} frames to {args.out}")
    return all_infos


if __name__ == "__main__":
    main()
