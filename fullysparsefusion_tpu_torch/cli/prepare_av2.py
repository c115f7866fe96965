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

``--fusion`` (named after the reference's ``argo2_pickle_mmdet_fusion.py``;
off by default, and then the output is the JAX tool's) adds FSF's camera
entries, which the JAX tool defines but never writes. Per sweep and per
ring camera (:data:`RING_CAMERAS`, the AV2 devkit's order, front centre
first): the image of ``sensors/cameras/{cam}/{timestamp_ns}.jpg`` nearest
the sweep (a tie goes to the earlier one), and ``lidar2img[c] =
build_lidar2img(pose(t_sweep), pose(t_image), inv(ego_SE3_cam), K)`` from
``calibration/egovehicle_SE3_sensor.feather``, ``calibration/
intrinsics.feather`` (``fx_px, fy_px, cx_px, cy_px``; the distortion is
ignored) and the exact rows of ``city_SE3_egovehicle.feather`` at both
timestamps: float64 ``[7, 4, 4]`` beside ``cam_names`` and ``cams`` (per
camera ``data_path`` relative to ``--av2-root``, ``timestamp_ns``,
``height_px``, ``width_px``). A missing pose row, calibration row or
camera directory raises, naming it. The categories then go through
``str(c).capitalize()``, which gives ``config.AV2_CLASS_NAMES`` exactly
(``title()`` gives ``Regular_Vehicle`` for ``Regular_vehicle``, and the
reader drops such boxes).

    python -m fullysparsefusion_tpu_torch.cli.prepare_av2 --av2-root data/av2/sensor/val \
        --out data/av2/av2_infos_val.pkl --points-out data/av2/points --fusion
"""
from __future__ import annotations

import argparse
import os
import pickle
from typing import Dict, List, Optional

import numpy as np

from ..config import AV2_CLASS_NAMES
from ..data.feather import read_feather

# the AV2 devkit's RingCameras order: the front camera is index 0, as the
# single-channel mask loader's ``front_cam=0`` assumes
RING_CAMERAS = ("ring_front_center", "ring_front_left", "ring_front_right", "ring_rear_left",
                "ring_rear_right", "ring_side_left", "ring_side_right")


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


def _rows_by(cols: Dict[str, np.ndarray], key: str, path: str) -> Dict:
    """{value of column ``key``: row index}."""
    if key not in cols:
        raise KeyError(f"{path} has no {key!r} column")
    return {k.item() if isinstance(k, np.generic) else k: i for i, k in enumerate(cols[key])}


def _row(rows: Dict, key, path: str) -> int:
    if key not in rows:
        raise KeyError(f"{path} has no row for {key!r}")
    return rows[key]


def _se3_of(cols: Dict[str, np.ndarray], i: int) -> np.ndarray:
    """Row ``i`` of an AV2 SE(3) table (``qw, qx, qy, qz, tx_m, ty_m,
    tz_m``) as a 4×4 matrix."""
    q = np.array([cols[k][i] for k in ("qw", "qx", "qy", "qz")], np.float64)
    t = np.array([cols[k][i] for k in ("tx_m", "ty_m", "tz_m")], np.float64)
    return se3(quat_to_rot(q), t)


def nearest_stamp(stamps: np.ndarray, ts: int) -> int:
    """The entry of the sorted ``stamps`` nearest ``ts``; a tie goes to the
    earlier one."""
    j = int(np.searchsorted(stamps, ts))
    if j == len(stamps) or (j > 0 and ts - int(stamps[j - 1]) <= int(stamps[j]) - ts):
        j -= 1
    return int(stamps[j])


class CameraRig:
    """One log's ring cameras: calibration, image timestamps, ego poses.
    :meth:`frame` gives a sweep's camera entries."""

    def __init__(self, log_dir: str, poses: Dict[str, np.ndarray], pose_path: str):
        calib = os.path.join(log_dir, "calibration")
        ext_path = os.path.join(calib, "egovehicle_SE3_sensor.feather")
        int_path = os.path.join(calib, "intrinsics.feather")
        ext, intr = read_feather(ext_path), read_feather(int_path)
        ext_rows = _rows_by(ext, "sensor_name", ext_path)
        int_rows = _rows_by(intr, "sensor_name", int_path)
        self.root = os.path.dirname(os.path.normpath(log_dir))
        self.poses, self.pose_path = poses, pose_path
        self.pose_rows = _rows_by(poses, "timestamp_ns", pose_path)
        self.cam_from_ego, self.intrinsics, self.hw, self.stamps, self.dirs = [], [], [], [], []
        for cam in RING_CAMERAS:
            ego_se3_cam = _se3_of(ext, _row(ext_rows, cam, ext_path))
            self.cam_from_ego.append(np.linalg.inv(ego_se3_cam))
            i = _row(int_rows, cam, int_path)
            self.intrinsics.append(np.array([[intr["fx_px"][i], 0.0, intr["cx_px"][i]],
                                             [0.0, intr["fy_px"][i], intr["cy_px"][i]],
                                             [0.0, 0.0, 1.0]], np.float64))
            self.hw.append((int(intr["height_px"][i]), int(intr["width_px"][i])))
            cam_dir = os.path.join(log_dir, "sensors", "cameras", cam)
            if not os.path.isdir(cam_dir):
                raise FileNotFoundError(f"camera directory {cam_dir} is missing")
            stamps = sorted(int(f[:-4]) for f in os.listdir(cam_dir) if f.endswith(".jpg"))
            if not stamps:
                raise FileNotFoundError(f"camera directory {cam_dir} holds no .jpg image")
            self.stamps.append(np.array(stamps, np.int64))
            self.dirs.append(cam_dir)

    def pose(self, ts: int) -> np.ndarray:
        """city ← ego at ``ts``, from the exact row of the pose table."""
        return _se3_of(self.poses, _row(self.pose_rows, ts, self.pose_path))

    def frame(self, ts: int) -> Dict:
        """The info entries of the sweep at ``ts``: ``lidar2img`` float64
        [7, 4, 4] (ego-motion compensated), ``cam_names`` and ``cams``."""
        ego_at_lidar = self.pose(ts)
        l2i, cams = [], {}
        for c, cam in enumerate(RING_CAMERAS):
            t_cam = nearest_stamp(self.stamps[c], ts)
            l2i.append(build_lidar2img(ego_at_lidar, self.pose(t_cam), self.cam_from_ego[c],
                                       self.intrinsics[c]))
            path = os.path.join(self.dirs[c], f"{t_cam}.jpg")
            cams[cam] = dict(data_path=os.path.relpath(path, self.root), timestamp_ns=t_cam,
                             height_px=self.hw[c][0], width_px=self.hw[c][1])
        return dict(lidar2img=np.stack(l2i), cam_names=list(RING_CAMERAS), cams=cams)


def process_log(log_dir: str, out_points_dir: str, class_names,
                fusion: bool = False) -> List[Dict]:
    """One log's frames as info dicts; writes each sweep's ``.bin``. With
    ``fusion`` each frame also gets its camera entries (:class:`CameraRig`)
    and the categories are capitalized instead of title-cased."""
    ann_path = os.path.join(log_dir, "annotations.feather")
    if not os.path.isfile(ann_path):
        return []
    ann = read_feather(ann_path)
    pose_path = os.path.join(log_dir, "city_SE3_egovehicle.feather")
    poses = read_feather(pose_path)
    if "timestamp_ns" not in poses:
        raise KeyError(f"{pose_path} has no 'timestamp_ns' column")
    log_id = os.path.basename(os.path.normpath(log_dir))
    rig = CameraRig(log_dir, poses, pose_path) if fusion else None
    to_name = str.capitalize if fusion else str.title

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
        names = [to_name(str(c)) for c in frame["category"]] if n else []
        info = dict(
            log_id=log_id,
            timestamp_ns=ts,
            lidar_path=os.path.relpath(bin_path, os.path.dirname(out_points_dir)),
            gt_boxes=boxes,
            gt_names=names,
        )
        if rig is not None:
            info.update(rig.frame(ts))
        infos.append(info)
    return infos


def parse_args(argv: Optional[list] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--av2-root", required=True, help="sensor dataset split dir")
    ap.add_argument("--out", required=True, help="output info pickle")
    ap.add_argument("--points-out", required=True, help="output .bin dir")
    ap.add_argument("--fusion", action="store_true",
                    help="write the ring cameras' lidar2img and capitalize the categories")
    return ap.parse_args(argv)


def main(argv: Optional[list] = None) -> List[Dict]:
    """Runs the CLI; returns the infos it wrote."""
    args = parse_args(argv)
    all_infos = []
    for log in sorted(os.listdir(args.av2_root)):
        log_dir = os.path.join(args.av2_root, log)
        if os.path.isdir(log_dir):
            all_infos.extend(process_log(log_dir, args.points_out, AV2_CLASS_NAMES,
                                          fusion=args.fusion))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "wb") as f:
        pickle.dump({"infos": all_infos}, f)
    print(f"wrote {len(all_infos)} frames to {args.out}")
    return all_infos


if __name__ == "__main__":
    main()
