"""Write a synthetic Argoverse 2 sensor log for ``cli/prepare_av2.py --fusion``
and ``cli/test.py --eval-protocol av2``, with its single-channel instance
masks, when the dataset is not at hand.

The log has the AV2 sensor dataset's layout and schemas (written by
``data/feather.py``):

  * ``sensors/lidar/{ts}.feather``: float16 ``x, y, z`` in the ego frame,
    uint8 ``intensity`` and ``laser_number``, int32 ``offset_ns``;
  * ``annotations.feather``: AV2's cuboid columns, upper-case categories;
  * ``calibration/egovehicle_SE3_sensor.feather`` and
    ``calibration/intrinsics.feather``: a seven-camera ring rig
    (:class:`RingRig`, modelled on AV2's: ring cameras 2,048 × 1,550, the
    front centre one portrait, ``fx = fy = 1,780`` px, ~1 m across the
    ring), plus a stereo camera and a LiDAR that the preparation ignores;
  * ``city_SE3_egovehicle.feather``: the ego pose at every sweep and image
    timestamp (:func:`to_city`: 10 m/s turning at 0.3 rad/s);
  * ``sensors/cameras/{cam}/{ts}.jpg``: empty files, since only their names
    are read; the cameras fire at their own rate and offsets, not the
    sweeps'.

:func:`paint_masks` writes a frame's masks in the single-channel layout of
``data/masks.load_sample_masks_single_channel`` (``{cam}.png`` at the
camera's native size, ``anno.json``): each GT box's interior points,
projected by the rig's own geometry (the camera's centre and rotation in
the city frame at the image's timestamp, not the prepared ``lidar2img``),
painted as squares of ``2 r + 1`` pixels, the farthest box first, so that
nearer instances cover farther ones. :func:`project` is that geometry.

    python -m fullysparsefusion_tpu_torch.cli.make_fake_av2 --out DIR [--tiny]
"""
from __future__ import annotations

import argparse
import json
import os
from dataclasses import dataclass
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np

from ..config import AV2_CLASS_NAMES
from ..data.feather import write_feather
from ..data.png import write_png
from .prepare_av2 import RING_CAMERAS, nearest_stamp

# camera axes (x right, y down, z forward) in the ego frame (x forward,
# y left, z up) for a camera looking along +x, and its quaternion (w, x, y, z)
_EGO_R_CAM0 = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
_Q_CAM0 = np.array([0.5, -0.5, 0.5, -0.5])
# the ring cameras' yaws in RING_CAMERAS order (AV2's layout), on a ring of
# RING_RADIUS m around RING_CENTRE (ego frame)
RING_YAWS_DEG = (0.0, 45.0, -45.0, 153.0, -153.0, 99.0, -99.0)
RING_CENTRE = (1.2, 0.0, 1.7)
RING_RADIUS = 0.5
# the ego: from ORIGIN at heading YAW0 at T0_NS, SPEED m/s along a circle of
# YAW_RATE rad/s
T0_NS = 315969629019741000
SPEED, YAW_RATE, YAW0 = 10.0, 0.3, 0.3
ORIGIN = (1000.0, 2000.0, 10.0)
SWEEP_PERIOD_NS = 100_000_000
MAX_ANNO = 250


def rot_z(yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def quat_z(yaw: float) -> np.ndarray:
    """(w, x, y, z) of a rotation by ``yaw`` about +z."""
    return np.array([np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)])


def quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                     w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])


@dataclass(frozen=True)
class RingRig:
    """Seven ring cameras in :data:`prepare_av2.RING_CAMERAS` order, each
    looking outwards at its yaw (:data:`RING_YAWS_DEG`); pinhole intrinsics
    with the principal point at the image centre. Sizes are (h, w)."""

    ring_hw: Tuple[int, int] = (1550, 2048)
    front_hw: Tuple[int, int] = (2048, 1550)
    focal: float = 1780.0

    def hw(self, c: int) -> Tuple[int, int]:
        return self.front_hw if c == 0 else self.ring_hw

    def intrinsics(self, c: int) -> np.ndarray:
        h, w = self.hw(c)
        return np.array([[self.focal, 0.0, w / 2], [0.0, self.focal, h / 2], [0.0, 0.0, 1.0]])

    @staticmethod
    def yaw(c: int) -> float:
        return np.deg2rad(RING_YAWS_DEG[c])

    def ego_R_cam(self, c: int) -> np.ndarray:
        return rot_z(self.yaw(c)) @ _EGO_R_CAM0

    def ego_t_cam(self, c: int) -> np.ndarray:
        y = self.yaw(c)
        return np.array(RING_CENTRE) + RING_RADIUS * np.array([np.cos(y), np.sin(y), 0.0])


# the tiny rig of CPU tests: 64 x 48 ring cameras, a 48 x 64 front one
TINY_RIG = RingRig(ring_hw=(48, 64), front_hw=(64, 48), focal=56.0)


def heading(ts: int) -> float:
    """The ego's yaw in the city at ``ts``."""
    return YAW0 + YAW_RATE * (int(ts) - T0_NS) * 1e-9


def ego_position(ts: int) -> np.ndarray:
    a = YAW_RATE * (int(ts) - T0_NS) * 1e-9
    return np.array(ORIGIN) + rot_z(YAW0) @ (SPEED / YAW_RATE * np.array(
        [np.sin(a), 1 - np.cos(a), 0.0]))


def to_city(ts: int, xyz: np.ndarray) -> np.ndarray:
    """Ego-frame points at ``ts`` → city."""
    return xyz @ rot_z(heading(ts)).T + ego_position(ts)


def project(rig: RingRig, c: int, ts: int, xyz_city: np.ndarray):
    """(u, v, depth) of city points in camera ``c``'s image taken at
    ``ts``: the camera's rotation and centre in the city at that time."""
    city_R_cam = rot_z(heading(ts)) @ rig.ego_R_cam(c)
    centre = to_city(ts, rig.ego_t_cam(c)[None])[0]
    x = (xyz_city - centre) @ city_R_cam
    k = rig.intrinsics(c)
    z = x[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        return k[0, 0] * x[:, 0] / z + k[0, 2], k[1, 1] * x[:, 1] / z + k[1, 2], z


def camera_stamps(sweep_stamps: Sequence[int], period_ns: int = 50_000_000,
                  offsets_ns: Sequence[int] = (12_000_000, 25_000_000, 37_000_000, 5_000_000,
                                               44_000_000, 19_000_000, 31_000_000)
                  ) -> List[np.ndarray]:
    """Each camera's image timestamps: every ``period_ns`` from its offset,
    one period beyond the sweeps on either side (20 Hz by default; an
    offset of half the period ties two images for a 10 Hz sweep)."""
    lo, hi = min(sweep_stamps) - period_ns, max(sweep_stamps) + period_ns
    return [np.arange(lo + off, hi + 1, period_ns, dtype=np.int64) for off in offsets_ns]


def write_rig(log_dir: str, rig: RingRig) -> None:
    """The two calibration feathers; a stereo camera and the top LiDAR sit
    beside the ring cameras, as in AV2's."""
    ext: Dict[str, list] = {k: [] for k in ("sensor_name", "qw", "qx", "qy", "qz", "tx_m",
                                            "ty_m", "tz_m")}
    intr: Dict[str, list] = {k: [] for k in ("sensor_name", "fx_px", "fy_px", "cx_px", "cy_px",
                                             "k1", "k2", "k3", "height_px", "width_px")}
    for c, cam in enumerate(RING_CAMERAS):
        q, t = quat_mul(quat_z(rig.yaw(c)), _Q_CAM0), rig.ego_t_cam(c)
        for k, v in zip(list(ext)[1:], [*q, *t]):
            ext[k].append(float(v))
        ext["sensor_name"].append(cam)
        (fx, _, cx), (_, fy, cy), _ = rig.intrinsics(c)
        h, w = rig.hw(c)
        for k, v in zip(list(intr)[1:], (fx, fy, cx, cy, -0.25, 0.1, -0.01, h, w)):
            intr[k].append(v)
        intr["sensor_name"].append(cam)
    for name, q in (("stereo_front_left", _Q_CAM0), ("up_lidar", np.array([1.0, 0, 0, 0]))):
        ext["sensor_name"].append(name)
        for k, v in zip(list(ext)[1:], [*q, 1.3, 0.2, 1.6]):
            ext[k].append(float(v))
    intr["sensor_name"].append("stereo_front_left")
    for k, v in zip(list(intr)[1:], (1400.0, 1400.0, 1024.0, 775.0, 0.0, 0.0, 0.0, 1550, 2048)):
        intr[k].append(v)
    calib = os.path.join(log_dir, "calibration")
    os.makedirs(calib, exist_ok=True)
    dtypes = dict(sensor_name=object, height_px=np.int64, width_px=np.int64)
    for cols, name in ((ext, "egovehicle_SE3_sensor"), (intr, "intrinsics")):
        write_feather({k: np.array(v, dtypes.get(k, np.float64)) for k, v in cols.items()},
                      os.path.join(calib, f"{name}.feather"))


def write_poses(log_dir: str, stamps) -> None:
    """``city_SE3_egovehicle.feather`` with a row at each of ``stamps``."""
    stamps = np.unique(np.asarray(stamps, np.int64))
    q = np.stack([quat_z(heading(t)) for t in stamps])
    p = np.stack([ego_position(t) for t in stamps])
    write_feather({"timestamp_ns": stamps, "qw": q[:, 0], "qx": q[:, 1], "qy": q[:, 2],
                   "qz": q[:, 3], "tx_m": p[:, 0], "ty_m": p[:, 1], "tz_m": p[:, 2]},
                  os.path.join(log_dir, "city_SE3_egovehicle.feather"))


def write_cameras(log_dir: str, stamps: Sequence[np.ndarray]) -> None:
    """An empty ``{ts}.jpg`` per image timestamp of each ring camera."""
    for cam, ts in zip(RING_CAMERAS, stamps):
        d = os.path.join(log_dir, "sensors", "cameras", cam)
        os.makedirs(d, exist_ok=True)
        for t in ts:
            open(os.path.join(d, f"{int(t)}.jpg"), "wb").close()


def write_sweep(log_dir: str, ts: int, points: np.ndarray, rng) -> Dict[str, np.ndarray]:
    """``points`` [N, 4] (x, y, z, intensity in [0, 1]) as a sweep feather
    in AV2's schema; returns its columns."""
    n = len(points)
    cols = {"x": points[:, 0].astype(np.float16), "y": points[:, 1].astype(np.float16),
            "z": points[:, 2].astype(np.float16),
            "intensity": np.clip(np.round(points[:, 3] * 255), 0, 255).astype(np.uint8),
            "laser_number": rng.integers(0, 64, n).astype(np.uint8),
            "offset_ns": rng.integers(0, 10**8, n).astype(np.int32)}
    lidar = os.path.join(log_dir, "sensors", "lidar")
    os.makedirs(lidar, exist_ok=True)
    write_feather(cols, os.path.join(lidar, f"{ts}.feather"))
    return cols


def annotation_columns(stamps: np.ndarray, boxes: np.ndarray, labels: np.ndarray
                       ) -> Dict[str, np.ndarray]:
    """AV2's cuboid columns (gravity centre, wxyz quaternion, upper-case
    category, float32) of bottom-centre boxes [M, 7+] at ``stamps`` [M]."""
    b = np.asarray(boxes, np.float64)
    q = np.stack([quat_z(y) for y in b[:, 6]]) if len(b) else np.zeros((0, 4))
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return {"timestamp_ns": np.asarray(stamps, np.int64),
            "track_uuid": np.array([f"track{i:04d}" for i in range(len(b))], object),
            "category": np.array([AV2_CLASS_NAMES[int(c)].upper() for c in labels], object),
            "length_m": f32(b[:, 3]), "width_m": f32(b[:, 4]), "height_m": f32(b[:, 5]),
            "qw": f32(q[:, 0]), "qx": f32(q[:, 1]), "qy": f32(q[:, 2]), "qz": f32(q[:, 3]),
            "tx_m": f32(b[:, 0]), "ty_m": f32(b[:, 1]), "tz_m": f32(b[:, 2] + b[:, 5] / 2),
            "num_interior_pts": np.zeros(len(b), np.int64)}


def in_box(xyz: np.ndarray, box: np.ndarray) -> np.ndarray:
    """[N] bool: points inside a bottom-centre box (x, y, z, l, w, h, yaw)."""
    d = xyz[:, :2] - box[:2]
    c, s = np.cos(box[6]), np.sin(box[6])
    lx, ly = d[:, 0] * c + d[:, 1] * s, -d[:, 0] * s + d[:, 1] * c
    dz = xyz[:, 2] - box[2]
    return (np.abs(lx) <= box[3] / 2) & (np.abs(ly) <= box[4] / 2) & (dz >= 0) & (dz <= box[5])


def paint_masks(mask_dir: str, token: str, points: np.ndarray, boxes: np.ndarray,
                labels: np.ndarray, rig: RingRig, t_sweep: int, t_cams: Sequence[int],
                radius: int) -> Dict:
    """One frame's single-channel masks under ``mask_dir/token``: per camera
    ``{c}.png`` (uint8 instance ids at the native size, 0 = none) and
    ``anno.json`` (a row per (camera, box) with a painted pixel: bbox,
    score, category = the box's label, cam_id, obj_id = id - 1). Each box's
    interior ``points`` (ego frame at ``t_sweep``) are projected into each
    camera at its image's timestamp ``t_cams[c]`` and painted as squares of
    ``2 radius + 1`` pixels, farthest box first. Returns ``ids`` (per
    camera the painted image), ``rows`` and ``boxes`` (each row's box
    index)."""
    xyz = np.asarray(points[:, :3], np.float64)
    order = np.argsort(-np.linalg.norm(np.asarray(boxes[:, :2], np.float64), axis=1),
                       kind="stable")
    members = [np.nonzero(in_box(xyz, np.asarray(boxes[j], np.float64)))[0] for j in order]
    city = to_city(t_sweep, xyz)
    images, rows, box_of = [], [], []
    for c in range(len(RING_CAMERAS)):
        h, w = rig.hw(c)
        img = np.zeros((h, w), np.uint8)
        for j, idx in zip(order, members):
            u, v, z = project(rig, c, t_cams[c], city[idx])
            ok = (z > 1e-3) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
            if not ok.any():
                continue
            if len(rows) >= MAX_ANNO:
                raise ValueError(f"{token}: more than {MAX_ANNO} instances")
            oid = len(rows)
            pu, pv = np.floor(u[ok]).astype(np.int64), np.floor(v[ok]).astype(np.int64)
            for dv in range(-radius, radius + 1):
                for du in range(-radius, radius + 1):
                    img[np.clip(pv + dv, 0, h - 1), np.clip(pu + du, 0, w - 1)] = oid + 1
            bbox = [float(max(pu.min() - radius, 0)), float(max(pv.min() - radius, 0)),
                    float(min(pu.max() + radius + 1, w)), float(min(pv.max() + radius + 1, h))]
            rows.append(dict(bbox=bbox, score=0.9, category=int(labels[j]), cam_id=c,
                             obj_id=oid))
            box_of.append(int(j))
        images.append(img)
    sdir = os.path.join(mask_dir, token)
    os.makedirs(sdir, exist_ok=True)
    for c, img in enumerate(images):
        write_png(os.path.join(sdir, f"{c}.png"), img)
    with open(os.path.join(sdir, "anno.json"), "w") as f:
        json.dump(rows, f)
    return dict(ids=images, rows=rows, boxes=box_of)


def write_log(split_dir: str, log_id: str, frames: Sequence[Mapping], rig: RingRig,
              mask_dir: str = "", radius: int = 3, stamps: Sequence[np.ndarray] = ()) -> Dict:
    """One log of ``frames`` (each ``points`` [N, 4] in the ego frame,
    ``gt_boxes`` [M, 7+] bottom-centre, ``gt_labels`` [M]), a sweep every
    100 ms from ``T0_NS``; the cameras at ``stamps`` (by default
    :func:`camera_stamps`); with ``mask_dir``, each frame's masks painted
    from its images nearest the sweep. Returns the log dir, sweep stamps,
    camera stamps and per frame the painted ``masks``."""
    log_dir = os.path.join(split_dir, log_id)
    rng = np.random.default_rng(0)
    sweeps = [T0_NS + k * SWEEP_PERIOD_NS for k in range(len(frames))]
    stamps = list(stamps) or camera_stamps(sweeps)
    ann_ts, ann_boxes, ann_labels, painted = [], [], [], []
    for ts, fr in zip(sweeps, frames):
        write_sweep(log_dir, ts, np.asarray(fr["points"]), rng)
        ann_ts += [ts] * len(fr["gt_labels"])
        ann_boxes.append(np.asarray(fr["gt_boxes"])[:, :7])
        ann_labels += [int(c) for c in fr["gt_labels"]]
        if mask_dir:
            t_cams = [nearest_stamp(s, ts) for s in stamps]
            painted.append(paint_masks(mask_dir, f"{log_id}_{ts}", np.asarray(fr["points"]),
                                       np.asarray(fr["gt_boxes"]), np.asarray(fr["gt_labels"]),
                                       rig, ts, t_cams, radius))
    write_feather(annotation_columns(np.array(ann_ts), np.concatenate(ann_boxes), ann_labels),
                  os.path.join(log_dir, "annotations.feather"))
    write_rig(log_dir, rig)
    write_poses(log_dir, np.concatenate([np.array(sweeps, np.int64), *stamps]))
    write_cameras(log_dir, stamps)
    return dict(log_dir=log_dir, sweeps=sweeps, camera_stamps=stamps, masks=painted)


def synthetic_frames(n: int, seed: int = 0) -> List[Dict[str, np.ndarray]]:
    """``n`` frames of ``synthetic.make_scene_arrays`` (one sample each, six
    boxes within 10 m, 4-dim points, AV2's 26 labels)."""
    from .. import synthetic as S

    out = []
    for k in range(n):
        sc = S.make_scene_arrays(seed=seed + k, batch_size=1, boxes_per_sample=6, n_cap=4096,
                                 max_gt=16, num_classes=len(AV2_CLASS_NAMES), point_dim=4)
        gv = sc["gt_valid"][0]
        out.append(dict(points=sc["points"][sc["valid"]], gt_boxes=sc["gt_boxes"][0][gv, :7],
                        gt_labels=sc["gt_labels"][0][gv]))
    return out


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, help="root: writes sensor/{log}, masks/")
    ap.add_argument("--tiny", action="store_true", help="the tiny rig (64 x 48 cameras)")
    args = ap.parse_args(argv)
    tiny = args.tiny
    written = write_log(os.path.join(args.out, "sensor"), "synthetic_log", synthetic_frames(2),
                        TINY_RIG if tiny else RingRig(), mask_dir=os.path.join(args.out, "masks"),
                        radius=1 if tiny else 3)
    print(f"wrote a log of {len(written['sweeps'])} sweeps under {args.out}")
    return written


if __name__ == "__main__":
    main()
