"""Write a mini nuScenes info-pickle tree (the port's copy of the JAX
package's ``tools/make_fake_nuscenes.py``; the same seed writes the same
tree, its mask PNGs through ``data/png.py``).

The tree has mmdet3d ``create_data``'s schema, the one the reference trains
from (mmdet3d nuscenes_converter.py, read by the stock ``NuScenesDataset``):

  * ``{"infos": [...], "metadata": {"version": ...}}`` pickle;
  * per info: ``lidar_path`` + ``sweeps`` (each with ``data_path``,
    ``sensor2lidar_rotation/translation`` and ``timestamp``; sweep points
    are stored in their sensor frame, so the reader's ego-motion chain and
    remove_close run for real);
  * a ``cams`` dict per camera (``sensor2lidar_rotation/translation`` +
    ``cam_intrinsic``, no ``lidar2img``: real pickles do not store it);
  * raw category names (``vehicle.car`` ...), ``gt_velocity`` with NaN rows,
    ``num_lidar_pts``, ``num_radar_pts``, ``valid_flag``;
  * the offline mask tree (PNG + ``anno.json``) under ``masks/``.

:func:`write_sample` writes one sample and returns its info;
:func:`write_dataset` draws the synthetic samples; :func:`write_scene`
writes a scene of ``synthetic.py`` (the key frame and its sweeps, the
cameras of ``make_camera_arrays`` at a larger image scale, their masks).

    python -m fullysparsefusion_tpu_torch.cli.make_fake_nuscenes --out DIR --samples 4
"""
from __future__ import annotations

import argparse
import os
import pickle
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np

from ..config import NUSC_CLASS_NAMES
from ..data.masks import save_sample
from ..data.nuscenes import NUSC_CAMERA_ORDER, lidar2img_from_cams
from ..generate_masks import NUSC_CLASSES, paint_sample

RAW_NAMES = (
    "vehicle.car", "vehicle.truck", "vehicle.bus.rigid",
    "human.pedestrian.adult", "movable_object.barrier",
)
# matching mapped label ids under the default 10-class nuScenes head
MAPPED = ("car", "truck", "bus", "pedestrian", "barrier")
# one raw nuScenes category per detection class
RAW_OF_CLASS = {
    "car": "vehicle.car", "truck": "vehicle.truck",
    "construction_vehicle": "vehicle.construction", "bus": "vehicle.bus.rigid",
    "trailer": "vehicle.trailer", "barrier": "movable_object.barrier",
    "motorcycle": "vehicle.motorcycle", "bicycle": "vehicle.bicycle",
    "pedestrian": "human.pedestrian.adult", "traffic_cone": "movable_object.trafficcone",
}
KEY_TIMESTAMP_US = 1_600_000_000_000_000


def _yaw_rot(yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float64)


def _cam_entry(name: str, ci: int, r: np.ndarray, t: np.ndarray, intr: np.ndarray) -> Dict:
    return dict(
        data_path=f"samples/{name}/{name}_fake.jpg",
        type=name,
        sample_data_token=f"cam{ci}",
        sensor2ego_translation=t.tolist(),
        sensor2ego_rotation=[1.0, 0.0, 0.0, 0.0],
        ego2global_translation=[0.0, 0.0, 0.0],
        ego2global_rotation=[1.0, 0.0, 0.0, 0.0],
        timestamp=0,
        sensor2lidar_rotation=r,
        sensor2lidar_translation=t,
        cam_intrinsic=intr,
    )


def _cam_name(ci: int) -> str:
    return NUSC_CAMERA_ORDER[ci] if ci < len(NUSC_CAMERA_ORDER) else f"CAM_EXTRA_{ci}"


def make_cams(num_cams: int, img_h: int, img_w: int, fx: float):
    """Ring cameras with real extrinsics: sensor2lidar rotation maps camera
    axes (x right, y down, z forward) onto lidar directions at heading
    ``yaw``; small per-camera translation off the lidar origin."""
    cams = {}
    for ci in range(num_cams):
        yaw = 2 * np.pi * ci / num_cams
        fwd = np.array([np.cos(yaw), np.sin(yaw), 0.0])
        right = np.array([np.sin(yaw), -np.cos(yaw), 0.0])
        down = np.array([0.0, 0.0, -1.0])
        # columns are the camera basis expressed in lidar coords
        r = np.stack([right, down, fwd], axis=1)
        t = 0.3 * fwd + np.array([0.0, 0.0, -0.2])
        intr = np.array(
            [[fx, 0.0, img_w / 2], [0.0, fx, img_h / 2], [0.0, 0.0, 1.0]],
            np.float64)
        cams[_cam_name(ci)] = _cam_entry(_cam_name(ci), ci, r, t, intr)
    return cams


def synthetic_cams(num_cams: int, img_h: int, img_w: int, fx: float, scale: int = 1):
    """The cameras of ``synthetic.make_camera_arrays`` (camera 0 looking
    along +x, the others along −x) as a ``cams`` dict at ``scale`` times
    their image size: ``lidar2img_from_cams`` gives their ``lidar2img`` with
    its first two rows times ``scale``, exactly."""
    cams = {}
    for ci in range(num_cams):
        s = 1.0 if ci == 0 else -1.0
        lidar2cam = np.array([[0.0, s, 0.0], [0.0, 0.0, 1.0], [s, 0.0, 0.0]])
        intr = np.array([[scale * fx, 0.0, scale * img_w / 2],
                         [0.0, scale * fx, scale * img_h / 2], [0.0, 0.0, 1.0]])
        cams[_cam_name(ci)] = _cam_entry(_cam_name(ci), ci, lidar2cam.T, np.zeros(3), intr)
    return cams


def make_sample(rng, n_boxes: int, extent: float):
    """Boxes + surface-ish points in the key lidar frame."""
    boxes, names, pts = [], [], []
    for _ in range(n_boxes):
        k = rng.integers(0, len(RAW_NAMES))
        wlh = dict(
            car=(4.5, 1.9, 1.6), truck=(7.0, 2.5, 2.8), bus=(11.0, 2.9, 3.2),
            pedestrian=(0.6, 0.6, 1.7), barrier=(2.0, 0.5, 1.0),
        )[MAPPED[k]]
        cx, cy = rng.uniform(-extent, extent, 2)
        if np.hypot(cx, cy) < 3:
            cx += 5.0
        z = rng.uniform(-1.8, -1.0)
        yaw = rng.uniform(-np.pi, np.pi)
        boxes.append([cx, cy, z, wlh[0], wlh[1], wlh[2], yaw])
        names.append(RAW_NAMES[k])
        n = int(rng.integers(30, 120))
        local = rng.uniform(-0.5, 0.5, (n, 3)) * np.array(wlh)
        rot = _yaw_rot(yaw)
        pts.append(local @ rot.T + [cx, cy, z])
    ground = np.stack([
        rng.uniform(-extent, extent, 2000),
        rng.uniform(-extent, extent, 2000),
        rng.normal(-1.9, 0.05, 2000),
    ], 1)
    xyz = np.concatenate(pts + [ground]).astype(np.float32)
    feats = rng.random((len(xyz), 2)).astype(np.float32)  # intensity, ring
    return (np.asarray(boxes, np.float32), names,
            np.concatenate([xyz, feats], 1).astype(np.float32))


def write_sample(root: str, index: int, token: str, points: np.ndarray,
                 sweeps: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray, int]],
                 timestamp: int, cams: Dict, masks: Mapping[Tuple[int, int], np.ndarray],
                 annos: List[Dict], boxes: np.ndarray, names: Sequence[str],
                 velocity: np.ndarray, num_lidar_pts) -> Dict:
    """Write one sample into the tree at ``root`` and return its info: the
    key frame's ``points`` [N, 5] as ``samples/LIDAR_TOP/key_{index}.bin``;
    each sweep ``(points in its sensor frame, sensor2lidar rotation,
    translation, timestamp)`` as ``sweeps/LIDAR_TOP/sweep_{index}_{s}.bin``;
    the mask planes ``{(cam, cls): [H, W] ids}`` and ``annos`` under
    ``masks/{token}``."""
    os.makedirs(os.path.join(root, "samples", "LIDAR_TOP"), exist_ok=True)
    os.makedirs(os.path.join(root, "sweeps", "LIDAR_TOP"), exist_ok=True)
    key_rel = f"samples/LIDAR_TOP/key_{index:03d}.bin"
    np.asarray(points, np.float32).tofile(os.path.join(root, key_rel))
    sweep_infos = []
    for s, (sw_pts, r, t, ts) in enumerate(sweeps):
        sw_rel = f"sweeps/LIDAR_TOP/sweep_{index:03d}_{s}.bin"
        np.asarray(sw_pts, np.float32).tofile(os.path.join(root, sw_rel))
        sweep_infos.append(dict(
            data_path=sw_rel,
            type="lidar",
            sample_data_token=f"sw{index}_{s}",
            sensor2ego_translation=[0.9, 0.0, 1.8],
            sensor2ego_rotation=[1.0, 0.0, 0.0, 0.0],
            ego2global_translation=t.tolist(),
            ego2global_rotation=[1.0, 0.0, 0.0, 0.0],
            timestamp=ts,
            sensor2lidar_rotation=r,
            sensor2lidar_translation=t,
        ))
    save_sample(os.path.join(root, "masks"), token, masks, annos)
    return dict(
        lidar_path=key_rel,
        token=token,
        sweeps=sweep_infos,
        cams=cams,
        lidar2ego_translation=[0.9, 0.0, 1.8],
        lidar2ego_rotation=[0.7, 0.0, 0.0, 0.7],
        ego2global_translation=[600.0 + index, 1600.0, 0.0],
        ego2global_rotation=[1.0, 0.0, 0.0, 0.0],
        timestamp=timestamp,
        gt_boxes=boxes,
        gt_names=np.asarray(names),
        gt_velocity=velocity,
        num_lidar_pts=np.asarray(num_lidar_pts),
        num_radar_pts=np.zeros(len(names), np.int64),
        valid_flag=np.ones(len(names), bool),
    )


def write_infos(root: str, infos: List[Dict], name: str = "fake_infos_train.pkl",
                version: str = "v1.0-mini") -> str:
    info_path = os.path.join(root, name)
    with open(info_path, "wb") as f:
        pickle.dump({"infos": infos, "metadata": {"version": version}}, f)
    return info_path


def _sweep_motion(s: int):
    """Sweep ``s``'s sensor2lidar transform: the ego moved backwards."""
    return _yaw_rot(0.02 * (s + 1)), np.array([-0.5 * (s + 1), 0.05 * (s + 1), 0.0])


def write_dataset(root: str, n_samples: int = 4, n_sweeps: int = 2,
                  num_cams: int = 6, img_h: int = 128, img_w: int = 224,
                  fx: float = 80.0, n_boxes: int = 6, extent: float = 30.0,
                  seed: int = 0, version: str = "v1.0-mini"):
    """``n_samples`` synthetic samples from ``seed``; returns (info pickle
    path, mask directory)."""
    rng = np.random.default_rng(seed)
    cams = make_cams(num_cams, img_h, img_w, fx)
    l2i = lidar2img_from_cams(cams)
    name_to_cls = {n: i for i, n in enumerate(NUSC_CLASSES)}

    infos = []
    for i in range(n_samples):
        boxes, names, pts = make_sample(rng, n_boxes, extent)
        key_ts = KEY_TIMESTAMP_US + i * 500_000
        sweeps = []
        for s in range(n_sweeps):
            r, t = _sweep_motion(s)
            sub = pts[rng.random(len(pts)) < 0.6].copy()
            sub[:, :3] = (sub[:, :3] - t) @ r  # inverse of xyz @ r.T + t
            # near-ego returns that remove_close must drop
            close = np.concatenate([
                rng.uniform(-0.9, 0.9, (25, 2)),
                rng.uniform(-1.5, 0.0, (25, 1)),
                rng.random((25, 2)),
            ], 1).astype(np.float32)
            sweeps.append((np.concatenate([sub, close]), r, t, key_ts - (s + 1) * 50_000))

        # 2D masks consistent with the camera geometry (homogeneous @ lidar2img.T)
        token = f"faketok{i:03d}"
        dets = []
        pts4 = np.concatenate(
            [boxes[:, :3], np.ones((len(boxes), 1), np.float32)], 1)
        proj = np.einsum("nd,ckd->cnk", pts4, l2i)      # [C, N, 4]
        depth = proj[..., 2]
        uv = proj[..., :2] / np.maximum(depth[..., None], 1e-3)
        in_img = (
            (depth > 1e-3) & (uv[..., 0] >= 0) & (uv[..., 0] < img_w)
            & (uv[..., 1] >= 0) & (uv[..., 1] < img_h)
        )
        for bi in range(len(boxes)):
            for ci in range(num_cams):
                if not in_img[ci, bi]:
                    continue
                u, v = uv[ci, bi]
                half = max(6, int(fx * boxes[bi, 4] / max(depth[ci, bi], 1)))
                m = np.zeros((img_h, img_w), bool)
                m[max(int(v) - half, 0):int(v) + half,
                  max(int(u) - half, 0):int(u) + half] = True
                dets.append(dict(
                    cam_id=ci, category=name_to_cls[dict(zip(RAW_NAMES, MAPPED))[names[bi]]],
                    score=float(rng.uniform(0.6, 0.95)),
                    bbox=[int(u) - half, int(v) - half, int(u) + half, int(v) + half],
                    mask=m, offset=(0, 0)))
        planes, annos = paint_sample(dets, num_cams, len(NUSC_CLASSES), (img_h, img_w))
        masks = {(d["cam_id"], d["category"]): planes[d["cam_id"], :, :, d["category"]]
                 for d in dets}

        vel = rng.uniform(-3, 3, (len(boxes), 2)).astype(np.float64)
        if len(vel):
            vel[0] = np.nan  # real pickles carry NaN velocities
        num_lidar_pts = [int(rng.integers(5, 200)) for _ in names]
        infos.append(write_sample(root, i, token, pts, sweeps, key_ts, cams, masks, annos,
                                  boxes, names, vel, num_lidar_pts))
    return write_infos(root, infos, version=version), os.path.join(root, "masks")


def write_scene(root: str, index: int, scene: Dict[str, np.ndarray],
                cameras: Dict[str, np.ndarray], img_h: int, img_w: int, fx: float,
                scale: int = 1, n_sweeps: int = 9,
                class_names: Sequence[str] = NUSC_CLASS_NAMES) -> Dict:
    """Write sample 0 of a ``synthetic.py`` scene (``points`` with their
    ``valid`` rows, the GT) and its cameras (``make_camera_arrays`` at
    ``img_h`` x ``img_w`` with ``fx``) as sample ``index`` of the tree at
    ``root``; returns its info. Valid point ``j`` goes to the key frame when
    ``j % (n_sweeps + 1) == 0``, else to sweep ``j % (n_sweeps + 1) - 1``,
    stored in that sweep's sensor frame. The cameras are written at
    ``scale`` times their size (:func:`synthetic_cams`) and each mask plane
    is repeated ``scale`` x ``scale``, so masks read at downsample
    ``scale`` are the scene's own; the anno boxes scale with them."""
    pts = scene["points"][scene["valid"]].astype(np.float32)
    part = np.arange(len(pts)) % (n_sweeps + 1)
    key_ts = KEY_TIMESTAMP_US + index * 500_000
    sweeps = []
    for s in range(n_sweeps):
        r, t = _sweep_motion(s)
        sw = pts[part == s + 1].copy()
        sw[:, :3] = (sw[:, :3] - t) @ r
        sweeps.append((sw, r, t, key_ts - (s + 1) * 50_000))
    gv = scene["gt_valid"][0]
    boxes = scene["gt_boxes"][0][gv]
    names = [RAW_OF_CLASS[class_names[int(c)]] for c in scene["gt_labels"][0][gv]]
    num_cams = cameras["lidar2img"].shape[1]
    ids = (cameras["masks"][0] & 0xFF).astype(np.uint8)            # [cams, H, W, cls]
    ids = ids.repeat(scale, axis=1).repeat(scale, axis=2)
    masks = {(c, k): ids[c, :, :, k] for c in range(num_cams) for k in range(ids.shape[3])
             if ids[c, :, :, k].any()}
    anno = cameras["anno"][0]
    annos = [dict(bbox=[float(x) * scale for x in row[:4]], score=float(row[4]),
                  category=int(row[5]), cam_id=int(row[6]), obj_id=int(row[7]))
             for row in anno if row[8] > 0]
    cams = synthetic_cams(num_cams, img_h, img_w, fx, scale)
    return write_sample(root, index, f"scene{index:03d}", pts[part == 0], sweeps, key_ts, cams,
                        masks, annos, boxes[:, :7], names, boxes[:, 7:9].astype(np.float64),
                        np.zeros(len(names), np.int64))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--samples", type=int, default=4)
    ap.add_argument("--sweeps", type=int, default=2)
    ap.add_argument("--cams", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    info_path, mask_dir = write_dataset(
        args.out, n_samples=args.samples, n_sweeps=args.sweeps,
        num_cams=args.cams, seed=args.seed)
    print(f"wrote {info_path}\nmasks at {mask_dir}")


if __name__ == "__main__":
    main()
