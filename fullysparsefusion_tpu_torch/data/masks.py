"""Offline 2D instance-mask loading → CameraData (the port's copy of the JAX
package's ``data/masks.py``, reading and writing the PNGs through
``data/png.py``; :func:`save_sample` is the mask tool's writer).

Replaces LoadMaskFromFiles (datasets/pipelines/loading.py:21-339): the
offline HTC pre-inference (tools/mask_tools/save_mask_nusc.py) writes, per
sample token, one PNG per (camera, class) whose pixels hold instance ids
(anno row + 1, 0 = background) plus an ``anno.json`` with rows
[bbox(4), score, category, cam_id, obj_id]. We load them into the fixed
CHANNEL-LAST ``[cams, H, W, classes]`` uint8 tensor (one pixel's class
planes contiguous — the on-device lookup row-gathers all classes at once,
7× faster than scalar gathers; ops/projection.py) + the [A, 9] anno table
(reorg_anno_multi_cls, loading.py:301-339: rows sorted by obj_id, padded to
a fixed count with a validity flag).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .png import read_png as _read_png
from .png import write_png


def reorg_anno(
    raw_annos: List[dict], max_anno: int = 250
) -> np.ndarray:
    """[A, 9] anno rows sorted by obj_id: [x1,y1,x2,y2,score,category,cam_id,
    obj_id,valid]."""
    out = np.zeros((max_anno, 9), np.float32)
    rows = sorted(raw_annos, key=lambda a: a["obj_id"])
    for a in rows:
        i = int(a["obj_id"])
        if i >= max_anno:
            continue
        out[i, :4] = a["bbox"]
        out[i, 4] = a["score"]
        out[i, 5] = a["category"]
        out[i, 6] = a["cam_id"]
        out[i, 7] = a["obj_id"]
        out[i, 8] = 1.0
    return out


def pack_mask_scores(masks_u8: np.ndarray, anno: np.ndarray) -> np.ndarray:
    """Pack per-pixel (instance id, quantized score) into one uint16 texture.

    value = id | round(score·255) << 8, with id = anno row + 1 (0 = bg; ids
    fit u8 because the id PNGs are u8). Folding the score into the texture
    lets the on-device lookup read both with ONE row gather — the separate
    per-(point, class) score gather from the tiny anno table was the single
    most expensive op in the model (1.31M scalar gathers ≈ 10.2 ms on v5e;
    docs/performance.md). Host-side numpy; anno may be [A, 9] or [B, A, 9]
    matching masks [cams, ...] or [B, cams, ...].
    """
    masks_u8 = np.asarray(masks_u8)
    anno = np.asarray(anno)
    if anno.ndim == 2:
        score_u8 = np.zeros(anno.shape[0] + 1, np.uint16)
        score_u8[1:] = np.round(anno[:, 4] * 255).astype(np.uint16)
        packed = masks_u8.astype(np.uint16) | (score_u8[masks_u8] << 8)
        return packed
    if anno.ndim != 3 or masks_u8.shape[0] != anno.shape[0]:
        raise ValueError("anno must be [A, 9] or [B, A, 9] matching masks")
    return np.stack(
        [pack_mask_scores(masks_u8[b], anno[b]) for b in range(anno.shape[0])]
    )


def save_sample(out_dir: str, token: str, masks: Mapping[Tuple[int, int], np.ndarray],
                annos: List[Dict]) -> None:
    """Write one sample's mask tree (the mask tool's ``save_sample``):
    ``{cam}_{cls}.png`` per plane of ``masks`` ({(cam, cls): [H, W] instance
    ids}, cast to uint8) and ``anno.json`` with the ``annos`` rows."""
    sdir = os.path.join(out_dir, token)
    os.makedirs(sdir, exist_ok=True)
    for (cam, cls), m in masks.items():
        write_png(os.path.join(sdir, f"{cam}_{cls}.png"), np.asarray(m).astype(np.uint8))
    with open(os.path.join(sdir, "anno.json"), "w") as f:
        json.dump(annos, f)


def load_sample_masks(
    mask_dir: str,
    token: str,
    num_cams: int,
    num_classes: int,
    img_hw: Tuple[int, int],
    max_anno: int = 250,
    downsample: int = 1,
) -> Tuple[np.ndarray, np.ndarray]:
    """(masks [cams, H/d, W/d, classes] uint8 channel-last, anno [A, 9]).

    Missing files mean "no instances of that (cam, class)". ``downsample``
    strides the mask grid (nearest) to trade mask precision for HBM — the
    lookup path divides projected pixels accordingly.
    """
    h, w = img_hw
    hs, ws = h // downsample, w // downsample
    masks = np.zeros((num_cams, hs, ws, num_classes), np.uint8)
    sdir = os.path.join(mask_dir, token)
    anno_path = os.path.join(sdir, "anno.json")
    if not os.path.isfile(anno_path):
        return masks, np.zeros((max_anno, 9), np.float32)
    with open(anno_path) as f:
        raw = json.load(f)
    anno = reorg_anno(raw if isinstance(raw, list) else raw.get("annos", []), max_anno)
    for cam in range(num_cams):
        for cls in range(num_classes):
            p = os.path.join(sdir, f"{cam}_{cls}.png")
            if os.path.isfile(p):
                img = _read_png(p)
                masks[cam, :, :, cls] = img[::downsample, ::downsample].astype(np.uint8)
    if downsample > 1:
        anno = anno.copy()
        anno[:, :4] /= downsample
    return masks, anno


def load_sample_masks_single_channel(
    mask_dir: str,
    token: str,
    num_cams: int,
    num_classes: int,
    img_hw: Tuple[int, int],
    max_anno: int = 250,
    front_cam: int = 0,
    front_hw: Optional[Tuple[int, int]] = None,
    downsample: int = 1,
) -> Tuple[np.ndarray, np.ndarray]:
    """AV2/Waymo variant (loading.py:141-186): one instance-id PNG per camera
    (no per-class planes); the per-class layout is reconstructed from the
    anno table's category column. AV2's front camera has a different
    resolution and is resized (nearest) onto the common grid.
    """
    h, w = img_hw
    hs, ws = h // downsample, w // downsample
    masks = np.zeros((num_cams, hs, ws, num_classes), np.uint8)
    sdir = os.path.join(mask_dir, token)
    anno_path = os.path.join(sdir, "anno.json")
    if not os.path.isfile(anno_path):
        return masks, np.zeros((max_anno, 9), np.float32)
    with open(anno_path) as f:
        raw = json.load(f)
    anno = reorg_anno(raw if isinstance(raw, list) else raw.get("annos", []), max_anno)
    cat_of = anno[:, 5].astype(np.int32)
    for cam in range(num_cams):
        p = os.path.join(sdir, f"{cam}.png")
        if not os.path.isfile(p):
            continue
        img = _read_png(p).astype(np.int32)
        if cam == front_cam and front_hw is not None and img.shape[:2] != (h, w):
            # nearest resize onto the common grid
            ys = (np.arange(h) * img.shape[0] // h).clip(0, img.shape[0] - 1)
            xs = (np.arange(w) * img.shape[1] // w).clip(0, img.shape[1] - 1)
            img = img[ys][:, xs]
        img = img[::downsample, ::downsample]
        # route each instance id into its class plane
        ids = np.unique(img)
        for oid in ids:
            if oid <= 0 or oid > max_anno:
                continue
            cls = int(cat_of[oid - 1])
            if 0 <= cls < num_classes:
                masks[cam, :, :, cls][img == oid] = oid
    if downsample > 1:
        anno = anno.copy()
        anno[:, :4] /= downsample
    return masks, anno


WAYMO_CLASS_NAMES = ("vehicle", "pedestrian", "cyclist")


def _nearest_resize(img: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    h, w = hw
    if img.shape[:2] == (h, w):
        return img
    ys = (np.arange(h) * img.shape[0] // h).clip(0, img.shape[0] - 1)
    xs = (np.arange(w) * img.shape[1] // w).clip(0, img.shape[1] - 1)
    return img[ys][:, xs]


def _flatten_nested_anno(raw: dict, class_names: Sequence[str]) -> List[dict]:
    """Reference Waymo anno layout {cam_id: {cls_name: [objs]}} → flat rows
    (reorg_anno_multi_cls input, loading.py:301-339). obj_ids are assigned
    globally by descending score when absent."""
    rows = []
    for cam_id, per_cls in raw.items():
        for cls_name, objs in per_cls.items():
            cat = class_names.index(cls_name) if cls_name in class_names else -1
            for o in objs:
                rows.append(dict(
                    bbox=o["bbox"], score=o.get("score", 1.0),
                    category=o.get("category", cat), cam_id=int(cam_id),
                    obj_id=o.get("obj_id", -1),
                ))
    if any(r["obj_id"] < 0 for r in rows):
        rows.sort(key=lambda r: -r["score"])
        for i, r in enumerate(rows):
            r["obj_id"] = i
    return rows


def load_sample_masks_waymo(
    mask_dir: str,
    sample_idx: str,
    lidar2img: np.ndarray,            # [cams, 4, 4]; returned rescaled
    img_hw: Tuple[int, int] = (1280, 1920),
    class_names: Sequence[str] = WAYMO_CLASS_NAMES,
    num_cams: int = 5,
    resize_cams: Sequence[int] = (3, 4),
    max_anno: int = 250,
    downsample: int = 1,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Waymo variant (load_waymo, loading.py:141-167): 5 cameras × 3 named
    class PNGs ``{cam}_{name}.png``; the two back cameras have a different
    native resolution and are nearest-resized onto the common grid with the
    matching lidar2img row scaling (resize_img_waymo, loading.py:98-139).
    Returns (masks [cams, H/d, W/d, cls] uint8, anno [A, 9], lidar2img).
    """
    h, w = img_hw
    hs, ws = h // downsample, w // downsample
    nc = len(class_names)
    masks = np.zeros((num_cams, hs, ws, nc), np.uint8)
    l2i = np.asarray(lidar2img, np.float32).copy()
    sdir = os.path.join(mask_dir, str(sample_idx))
    anno_path = os.path.join(sdir, "anno.json")
    if not os.path.isfile(anno_path):
        return masks, np.zeros((max_anno, 9), np.float32), l2i
    with open(anno_path) as f:
        raw = json.load(f)
    if isinstance(raw, dict) and raw and not isinstance(next(iter(raw.values())), (int, float, str)):
        flat = _flatten_nested_anno(raw, class_names)
    else:
        flat = raw if isinstance(raw, list) else raw.get("annos", [])
    anno = reorg_anno(flat, max_anno)
    scaled_cams = set()
    for cam in range(num_cams):
        for ci, name in enumerate(class_names):
            p = os.path.join(sdir, f"{cam}_{name}.png")
            if not os.path.isfile(p):
                p2 = os.path.join(sdir, f"{cam}_{ci}.png")  # index-named fallback
                if not os.path.isfile(p2):
                    continue
                p = p2
            img = _read_png(p).astype(np.int32)
            if cam in resize_cams and img.shape[:2] != (h, w):
                if cam not in scaled_cams:  # once per camera, not per class
                    scaled_cams.add(cam)
                    l2i[cam, 0] *= w / img.shape[1]
                    l2i[cam, 1] *= h / img.shape[0]
                    # rescale the camera's anno bboxes too (resize_img_waymo)
                    sel = anno[:, 6] == cam
                    anno[sel, 0] *= w / img.shape[1]
                    anno[sel, 2] *= w / img.shape[1]
                    anno[sel, 1] *= h / img.shape[0]
                    anno[sel, 3] *= h / img.shape[0]
                img = _nearest_resize(img, (h, w))
            masks[cam, :, :, ci] = img[::downsample, ::downsample]
    if downsample > 1:
        anno = anno.copy()
        anno[:, :4] /= downsample
    return masks, anno, l2i


def make_camera_batch(
    samples_masks: List[np.ndarray],
    samples_annos: List[np.ndarray],
    samples_lidar2img: List[np.ndarray],
):
    """Stack per-sample mask data into the CameraData arrays."""
    return (
        np.stack(samples_masks),
        np.stack(samples_annos),
        np.stack(samples_lidar2img),
    )
