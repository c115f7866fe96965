"""FSF's mask tool on the host (the benchmark's HTC reference): each kept
detection's 28 × 28 probabilities pasted into its box, and the sample's
detections painted into the per-camera, per-class instance planes that
FSF's camera branch reads, with the anno table beside them.

Paste: a detection is kept if it is valid and scores at least ``score_thr``;
its probabilities × 255, cut to uint8, are resized to the rounded box size
by Pillow's ``Image.resize(..., BILINEAR)`` (computed here in NumPy, with
Pillow's 22-bit fixed-point coefficients), thresholded at > 127, and placed
at the rounded top-left corner, clipped to the canvas. Paint: the top
``max_anno`` by score are the anno rows (row = rank), painted in ascending
score so that a higher score overwrites, pixel = row + 1."""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

NUIM_CLASSES = ("car", "truck", "trailer", "bus", "construction_vehicle", "bicycle",
                "motorcycle", "pedestrian", "traffic_cone", "barrier")
NUSC_CLASSES = ("car", "truck", "construction_vehicle", "bus", "trailer", "barrier",
                "motorcycle", "bicycle", "pedestrian", "traffic_cone")
BITS = 22      # Pillow's PRECISION_BITS for 8-bit images (32 - 8 - 2)


def pillow_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] int64: Pillow's bilinear ``precompute_coeffs`` of one
    axis (a triangle filter, widened by the scale when shrinking, over the
    input pixels ``[lo, hi)`` of each output pixel, each row normalized by
    its sum taken tap by tap in double) rounded to ``BITS`` fractional
    bits."""
    scale = n_in / n_out
    fscale = max(scale, 1.0)
    centre = (np.arange(n_out) + 0.5) * scale
    lo = np.maximum(np.trunc(centre - fscale + 0.5).astype(np.int64), 0)
    hi = np.minimum(np.trunc(centre + fscale + 0.5).astype(np.int64), n_in)
    taps = []
    for t in range(int((hi - lo).max())):
        x = lo + t
        taps.append(np.where(x < hi, np.maximum(1.0 - np.abs((x - centre + 0.5) / fscale), 0.0),
                             0.0))
    total = np.zeros(n_out)
    for k in taps:                         # Pillow's order of the sum
        total = total + k
    out = np.zeros((n_out, n_in), np.int64)
    rows = np.arange(n_out)
    for t, k in enumerate(taps):
        k = np.where(total != 0.0, k / np.where(total == 0.0, 1.0, total), k)
        x = lo + t
        inside = x < hi
        out[rows[inside], x[inside]] = np.trunc(0.5 + k[inside] * (1 << BITS)).astype(np.int64)
    return out


def _pass(a: np.ndarray, wts: np.ndarray, axis: int) -> np.ndarray:
    acc = np.tensordot(a.astype(np.int64), wts, axes=([axis], [1]))
    if axis == 0:
        acc = acc.T
    return np.clip((acc + (1 << (BITS - 1))) >> BITS, 0, 255).astype(np.uint8)


def resize_bilinear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """Pillow's 8-bit bilinear resize of a 2-D uint8 array: the horizontal
    pass, rounded and clipped to 8 bits, then the vertical; a pass is left
    out where its size stays."""
    out = img
    if width != img.shape[1]:
        out = _pass(out, pillow_weights(img.shape[1], width), 1)
    if height != img.shape[0]:
        out = _pass(out, pillow_weights(img.shape[0], height), 0)
    return out


def paste(dets: Sequence[dict], img_hw: Tuple[int, int], score_thr: float) -> List[dict]:
    """Per camera in order, ``dets[cam]`` a dict of host arrays (boxes,
    scores, labels (nuImages), masks, valid) → the kept detections: cam_id,
    category (nuScenes), score, bbox, the clipped boolean mask, its
    (row, column) offset."""
    h, w = img_hw
    out = []
    for cam, d in enumerate(dets):
        for j in range(len(d["scores"])):
            if not d["valid"][j] or d["scores"][j] < score_thr:
                continue
            x1, y1, x2, y2 = d["boxes"][j]
            bw = max(int(round(x2 - x1)), 1)
            bh = max(int(round(y2 - y1)), 1)
            m = resize_bilinear((d["masks"][j] * 255).astype(np.uint8), bw, bh) > 127
            top, left = int(round(y1)), int(round(x1))
            out.append(dict(cam_id=cam,
                            category=NUSC_CLASSES.index(NUIM_CLASSES[int(d["labels"][j])]),
                            score=float(d["scores"][j]), bbox=[float(v) for v in d["boxes"][j]],
                            mask=m[:max(0, h - top), :max(0, w - left)], offset=(top, left)))
    return out


def paint(kept: Sequence[dict], num_cams: int, num_classes: int, img_hw: Tuple[int, int],
          max_anno: int) -> Tuple[np.ndarray, np.ndarray]:
    """→ (planes [cams, H, W, classes] uint8, anno [max_anno, 9] f32: x1,
    y1, x2, y2, score, category, cam_id, row, 1)."""
    h, w = img_hw
    by_score = sorted(range(len(kept)), key=lambda i: -kept[i]["score"])[:max_anno]
    ascending = sorted(by_score, key=lambda i: kept[i]["score"])
    rank = {i: r for r, i in enumerate(sorted(ascending, key=lambda i: -kept[i]["score"]))}
    planes = np.zeros((num_cams, h, w, num_classes), np.uint8)
    anno = np.zeros((max_anno, 9), np.float32)
    for i in ascending:
        d = kept[i]
        (top, left), m = d["offset"], d["mask"]
        view = planes[d["cam_id"], top:top + m.shape[0], left:left + m.shape[1], d["category"]]
        view[m] = rank[i] + 1
        anno[rank[i]] = [*d["bbox"], d["score"], d["category"], d["cam_id"], rank[i], 1.0]
    return planes, anno


def pad(images: np.ndarray) -> np.ndarray:
    """[cams, H, W, 3] uint8 → f32, zero-padded at the bottom and right to
    multiples of 32."""
    n, h, w, _ = images.shape
    out = np.zeros((n, math.ceil(h / 32) * 32, math.ceil(w / 32) * 32, 3), np.float32)
    out[:, :h, :w] = images
    return out
