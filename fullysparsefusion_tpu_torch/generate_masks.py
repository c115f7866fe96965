"""Camera instance masks from the HTC model (port of the ``jax-htc`` backend
of ``tools/generate_masks.py`` and of ``data/masks.py::reorg_anno``).

One nuScenes sample's camera images go through :class:`~.models.htc.HTC`
as one batch (each padded to a multiple of 32); on the host each kept
detection's 28 × 28 probability map is quantized to uint8, resized to its
box with PIL's integer bilinear resample (:func:`resize_bilinear_u8`),
thresholded at > 127 and pasted into the canvas; nuImages classes map to
nuScenes classes; then the detections are painted as the tool does (the
top ``max_anno`` by score, higher scores painted last, pixel value = anno
row + 1). The result is what ``data/masks.py::load_sample_masks`` reads
from the tool's PNGs: ``[cams, H, W, classes]`` uint8 instance ids and the
``[max_anno, 9]`` anno table, which ``synthetic.pack_mask_scores`` packs
for FSF. No PNG is written and no info pickle read here.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .models.htc import HTC, NUIM_CLASSES, Detections

# standard nuScenes detection class order
NUSC_CLASSES = (
    "car", "truck", "construction_vehicle", "bus", "trailer", "barrier",
    "motorcycle", "bicycle", "pedestrian", "traffic_cone",
)
NUIM_TO_NUSC = tuple(NUSC_CLASSES.index(n) for n in NUIM_CLASSES)

# Pillow's fixed-point resample (libImaging/Resample.c): 8-bit pixels,
# coefficients with 22 fractional bits
_PRECISION_BITS = 32 - 8 - 2


def _resample_coeffs(in_size: int, out_size: int) -> np.ndarray:
    """Pillow's bilinear coefficients of one axis as a dense integer matrix
    ``[out_size, in_size]`` (``precompute_coeffs`` + ``normalize_coeffs_8bpc``:
    a triangle filter widened by the scale when shrinking, each row
    normalized in double, then rounded to 22-bit fixed point)."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    x = np.arange(ksize)
    arg = np.abs(((x[None, :] + xmin[:, None]) - center[:, None] + 0.5) * (1.0 / filterscale))
    k = np.where((arg < 1.0) & (x[None, :] < xmax[:, None]), 1.0 - arg, 0.0)
    ww = np.zeros(out_size)
    for j in range(ksize):  # the C loop's order of the double sum
        ww = ww + k[:, j]
    k = np.where(ww[:, None] != 0.0, k / np.where(ww == 0.0, 1.0, ww)[:, None], k)
    kk = np.trunc(0.5 + k * (1 << _PRECISION_BITS)).astype(np.int64)
    dense = np.zeros((out_size, in_size + ksize), np.int64)
    np.put_along_axis(dense, xmin[:, None] + x[None, :], kk, axis=1)
    return dense[:, :in_size]


def _clip8(acc: np.ndarray) -> np.ndarray:
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bilinear_u8(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``PIL.Image.fromarray(img).resize((width, height), Image.BILINEAR)``
    for a 2-D uint8 array, bitwise: the horizontal pass (rounded and clipped
    to 8 bits), then the vertical pass, each skipped where the size stays."""
    out = img
    half = 1 << (_PRECISION_BITS - 1)
    if width != img.shape[1]:
        out = _clip8(out.astype(np.int64) @ _resample_coeffs(img.shape[1], width).T + half)
    if height != img.shape[0]:
        out = _clip8(_resample_coeffs(img.shape[0], height) @ out.astype(np.int64) + half)
    return out


def pad_images(images: np.ndarray) -> np.ndarray:
    """[cams, H, W, 3] uint8 → [cams, Hp, Wp, 3] f32, zero-padded to
    multiples of 32 at the bottom and right."""
    n, h, w, _ = images.shape
    hp, wp = -(-h // 32) * 32, -(-w // 32) * 32
    pad = np.zeros((n, hp, wp, 3), np.float32)
    pad[:, :h, :w] = images
    return pad


@torch.inference_mode()
def run_htc(model: HTC, images: np.ndarray) -> List[Detections]:
    """The device work: one sample's padded cameras through ``model`` as
    one batch → per-camera ``Detections`` on the model's device."""
    dev = next(model.parameters()).device
    return model(torch.from_numpy(pad_images(images)).to(dev))


def paste_detections(dets: Sequence[Detections], img_hw: Tuple[int, int],
                     score_thr: float = 0.3) -> List[dict]:
    """The host work of the tool's ``jax-htc`` backend: each valid
    detection scoring at least ``score_thr`` → a dict with ``cam_id``,
    nuScenes ``category``, ``score``, ``bbox``, its box-sized boolean
    ``mask`` clipped to the canvas and the mask's top-left ``offset``
    (row, column)."""
    h, w = img_hw
    out = []
    for cam_id, det in enumerate(dets):
        boxes, scores, labels, probs, valid = (t.cpu().numpy() for t in det)
        for j in range(len(scores)):
            if not valid[j] or scores[j] < score_thr:
                continue
            x1, y1, x2, y2 = boxes[j]
            bw = max(int(round(x2 - x1)), 1)
            bh = max(int(round(y2 - y1)), 1)
            mbox = resize_bilinear_u8((probs[j] * 255).astype(np.uint8), bw, bh) > 127
            yy, xx = int(round(y1)), int(round(x1))
            out.append(dict(
                cam_id=cam_id, category=NUIM_TO_NUSC[int(labels[j])], score=float(scores[j]),
                bbox=[float(v) for v in boxes[j]],
                mask=mbox[: max(0, h - yy), : max(0, w - xx)], offset=(yy, xx)))
    return out


def paint_sample(dets: Sequence[dict], num_cams: int, num_classes: int,
                 img_hw: Tuple[int, int], max_anno: int = 250):
    """Detections → (``[cams, H, W, classes]`` uint8 instance ids, anno
    rows): the top ``max_anno`` by score (stable), anno row = rank, painted
    in ascending score so that higher scores overwrite, pixel = row + 1."""
    h, w = img_hw
    score = [d["score"] for d in dets]
    top = sorted(range(len(dets)), key=lambda i: -score[i])[:max_anno]
    ascending = sorted(top, key=lambda i: score[i])
    rows = sorted(ascending, key=lambda i: -score[i])
    annos = [dict(bbox=[float(x) for x in dets[i]["bbox"]], score=float(score[i]),
                  category=int(dets[i]["category"]), cam_id=int(dets[i]["cam_id"]), obj_id=row)
             for row, i in enumerate(rows)]
    row_of = {i: row for row, i in enumerate(rows)}
    planes = np.zeros((num_cams, h, w, num_classes), np.uint8)
    for i in ascending:
        d = dets[i]
        (yy, xx), m = d["offset"], d["mask"]
        region = planes[int(d["cam_id"]), yy:yy + m.shape[0], xx:xx + m.shape[1],
                        int(d["category"])]
        region[m] = row_of[i] + 1
    return planes, annos


def reorg_anno(raw_annos: Sequence[dict], max_anno: int = 250) -> np.ndarray:
    """[A, 9] anno rows sorted by obj_id: [x1, y1, x2, y2, score, category,
    cam_id, obj_id, valid]."""
    out = np.zeros((max_anno, 9), np.float32)
    for a in sorted(raw_annos, key=lambda a: a["obj_id"]):
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


def sample_masks(model: HTC, images: np.ndarray, score_thr: float = 0.3, num_classes: int = 10,
                 max_anno: int = 250) -> Tuple[np.ndarray, np.ndarray]:
    """One sample's camera images [cams, H, W, 3] uint8 → (``[cams, H, W,
    classes]`` uint8 instance ids, ``[max_anno, 9]`` anno table)."""
    n, h, w, _ = images.shape
    dets = paste_detections(run_htc(model, images), (h, w), score_thr)
    planes, annos = paint_sample(dets, n, num_classes, (h, w), max_anno)
    return planes, reorg_anno(annos, max_anno)
