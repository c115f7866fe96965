"""RoIAlign as mmcv's ``RoIAlign(aligned=True)``, and mmdet's
``SingleRoIExtractor`` over the FPN levels (the benchmark's HTC reference).

Each RoI's box (xyxy, image pixels) is scaled to the map and shifted by half
a pixel, split into ``out × out`` bins, and each bin averages ``2 × 2``
bilinear samples at the centres of its quarters. A sample reads mmcv's
``bilinear_interpolate``: 0 outside ``[-1, H] × [-1, W]``, otherwise its
coordinates raised to 0 and the corner past the last row or column read as
that row or column. Maps are ``[H, W, C]``; invalid RoIs give rows of 0.

Departure from mmcv, as in the program: a fixed 2 × 2 samples per bin
where mmdet's configuration asks for ``ceil(roi size / out)`` (its
``sampling_ratio=0``).
"""
from __future__ import annotations

from typing import Sequence

import torch

SAMPLES = 2
# RoIs pooled at once: bounds the samples held, ``RoIs · (out · 2)² · C``
CHUNK = 128


def _sample(flat: torch.Tensor, h: int, w: int, ys: torch.Tensor, xs: torch.Tensor
            ) -> torch.Tensor:
    """flat [H·W, C]; ys [R, S], xs [R, T] → [R, S, T, C]."""
    zero = ((ys < -1.0) | (ys > h))[:, :, None] | ((xs < -1.0) | (xs > w))[:, None, :]
    ys, xs = ys.clamp(min=0.0), xs.clamp(min=0.0)
    y0, x0 = ys.floor().clamp(max=h - 1), xs.floor().clamp(max=w - 1)
    ys = torch.where(y0 >= h - 1, y0, ys)
    xs = torch.where(x0 >= w - 1, x0, xs)
    y1 = (y0 + 1).clamp(max=h - 1)
    x1 = (x0 + 1).clamp(max=w - 1)
    ly, lx = ys - y0, xs - x0
    out = 0.0
    for cy, wy in ((y0, 1.0 - ly), (y1, ly)):
        for cx, wx in ((x0, 1.0 - lx), (x1, lx)):
            idx = (cy[:, :, None] * w + cx[:, None, :]).long()
            out = out + flat[idx] * (wy[:, :, None] * wx[:, None, :])[..., None]
    return out * (~zero)[..., None]


def roi_align(feat: torch.Tensor, rois: torch.Tensor, valid: torch.Tensor, out_size: int,
              spatial_scale: float, aligned: bool = True) -> torch.Tensor:
    """feat [H, W, C], rois [N, 4] xyxy image px, valid [N] → [N, out, out, C]."""
    h, w, c = feat.shape
    flat = feat.reshape(h * w, c)
    shift = 0.5 if aligned else 0.0
    q = (torch.arange(out_size * SAMPLES, dtype=torch.float32, device=rois.device) + 0.5) \
        / SAMPLES                       # bin units: bin i's samples at i + 1/4, i + 3/4
    outs = []
    for r0 in range(0, rois.shape[0], CHUNK):
        r = rois[r0:r0 + CHUNK] * spatial_scale - shift
        bin_w = (r[:, 2] - r[:, 0]) / out_size
        bin_h = (r[:, 3] - r[:, 1]) / out_size
        ys = r[:, 1:2] + q[None, :] * bin_h[:, None]
        xs = r[:, 0:1] + q[None, :] * bin_w[:, None]
        s = _sample(flat, h, w, ys, xs)                 # [R, 2·out, 2·out, C]
        n = s.shape[0]
        s = s.reshape(n, out_size, SAMPLES, out_size, SAMPLES, c).mean((2, 4))
        outs.append(s)
    out = torch.cat(outs) if outs else feat.new_zeros(0, out_size, out_size, c)
    return out * valid[:, None, None, None].to(out.dtype)


def roi_levels(rois: torch.Tensor, num_levels: int, finest_scale: float = 56.0
               ) -> torch.Tensor:
    """mmdet ``SingleRoIExtractor.map_roi_levels``: ⌊log2(√(w·h) / 56 + 1e-6)⌋
    in ``[0, num_levels − 1]`` → [N] long."""
    scale = torch.sqrt((rois[:, 2] - rois[:, 0]) * (rois[:, 3] - rois[:, 1]))
    return torch.floor(torch.log2(scale / finest_scale + 1e-6)).clamp(0, num_levels - 1).long()


def multilevel_roi_align(feats: Sequence[torch.Tensor], strides: Sequence[int],
                         rois: torch.Tensor, valid: torch.Tensor, out_size: int,
                         aligned: bool = True) -> torch.Tensor:
    """Each RoI pooled from its own level of ``feats`` ([H, W, C] each)
    → [N, out, out, C]."""
    lvl = roi_levels(rois, len(feats))
    out = feats[0].new_zeros(rois.shape[0], out_size, out_size, feats[0].shape[-1])
    for i, (f, s) in enumerate(zip(feats, strides)):
        at = torch.nonzero(lvl == i).reshape(-1)
        if at.numel():
            out[at] = roi_align(f, rois[at], valid[at], out_size, 1.0 / s, aligned)
    return out
