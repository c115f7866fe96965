"""2D RoIAlign and FPN multi-level RoI extraction (port of ``ops/roi_align.py``).

mmcv ``RoIAlign`` with ``aligned=True`` (half-pixel offset) and a fixed
2 × 2 samples per bin, averaged; sample coordinates are clamped to the map
(``[0, h − 1]``) before the floor. Rows of invalid RoIs are zeros. Feature
maps are ``[H, W, C]`` (the JAX package's layout); RoIs are ``[N, 4]`` xyxy
in image pixels.
"""
from __future__ import annotations

import functools
from typing import Sequence

import torch


def _pool(flat: torch.Tensor, base: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
          rois: torch.Tensor, scale: torch.Tensor, out_size: int,
          sampling_ratio: int) -> torch.Tensor:
    """RoIAlign of every RoI from rows ``base + y · w + x`` of ``flat [R, C]``;
    ``base``, ``h``, ``w`` (i64) and ``scale`` (f32) are per RoI, ``[N]``.
    Returns ``[N, out, out, C]`` (validity not applied)."""
    n = rois.shape[0]
    f32 = torch.float32
    ns = max(sampling_ratio, 2)
    r = rois * scale[:, None]
    x1, y1, x2, y2 = r[:, 0] - 0.5, r[:, 1] - 0.5, r[:, 2] - 0.5, r[:, 3] - 0.5
    bw = (x2 - x1) / out_size
    bh = (y2 - y1) / out_size
    fr = (torch.arange(ns, dtype=f32, device=rois.device) + 0.5) / ns
    by = torch.arange(out_size, dtype=f32, device=rois.device)
    gy = y1[:, None, None] + (by[None, :, None] + fr[None, None, :]) * bh[:, None, None]
    gx = x1[:, None, None] + (by[None, :, None] + fr[None, None, :]) * bw[:, None, None]
    hm1, wm1 = (h - 1).to(f32)[:, None], (w - 1).to(f32)[:, None]
    hi, wi, wmax, base = (h - 1)[:, None, None], w[:, None, None], (w - 1)[:, None, None], \
        base[:, None, None]
    out = None
    # one sample point of every bin at a time: [N, out, out, C] per term
    for sy in range(ns):
        ys = torch.minimum(gy[:, :, sy].clamp(min=0.0), hm1)[:, :, None]     # [N, out, 1]
        y0 = torch.floor(ys)
        wy = ys - y0
        y0 = y0.long()
        for sx in range(ns):
            xs = torch.minimum(gx[:, :, sx].clamp(min=0.0), wm1)[:, None, :]  # [N, 1, out]
            x0 = torch.floor(xs)
            wx = xs - x0
            x0 = x0.long()
            samp = None
            for dy, wyy in ((0, 1.0 - wy), (1, wy)):
                yi = torch.minimum(y0 + dy, hi)
                for dx, wxx in ((0, 1.0 - wx), (1, wx)):
                    xi = torch.minimum(x0 + dx, wmax)
                    v = flat[(base + yi * wi + xi).reshape(-1)].view(n, out_size, out_size, -1)
                    term = v * (wyy * wxx)[..., None]
                    samp = term if samp is None else samp + term
            out = samp if out is None else out + samp
    return out / (ns * ns)


def roi_align(feat: torch.Tensor, rois: torch.Tensor, valid: torch.Tensor, out_size: int,
              spatial_scale: float, sampling_ratio: int = 0) -> torch.Tensor:
    """feat [H, W, C], rois [N, 4] xyxy image px, valid [N] → [N, out, out, C].
    ``spatial_scale`` is 1 / the map's stride."""
    h, w, c = feat.shape
    n, dev = rois.shape[0], rois.device
    full = functools.partial(torch.full, (n,), device=dev)
    out = _pool(feat.reshape(h * w, c), full(0), full(h), full(w), rois,
                full(spatial_scale, dtype=torch.float32), out_size, sampling_ratio)
    return out * valid[:, None, None, None].to(out.dtype)


def map_rois_to_levels(rois: torch.Tensor, num_levels: int, finest_scale: int = 56
                       ) -> torch.Tensor:
    """mmdet ``SingleRoIExtractor``'s level of each RoI: ⌊log2(√area /
    finest_scale + 1e-6)⌋ clamped to ``[0, num_levels − 1]`` → [N] i32."""
    scale = torch.sqrt(((rois[:, 2] - rois[:, 0]) * (rois[:, 3] - rois[:, 1])).clamp(min=0.0))
    lvl = torch.floor(torch.log2(scale / finest_scale + 1e-6))
    return lvl.clamp(0, num_levels - 1).to(torch.int32)


def multilevel_roi_align(feats: Sequence[torch.Tensor], strides: Sequence[int],
                         rois: torch.Tensor, valid: torch.Tensor, out_size: int) -> torch.Tensor:
    """``SingleRoIExtractor``: each RoI pooled from its own pyramid level
    (``map_rois_to_levels``) → [N, out, out, C].

    The JAX package pools every RoI from all four levels and sums them
    masked by the level; the masked terms are exact zeros, so pooling each
    RoI from its own level only (one gather over the levels' rows laid end
    to end) gives the same numbers at a quarter of the work."""
    lvl = map_rois_to_levels(rois, len(feats))

    def per_roi(values, dtype):
        # a lookup by where(), not a host-to-device table that waits for the stream
        out = torch.zeros_like(lvl, dtype=dtype)
        for i, v in enumerate(values):
            out = torch.where(lvl == i, v, out)
        return out

    sizes = [f.shape[0] * f.shape[1] for f in feats]
    base = per_roi([sum(sizes[:i]) for i in range(len(feats))], torch.int64)
    h = per_roi([f.shape[0] for f in feats], torch.int64)
    w = per_roi([f.shape[1] for f in feats], torch.int64)
    scale = per_roi([1.0 / s for s in strides], torch.float32)
    flat = torch.cat([f.reshape(-1, f.shape[-1]) for f in feats])
    out = _pool(flat, base, h, w, rois, scale, out_size, 0)
    return out * valid[:, None, None, None].to(out.dtype)
