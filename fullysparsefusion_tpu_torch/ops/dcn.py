"""Deformable convolution, v1 and modulated v2 (port of ``ops/dcn.py``).

    out[p] = Σ_k m_k(p) · x(p + k + Δk(p)) @ w[k]

Layouts are PyTorch's (as ``torchvision.ops.deform_conv2d``'s): ``x [N,
Cin, H, W]``, ``offsets [N, 2·K², Ho, Wo]`` with (dy, dx) of each tap
interleaved in mmcv's order, ``mask [N, K², Ho, Wo]``, ``weight [Cout,
Cin/groups, K, K]``. Each sample is bilinear with every corner outside the
map read as 0 (RoIAlign clamps instead). ``groups`` splits input and output
channels group-major, as ``F.conv2d`` does; the deformable groups are 1.

The samples are laid out as an image of ``K × K`` patches, ``[Cin, Ho·K,
Wo·K]``, so the contraction is ``F.conv2d`` with a ``K × K`` kernel at
stride ``K``. Row gathers go through an ``[H·W, Cin]`` view of each image,
and the output rows are taken in chunks so that one chunk's samples stay
under ``SAMPLE_BYTES``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

# f32 bytes of one chunk's sample image; the chunk holds about two such
# tensors at once (the running sum and a gathered corner)
SAMPLE_BYTES = 256 * 2**20


def _bilinear_zero_pad(flat: torch.Tensor, h: int, w: int, ys: torch.Tensor,
                       xs: torch.Tensor) -> torch.Tensor:
    """flat [H·W, C]; ys / xs [...] pixel coordinates → [..., C], each
    corner outside the map contributing 0."""
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = ys - y0
    wx = xs - x0
    y0, x0 = y0.long(), x0.long()
    out = None
    for dy, wyy in ((0, 1.0 - wy), (1, wy)):
        for dx, wxx in ((0, 1.0 - wx), (1, wx)):
            yi = y0 + dy
            xi = x0 + dx
            ok = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
            v = flat.index_select(0, idx.reshape(-1)).view(*idx.shape, -1)
            term = v.mul_((wyy * wxx * ok)[..., None])
            out = term if out is None else out.add_(term)
    return out


def deform_conv2d(x: torch.Tensor, offsets: torch.Tensor, weight: torch.Tensor,
                  mask: Optional[torch.Tensor] = None, stride: int = 1, padding: int = 1,
                  bias: Optional[torch.Tensor] = None, groups: int = 1) -> torch.Tensor:
    """Deformable conv (DCNv2 when ``mask`` is given, v1 otherwise) →
    ``[N, Cout, Ho, Wo]``."""
    n, cin, h, w = x.shape
    cout, _, k, _ = weight.shape
    ho = (h + 2 * padding - k) // stride + 1
    wo = (w + 2 * padding - k) // stride + 1
    if offsets.shape != (n, 2 * k * k, ho, wo):
        raise ValueError(f"offsets {tuple(offsets.shape)}, expected {(n, 2 * k * k, ho, wo)}")
    dev, f32 = x.device, x.dtype
    tap = torch.arange(k, dtype=f32, device=dev)
    # chunk of output rows: its samples [rows, K, Wo, K, Cin] under SAMPLE_BYTES
    rows = max(1, SAMPLE_BYTES // (k * k * wo * cin * x.element_size()))
    out = torch.empty(n, cout, ho, wo, dtype=x.dtype, device=dev,
                      memory_format=torch.channels_last)
    for b in range(n):
        flat = x[b].permute(1, 2, 0).reshape(h * w, cin)
        for r0 in range(0, ho, rows):
            r1 = min(ho, r0 + rows)
            off = offsets[b, :, r0:r1].reshape(k, k, 2, r1 - r0, wo)
            # [rows, K (ky), Wo, K (kx)]: each output pixel's K × K patch
            dy = off[:, :, 0].permute(2, 0, 3, 1)
            dx = off[:, :, 1].permute(2, 0, 3, 1)
            base_y = torch.arange(r0, r1, dtype=f32, device=dev) * stride - padding
            base_x = torch.arange(wo, dtype=f32, device=dev) * stride - padding
            ys = (base_y[:, None, None, None] + tap[None, :, None, None]) + dy
            xs = (base_x[None, None, :, None] + tap[None, None, None, :]) + dx
            samp = _bilinear_zero_pad(flat, h, w, ys, xs)      # [rows, K, Wo, K, Cin]
            if mask is not None:
                m = mask[b, :, r0:r1].reshape(k, k, r1 - r0, wo).permute(2, 0, 3, 1)
                samp = samp * m[..., None]
            img = samp.view(1, (r1 - r0) * k, wo * k, cin).permute(0, 3, 1, 2)
            out[b:b + 1, :, r0:r1] = F.conv2d(img, weight, stride=k, groups=groups)
    if bias is not None:
        out = out + bias[None, :, None, None]
    return out


def dcn_offsets_conv(x: torch.Tensor, w_off: torch.Tensor, b_off: torch.Tensor, k: int,
                     stride: int = 1, padding: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The DCNv2 offset / mask branch: a plain conv to 3·K² channels →
    (offsets [N, 2K², Ho, Wo], sigmoid mask [N, K², Ho, Wo]);
    ``w_off [3K², Cin, K, K]``."""
    out = F.conv2d(x, w_off, b_off, stride=stride, padding=padding)
    k2 = k * k
    return out[:, :2 * k2], torch.sigmoid(out[:, 2 * k2:])
