"""Deformable convolution v1 by its definition (the benchmark's HTC
reference; independent of the program's patch-image form).

    out[p] = Σ_k w_k · bilinear₀(x, p · stride − pad + k + Δk(p))

over the K × K taps ``k = (ky, kx)``, where ``bilinear₀`` reads every
corner outside the map as 0 (mmcv's ``deform_conv`` im2col) and ``Δk(p)``
is tap ``k``'s (dy, dx) at output pixel ``p``: channels ``2k`` and ``2k +
1`` of ``offsets [N, 2·K², Ho, Wo]``, taps in row-major order. One
deformable group; ``groups`` splits input and output channels group-major
as ``F.conv2d`` does. Each tap is one bilinear gather and one grouped
contraction (a batched matmul over the groups), accumulated tap by tap in
f32, for one image and a block of output rows at a time.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

# f32 bytes of one tap's samples in a block of output rows
BLOCK_BYTES = 64 * 2**20


def bilinear_zero(flat: torch.Tensor, h: int, w: int, ys: torch.Tensor,
                  xs: torch.Tensor) -> torch.Tensor:
    """flat [H·W, C] (a map's pixels, row-major); ys, xs [R, W'] sample
    coordinates → [R·W', C], each of the four corners outside the map
    contributing 0."""
    y0, x0 = torch.floor(ys).reshape(-1), torch.floor(xs).reshape(-1)
    fy, fx = ys.reshape(-1) - y0, xs.reshape(-1) - x0
    out = torch.zeros(y0.shape[0], flat.shape[1], dtype=flat.dtype, device=flat.device)
    for cy, wy in ((y0, 1.0 - fy), (y0 + 1.0, fy)):
        for cx, wx in ((x0, 1.0 - fx), (x0 + 1.0, fx)):
            inside = (cy >= 0) & (cy <= h - 1) & (cx >= 0) & (cx <= w - 1)
            idx = (cy.clamp(0, h - 1) * w + cx.clamp(0, w - 1)).long()
            out += flat[idx] * (wy * wx * inside)[:, None]
    return out


def deform_conv2d(x: torch.Tensor, offsets: torch.Tensor, weight: torch.Tensor,
                  stride: int = 1, padding: int = 1, groups: int = 1,
                  operand: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                  ) -> torch.Tensor:
    """x [N, Cin, H, W], offsets [N, 2·K², Ho, Wo], weight [Cout, Cin /
    groups, K, K] → [N, Cout, Ho, Wo]. ``operand`` (default: as is) is
    applied to both operands of each contraction (the control's rounding)."""
    n, cin, h, w = x.shape
    cout, cg, k, _ = weight.shape
    ho = (h + 2 * padding - k) // stride + 1
    wo = (w + 2 * padding - k) // stride + 1
    if offsets.shape != (n, 2 * k * k, ho, wo):
        raise ValueError(f"offsets {tuple(offsets.shape)}, expected {(n, 2 * k * k, ho, wo)}")
    op = operand or (lambda t: t)
    og = cout // groups
    # [K², G, Cin / G, Cout / G]: tap t's weights, group by group
    wk = op(weight.permute(2, 3, 0, 1).reshape(k * k, groups, og, cg).transpose(2, 3))
    rows = max(1, BLOCK_BYTES // (4 * cin * wo))
    out = torch.empty(n, cout, ho, wo, dtype=x.dtype, device=x.device)
    col = torch.arange(wo, dtype=x.dtype, device=x.device) * stride - padding
    for b in range(n):
        flat = x[b].reshape(cin, h * w).t().contiguous()
        for r0 in range(0, ho, rows):
            r1 = min(ho, r0 + rows)
            row = torch.arange(r0, r1, dtype=x.dtype, device=x.device) * stride - padding
            acc = torch.zeros(groups, (r1 - r0) * wo, og, dtype=x.dtype, device=x.device)
            for t in range(k * k):
                ky, kx = divmod(t, k)
                ys = row[:, None] + ky + offsets[b, 2 * t, r0:r1]
                xs = col[None, :] + kx + offsets[b, 2 * t + 1, r0:r1]
                samples = op(bilinear_zero(flat, h, w, ys, xs))          # [P, Cin]
                acc += torch.bmm(samples.reshape(-1, groups, cg).transpose(0, 1), wk[t])
            out[b, :, r0:r1] = acc.permute(0, 2, 1).reshape(cout, r1 - r0, wo)
    return out
