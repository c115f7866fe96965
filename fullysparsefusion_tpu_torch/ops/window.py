"""SST window partitioning (port of ``ops/window.py``): voxels grouped into
(optionally half-shifted) windows, scattered into padded
[windows_cap, max_tokens, C] token tensors with masks and gathered back.

Windows are segments (``unique_segments`` over the window key) and tokens
take their in-window position from ``ingroup_indices``. Tokens past
``max_tokens`` are dropped (the reference's ``drop_info`` semantics). The
voxels of windows past ``windows_cap`` get segment id ``windows_cap``: they
go to a trash row on the way in and, as in the JAX package, read the last
window's token at their inner index on the way out.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from .segment import SegmentInfo, ingroup_indices, unique_segments


class WindowPartition(NamedTuple):
    seg: SegmentInfo               # voxel → window grouping
    inner_idx: torch.Tensor        # [N] position of each voxel inside its window
    win_coords: torch.Tensor       # [N, 3] window coords per voxel
    tokens_per_win: torch.Tensor   # [windows_cap] token counts


def window_partition(coords: torch.Tensor, batch: torch.Tensor, valid: torch.Tensor,
                     sparse_shape: Tuple[int, int, int], window_shape: Tuple[int, int, int],
                     shift: bool, windows_cap: int) -> WindowPartition:
    """Assign voxels (coords [N, 3] as x, y, z) to windows; the shifted
    variant offsets the coordinates by half a window before the division
    and has one more window along each axis."""
    ws = torch.tensor(window_shape, dtype=torch.int32, device=coords.device)
    off = ws // 2 if shift else torch.zeros_like(ws)
    win = torch.div(coords.to(torch.int32) + off, ws, rounding_mode="floor")
    nwx, nwy, nwz = ((s + w - 1) // w + (1 if shift else 0)
                     for s, w in zip(sparse_shape, window_shape))
    key = ((batch.to(torch.int32) * nwz + win[:, 2]) * nwy + win[:, 1]) * nwx + win[:, 0]
    seg = unique_segments(key, valid, windows_cap)
    inner = ingroup_indices(torch.where(valid, key, torch.full_like(key, -1)), valid)
    return WindowPartition(seg=seg, inner_idx=inner, win_coords=win, tokens_per_win=seg.counts)


def _kept(part: WindowPartition, valid: torch.Tensor, max_tokens: int) -> torch.Tensor:
    return valid & (part.inner_idx >= 0) & (part.inner_idx < max_tokens)


def flat_to_window(feats: torch.Tensor, part: WindowPartition, valid: torch.Tensor,
                   max_tokens: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter flat voxel features [N, C] into [windows_cap, max_tokens, C]
    and the token mask [windows_cap, max_tokens]."""
    win_cap = part.seg.capacity
    keep = _kept(part, valid, max_tokens)
    w = torch.where(keep, part.seg.seg_id, torch.full_like(part.seg.seg_id, win_cap)).long()
    t = torch.where(keep, part.inner_idx, torch.zeros_like(part.inner_idx)).long()
    out = feats.new_zeros(win_cap + 1, max_tokens, feats.shape[-1])
    out = out.index_put((w, t), torch.where(keep[:, None], feats, torch.zeros_like(feats)))
    mask = torch.zeros(win_cap + 1, max_tokens, dtype=torch.bool, device=feats.device)
    mask = mask.index_put((w, t), keep)
    return out[:win_cap], mask[:win_cap]


def window_to_flat(win_feats: torch.Tensor, part: WindowPartition, valid: torch.Tensor,
                   max_tokens: int) -> torch.Tensor:
    """Gather [windows_cap, max_tokens, C] back to flat order [N, C];
    dropped tokens get zeros (the voxels of overflowed windows read the
    last window's row, see the module docstring)."""
    win_cap = part.seg.capacity
    keep = _kept(part, valid, max_tokens)
    w = part.seg.seg_id.clamp(0, win_cap - 1).long()
    t = part.inner_idx.clamp(0, max_tokens - 1).long()
    out = win_feats[w, t]
    return out * keep[:, None].to(out.dtype)


def window_position_embedding(coords: torch.Tensor, part: Optional[WindowPartition],
                              window_shape: Tuple[int, int, int], embed_dim: int
                              ) -> torch.Tensor:
    """Sinusoidal features [N, embed_dim] of each voxel's offset inside its
    unshifted window (``part`` is not read): per axis ``embed_dim // 6``
    sines then as many cosines, zero-padded to ``embed_dim``."""
    dev = coords.device
    ws = torch.tensor(window_shape, dtype=torch.float32, device=dev)
    local = (coords.to(torch.int32)
             % torch.tensor(window_shape, dtype=torch.int32, device=dev)).float()
    local = local / ws - 0.5
    half = embed_dim // 6 * 2
    step = -torch.log(torch.tensor(10000.0, device=dev)) / max(half // 2 - 1, 1)
    freqs = torch.exp(torch.arange(half // 2, dtype=torch.float32, device=dev) * step)
    outs = []
    for a in range(3):
        ang = local[:, a:a + 1] * freqs[None, :] * 2 * math.pi
        outs += [torch.sin(ang), torch.cos(ang)]
    pe = torch.cat(outs, dim=1)
    pad = embed_dim - pe.shape[1]
    if pad > 0:
        pe = torch.cat([pe, pe.new_zeros(pe.shape[0], pad)], dim=1)
    return pe[:, :embed_dim]
