"""LiDAR → image projection and the instance-mask lookups (port of
``ops/projection.py``: ``project_points_2d``, ``points_in_mask`` and
``points_in_mask_compact``)."""
from __future__ import annotations

from typing import Tuple

import torch


def project_points_2d(xyz: torch.Tensor, lidar2img: torch.Tensor, img_h: int, img_w: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalized [0, 1) image coords per camera: (uv [cams, N, 2], valid
    [cams, N]); valid needs depth > 1e-3 and the point inside the image."""
    pts4 = torch.cat([xyz, torch.ones_like(xyz[:, :1])], dim=1)
    proj = torch.einsum("nd,ckd->cnk", pts4, lidar2img)
    depth = proj[..., 2]
    z = depth.clamp(1e-5, 1e5)
    u = proj[..., 0] / z / img_w
    v = proj[..., 1] / z / img_h
    valid = (depth > 1e-3) & (u > 0.0) & (u < 1.0) & (v > 0.0) & (v < 1.0)
    return torch.stack([u, v], dim=-1), valid


def points_in_mask(
    xyz: torch.Tensor,         # [N, 3]
    batch_idx: torch.Tensor,   # [N]
    lidar2img: torch.Tensor,   # [B, num_cams, 4, 4]
    masks: torch.Tensor,       # [B, num_cams, H, W, num_cls] int32 packed
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-point instance ids and 2D scores from every camera: ([N, cams,
    cls] i32 ids, [N, cams, cls] f32 scores; id 0 = no instance). Each point
    is projected through its own sample's matrices; pixel values are ``id |
    score_u8 << 8``; nearest-pixel lookup (floor of the projected
    coordinate), 0 where the depth is ≤ 1e-3 or the pixel is off the
    image."""
    _, num_cams, img_h, img_w, num_cls = masks.shape
    pts4 = torch.cat([xyz, torch.ones_like(xyz[:, :1])], dim=1)
    proj = torch.einsum("nd,nckd->nck", pts4, lidar2img[batch_idx.long()])  # [N, C, 4]
    depth = proj[..., 2]
    z = depth.clamp(1e-5, 1e5)
    px = torch.floor(proj[..., 0] / z).to(torch.int32)
    py = torch.floor(proj[..., 1] / z).to(torch.int32)
    valid = (depth > 1e-3) & (px >= 0) & (px < img_w) & (py >= 0) & (py < img_h)
    px = px.clamp(0, img_w - 1)
    py = py.clamp(0, img_h - 1)
    base = batch_idx[:, None].long() * num_cams + torch.arange(num_cams, device=xyz.device)
    idx = (base * img_h + py) * img_w + px                                  # [N, C]
    val = masks.reshape(-1, num_cls)[idx]                                   # [N, C, cls]
    val = torch.where(valid[:, :, None], val, torch.zeros_like(val))
    return (val & 0xFF).to(torch.int32), (val >> 8).float() * (1.0 / 255.0)


def points_in_mask_compact(
    xyz: torch.Tensor,         # [N, 3]
    batch_idx: torch.Tensor,   # [N]
    lidar2img: torch.Tensor,   # [B, num_cams, 4, 4]
    masks_flat: torch.Tensor,  # [B·num_cams·H·W, num_cls] int32 packed
    img_h: int,
    img_w: int,
    k: int = 2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-point instance ids and 2D scores from the ≤ ``k`` lowest-index
    cameras each point projects into: ([N, k, cls] i32 ids, [N, k, cls] f32
    scores). Pixel values are ``id | score_u8 << 8`` (0 = background);
    nearest-pixel lookup (floor of the projected coordinate)."""
    b, num_cams = lidar2img.shape[:2]
    bc = b * num_cams
    n = xyz.shape[0]
    pts4 = torch.cat([xyz, torch.ones(n, 1, dtype=xyz.dtype, device=xyz.device)], dim=1)
    m_rows = lidar2img.reshape(bc, 4, 4)
    proj_u = pts4 @ m_rows[:, 0, :].T               # [N, BC] (u·z)
    proj_v = pts4 @ m_rows[:, 1, :].T
    depth = pts4 @ m_rows[:, 2, :].T
    z = depth.clamp(1e-5, 1e5)
    px = torch.floor(proj_u / z).to(torch.int32)
    py = torch.floor(proj_v / z).to(torch.int32)
    col = torch.arange(bc, dtype=torch.int32, device=xyz.device).expand(n, bc)
    own = (col // num_cams) == batch_idx[:, None]
    valid = own & (depth > 1e-3) & (px >= 0) & (px < img_w) & (py >= 0) & (py < img_h)
    px = px.clamp(0, img_w - 1)
    py = py.clamp(0, img_h - 1)
    idx = (col * img_h + py) * img_w + px           # [N, BC] flat pixel

    # the k lowest-index valid cameras, in camera order
    score = torch.where(valid, bc - col, torch.zeros_like(col))
    top = torch.topk(score, k, dim=1).values        # distinct positive values or 0
    ok_k = top > 0
    sel = (bc - top).clamp(0, bc - 1).long()
    idx_k = torch.gather(idx, 1, sel)
    idx_k = torch.where(ok_k, idx_k, torch.zeros_like(idx_k))
    val = masks_flat[idx_k.long()]                  # [N, k, cls]
    val = torch.where(ok_k[:, :, None], val, torch.zeros_like(val))
    ids = val & 0xFF
    scores = (val >> 8).float() * (1.0 / 255.0)
    return ids.to(torch.int32), scores
