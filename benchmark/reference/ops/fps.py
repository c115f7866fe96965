"""Furthest point sampling and ball grouping (port of ``ops/fps.py``): the
SSG clustering that ``models/fsd.hybrid_cluster_one_group`` offers beside
CCL (no shipped config runs it)."""
from __future__ import annotations

from typing import Tuple

import torch


def furthest_point_sample(xyz: torch.Tensor, valid: torch.Tensor, k: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indices [k] i32 of ``k`` furthest-point picks, the first valid point
    first, and their validity [k]: each next pick is the arg-max (first on
    ties) of the squared distance to the picks so far, invalid points held
    at -1 so that they are never picked while a valid one is left. Past the
    number of valid points the picks repeat and are marked invalid. A loop
    of ``k - 1`` small steps."""
    d_valid = torch.full_like(xyz[:, 0], -1.0)
    dists = torch.where(valid, torch.full_like(d_valid, 1e10), d_valid)
    last = torch.argmax(valid.to(torch.int32))
    picks = [last]
    for _ in range(k - 1):
        d = ((xyz - xyz[last]) ** 2).sum(dim=-1)
        dists = torch.minimum(dists, torch.where(valid, d, d_valid))
        last = torch.argmax(dists)
        picks.append(last)
    sel_valid = torch.arange(k, device=xyz.device) < valid.sum()
    return torch.stack(picks).to(torch.int32), sel_valid


def ball_group(xyz: torch.Tensor, valid: torch.Tensor, centers: torch.Tensor,
               centers_valid: torch.Tensor, radius: float) -> torch.Tensor:
    """Each valid point's nearest valid center (BEV distance, the first on
    ties) if it is closer than ``radius``, else -1 → [N] i32."""
    d = torch.linalg.norm(xyz[:, None, :2] - centers[None, :, :2], dim=-1)
    d = torch.where(centers_valid[None, :], d, torch.full_like(d, float("inf")))
    best_d, best = d.min(dim=1)
    ok = valid & (best_d < radius)
    return torch.where(ok, best, torch.full_like(best, -1)).to(torch.int32)


def ssg_cluster(xyz: torch.Tensor, valid: torch.Tensor, num_fps: int, radius: float
                ) -> torch.Tensor:
    """FPS + ball grouping labels [N] in [0, num_fps) or -1, over the points
    of one sample (``valid`` selects them)."""
    picks, sel_valid = furthest_point_sample(xyz, valid, num_fps)
    return ball_group(xyz, valid, xyz[picks.long()], sel_valid, radius)
