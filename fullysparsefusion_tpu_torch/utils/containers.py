"""Batch containers: fixed-capacity point and ground-truth sets with
validity masks (the JAX package's ``utils/containers.py`` layouts)."""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch


@dataclass
class PointBatch:
    """Concatenated multi-sample point cloud with validity mask.

    points: [N, D] f32 — xyz first; extra channels (intensity, Δt, no-aug
    xyz) follow.
    """

    points: torch.Tensor     # [N, D] f32
    batch_idx: torch.Tensor  # [N] i32
    valid: torch.Tensor      # [N] bool

    @property
    def xyz(self) -> torch.Tensor:
        return self.points[:, :3]

    def replace(self, **kw) -> "PointBatch":
        return replace(self, **kw)


@dataclass
class GroundTruth:
    """Padded GT boxes: boxes [B, M, 10] (x, y, z_bottom, dx, dy, dz, yaw,
    vx, vy, vel_flag), labels [B, M] i32, valid [B, M] bool."""

    boxes: torch.Tensor
    labels: torch.Tensor
    valid: torch.Tensor
