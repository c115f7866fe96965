"""Box ↔ regression-target coders (port of ``core/coders.py``): targets are
[Δxyz, log(dims + eps), sin yaw, cos yaw, (vx, vy)] relative to a base
point; code size 10 with velocity (nuScenes), 8 without (AV2).
``ABSPointBBoxCoder`` encodes normalised absolute centers instead."""
from __future__ import annotations

from dataclasses import dataclass

import torch

EPS = 1e-6


@dataclass(frozen=True)
class BasePointBBoxCoder:
    code_size: int = 10

    def encode(self, bboxes: torch.Tensor, base_points: torch.Tensor) -> torch.Tensor:
        """[N, 7|9|10] boxes + [N, 3] base points → [N, code_size] targets."""
        yaw = bboxes[:, 6:7]
        parts = [bboxes[:, :3] - base_points, torch.log(bboxes[:, 3:6] + EPS),
                 torch.sin(yaw), torch.cos(yaw)]
        if self.code_size == 10:
            parts.append(bboxes[:, 7:9])
        return torch.cat(parts, dim=1)

    def decode(self, reg_preds: torch.Tensor, base_points: torch.Tensor,
               detach_yaw: bool = False) -> torch.Tensor:
        """[N, code_size] predictions + [N, 3] base points → [N, 7|9] boxes
        [xyz, dims, yaw, (v)]; ``detach_yaw`` stops the yaw's gradient."""
        if reg_preds.shape[1] != self.code_size:
            raise ValueError(f"expected code size {self.code_size}, got {reg_preds.shape[1]}")
        yaw = torch.atan2(reg_preds[:, 6:7], reg_preds[:, 7:8])
        parts = [
            reg_preds[:, :3] + base_points,
            torch.exp(reg_preds[:, 3:6]) - EPS,
            yaw.detach() if detach_yaw else yaw,
        ]
        if self.code_size == 10:
            parts.append(reg_preds[:, 8:10])
        return torch.cat(parts, dim=1)


@dataclass(frozen=True)
class ABSPointBBoxCoder:
    """Absolute-coordinate variant: centers encoded as absolute positions
    over (``xy_normalizer``, ``xy_normalizer``, ``z_normalizer``); the base
    points are ignored. No shipped config uses it."""

    code_size: int = 10
    xy_normalizer: float = 51.2
    z_normalizer: float = 5.0

    def _norm(self, like: torch.Tensor) -> torch.Tensor:
        return torch.tensor([self.xy_normalizer, self.xy_normalizer, self.z_normalizer],
                            dtype=like.dtype, device=like.device)

    def encode(self, bboxes: torch.Tensor, base_points: torch.Tensor) -> torch.Tensor:
        yaw = bboxes[:, 6:7]
        parts = [bboxes[:, :3] / self._norm(bboxes), torch.log(bboxes[:, 3:6] + EPS),
                 torch.sin(yaw), torch.cos(yaw)]
        if self.code_size == 10:
            parts.append(bboxes[:, 7:9])
        return torch.cat(parts, dim=1)

    def decode(self, reg_preds: torch.Tensor, base_points: torch.Tensor,
               detach_yaw: bool = False) -> torch.Tensor:
        yaw = torch.atan2(reg_preds[:, 6:7], reg_preds[:, 7:8])
        parts = [reg_preds[:, :3] * self._norm(reg_preds), torch.exp(reg_preds[:, 3:6]) - EPS,
                 yaw.detach() if detach_yaw else yaw]
        if self.code_size == 10:
            parts.append(reg_preds[:, 8:10])
        return torch.cat(parts, dim=1)
