"""Box ↔ regression-target coder (port of ``core/coders.py``, decode)."""
from __future__ import annotations

from dataclasses import dataclass

import torch

EPS = 1e-6


@dataclass(frozen=True)
class BasePointBBoxCoder:
    code_size: int = 10

    def decode(self, reg_preds: torch.Tensor, base_points: torch.Tensor) -> torch.Tensor:
        """[N, code_size] predictions + [N, 3] base points → [N, 7|9] boxes:
        [Δxyz, log dims, sin yaw, cos yaw, (vx, vy)] → [xyz, dims, yaw, (v)]."""
        if reg_preds.shape[1] != self.code_size:
            raise ValueError(f"expected code size {self.code_size}, got {reg_preds.shape[1]}")
        parts = [
            reg_preds[:, :3] + base_points,
            torch.exp(reg_preds[:, 3:6]) - EPS,
            torch.atan2(reg_preds[:, 6:7], reg_preds[:, 7:8]),
        ]
        if self.code_size == 10:
            parts.append(reg_preds[:, 8:10])
        return torch.cat(parts, dim=1)
