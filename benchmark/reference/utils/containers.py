"""Batch containers: fixed-capacity point and ground-truth sets with
validity masks, and the camera branch's 2D instance data (the JAX package's
``utils/containers.py`` and ``models/camera.py`` layouts).

Frozen copy for the benchmark's reference, without the program's pytree
registration (that is the program's, under the same serialized names).
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
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


@dataclass
class CameraData:
    """Pre-computed 2D instance data.

    masks: [B·cams·H·W, cls] int32, packed ``id | score_u8 << 8`` (id = anno
    row + 1, 0 = background), flat and channel-last; anno: [B, A, 9] f32
    ([x1, y1, x2, y2, score, category, cam_id, obj_id, valid]); lidar2img:
    [B, cams, 4, 4] f32; img_h/img_w: the mask planes' size (required).
    """

    masks: torch.Tensor
    anno: torch.Tensor
    lidar2img: torch.Tensor
    img_h: int
    img_w: int

    @classmethod
    def build(cls, masks_planes, anno, lidar2img, device="cuda") -> "CameraData":
        """From [B, cams, H, W, cls] packed uint16 planes (NumPy)."""
        planes = np.asarray(masks_planes)
        b, cams, h, w, ncls = planes.shape
        return cls(
            masks=torch.as_tensor(planes.reshape(-1, ncls).astype(np.int32), device=device),
            anno=torch.as_tensor(np.asarray(anno, np.float32), device=device),
            lidar2img=torch.as_tensor(np.asarray(lidar2img, np.float32), device=device),
            img_h=int(h), img_w=int(w),
        )

    @property
    def max_anno(self) -> int:
        return self.anno.shape[1]

