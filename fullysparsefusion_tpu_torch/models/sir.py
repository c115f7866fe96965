"""SIR backbone (port of ``models/sir.py``): stacked SIRLayer blocks; the
cluster feature is the concat of every block's group features."""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from ..ops.segment import SegmentInfo
from .vfe import SIRLayer


class SIR(nn.Module):
    def __init__(self, point_dim: int, feat_dim: int, num_blocks: int = 3,
                 feat_channels: Sequence[Sequence[int]] = ((128, 128),) * 3,
                 rel_mlp_hidden_dims: Sequence[Sequence[int]] = ((16, 32),) * 3,
                 xyz_normalizer: Tuple[float, float, float] = (20.0, 20.0, 4.0)):
        super().__init__()
        self.num_blocks = num_blocks
        self.xyz_normalizer = tuple(xyz_normalizer)
        d = feat_dim
        for i in range(num_blocks):
            layer = SIRLayer(point_dim + d, 3, feat_channels[i], rel_mlp_hidden_dims[i])
            setattr(self, f"SIRLayer_{i}", layer)
            d = layer.out_point_dim
        self.out_dim = sum(sum(c) for c in feat_channels[:num_blocks])

    def forward(self, points, features, f_cluster, seg: SegmentInfo, valid):
        norm = torch.tensor(self.xyz_normalizer, dtype=points.dtype, device=points.device)
        pts = torch.cat([points[:, :3] / norm, points[:, 3:]], dim=1)
        out_feats = features
        clusters = []
        for i in range(self.num_blocks):
            out_feats, c = getattr(self, f"SIRLayer_{i}")(
                torch.cat([pts, out_feats], dim=1), f_cluster, seg.seg_id, seg.capacity, valid)
            clusters.append(c)
        return out_feats, torch.cat(clusters, dim=1)
