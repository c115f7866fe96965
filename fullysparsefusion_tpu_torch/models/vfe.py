"""Segment VFE family (port of ``models/vfe.py``): per-point Linear → Norm
→ Act layers with a segment reduce and concat-back between them."""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.segment import SegmentInfo, segment_max
from .layers import MLP, Norm, get_activation

# SIR divides the relative-position features by this before its position MLP
REL_DIST_SCALER = 10.0


def _back(seg_id: torch.Tensor, capacity: int) -> torch.Tensor:
    return seg_id.clamp(0, capacity - 1).long()


class DynamicVFELayer(nn.Module):
    """Linear → Norm → Act (one VFE layer)."""

    def __init__(self, in_dim: int, out_channels: int, norm="bn", act="relu"):
        super().__init__()
        self.Dense_0 = nn.Linear(in_dim, out_channels, bias=False)
        self.Norm_0 = Norm(norm, out_channels)
        self.act = get_activation(act)

    def forward(self, x, valid):
        return self.act(self.Norm_0(self.Dense_0(x), valid))


class DynamicScatterVFE(nn.Module):
    """Voxel feature encoder: point features + cluster-center and
    voxel-center offsets, VFE layers with max-reduce and concat-back; the
    last reduce gives the voxel features."""

    def __init__(self, point_dim: int, feat_channels: Sequence[int] = (64, 64),
                 voxel_size=(0.2, 0.2, 0.2), pc_range_min=(-51.2, -51.2, -5.0)):
        super().__init__()
        self.voxel_size = tuple(voxel_size)
        self.pc_range_min = tuple(pc_range_min)
        self.n_layers = len(feat_channels)
        d = point_dim + 6
        for i, c in enumerate(feat_channels):
            setattr(self, f"DynamicVFELayer_{i}", DynamicVFELayer(d, c))
            d = 2 * c

    def forward(self, points, seg: SegmentInfo, voxel_coords, valid):
        xyz = points[:, :3]
        back = _back(seg.seg_id, seg.capacity)
        mean_xyz = seg.mean(xyz)
        vs = torch.tensor(self.voxel_size, dtype=xyz.dtype, device=xyz.device)
        lo = torch.tensor(self.pc_range_min, dtype=xyz.dtype, device=xyz.device)
        centers = voxel_coords.to(xyz.dtype) * vs + vs * 0.5 + lo
        vmask = valid[:, None].to(xyz.dtype)
        x = torch.cat([points, xyz - mean_xyz[back], xyz - centers[back]], dim=1) * vmask
        voxel_feats = None
        for i in range(self.n_layers):
            x = getattr(self, f"DynamicVFELayer_{i}")(x, valid) * vmask
            voxel_feats = segment_max(x, seg.seg_id, seg.capacity)
            if i != self.n_layers - 1:
                x = torch.cat([x, voxel_feats[back]], dim=1) * vmask
        return voxel_feats


class SIRLayer(nn.Module):
    """One SIR block: rel-pos-modulated PointNet over segments (``seg_id``
    [N] i32 in ``[0, capacity]``, ``capacity`` the trash). Returns (point
    feats [N, c_last], group feats [capacity, Σc])."""

    def __init__(self, in_dim: int, rel_dim: int, feat_channels: Sequence[int] = (128, 128),
                 rel_mlp_hidden_dims: Sequence[int] = (16, 32)):
        super().__init__()
        self.MLP_0 = MLP(rel_dim, tuple(rel_mlp_hidden_dims) + (in_dim,), norm="none",
                         act="gelu", bias=True)
        self.n_layers = len(feat_channels)
        d = in_dim
        for i, c in enumerate(feat_channels):
            setattr(self, f"DynamicVFELayer_{i}",
                    DynamicVFELayer(d, c, norm="ln", act="gelu"))
            d = 2 * c
        self.out_point_dim = feat_channels[-1]
        self.out_group_dim = sum(feat_channels)

    def forward(self, in_feats, rel_feats, seg_id, capacity: int, valid):
        vmask = valid[:, None].to(in_feats.dtype)
        pe = self.MLP_0(rel_feats / REL_DIST_SCALER, valid)
        x = in_feats * pe * vmask
        back = _back(seg_id, capacity)
        groups = []
        for i in range(self.n_layers):
            x = getattr(self, f"DynamicVFELayer_{i}")(x, valid) * vmask
            g = segment_max(x, seg_id, capacity)
            groups.append(g)
            if i != self.n_layers - 1:
                x = torch.cat([x, g[back]], dim=1) * vmask
        return x, torch.cat(groups, dim=1)
