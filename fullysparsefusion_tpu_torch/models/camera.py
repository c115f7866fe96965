"""Camera-query (frustum) branch (port of ``models/camera.py``).

2D instance masks group LiDAR points into per-instance frustums; each
instance becomes a camera query pooled by its own SIR. The per-point mask
lookup keeps the ≤ 2 cameras a point projects into; each point spawns
``overlap_k`` copies carrying its largest instance ids, compacted to a fixed
capacity and grouped by (batch, instance id).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.projection import points_in_mask_compact
from ..ops.segment import SegmentInfo, unique_segments
from ..utils.containers import CameraData  # noqa: F401 (re-exported)
from ..utils.gather import masked_gather
from .layers import MLP
from .sir import SIR


class FrustumSelection(NamedTuple):
    point_idx: torch.Tensor   # [F] row into the point set
    obj_id: torch.Tensor      # [F] instance id (≥ 1 where valid)
    batch_idx: torch.Tensor   # [F]
    valid: torch.Tensor       # [F]


def gather_point_instances(xyz_noaug, batch_idx, valid, cam: CameraData):
    """([N, 2, cls] instance ids, [N, 2, cls] 2D scores), 0 outside masks
    and for invalid points."""
    ids, scores = points_in_mask_compact(
        xyz_noaug, batch_idx, cam.lidar2img, cam.masks, cam.img_h, cam.img_w)
    keep = valid[:, None, None]
    return ids * keep, scores * keep


def _topk_desc(x: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k values of each row, descending (values only)."""
    return torch.sort(x, dim=1, descending=True, stable=True).values[:, :k]


def select_frustum_points(obj_ids, batch_idx, overlap_k: int, capacity: int) -> FrustumSelection:
    """Top-K overlap expansion + compaction."""
    n = obj_ids.shape[0]
    topk = _topk_desc(obj_ids.reshape(n, -1), overlap_k)   # [N, K] ids desc
    sel, sel_valid = masked_gather((topk > 0).reshape(-1), capacity)
    point_idx = torch.div(sel, overlap_k, rounding_mode="floor")
    obj_id = topk.reshape(-1)[sel.long()]
    return FrustumSelection(
        point_idx=point_idx.to(torch.int32),
        obj_id=torch.where(sel_valid, obj_id, torch.zeros_like(obj_id)),
        batch_idx=batch_idx[point_idx.long()],
        valid=sel_valid,
    )


def frustum_segments(sel: FrustumSelection, max_anno: int, capacity: int
                     ) -> Tuple[SegmentInfo, torch.Tensor, torch.Tensor]:
    """Group copies by (batch, instance) → (seg, obj_batch, obj_anno_row)."""
    key = sel.batch_idx * (max_anno + 1) + sel.obj_id
    seg = unique_segments(key, sel.valid, capacity)
    safe = torch.where(seg.seg_valid, seg.unique_keys, torch.zeros_like(seg.unique_keys))
    obj_batch = safe // (max_anno + 1)
    obj_row = safe % (max_anno + 1) - 1
    return seg, obj_batch.to(torch.int32), obj_row.to(torch.int32)


def weighted_cluster_centers(xyz, w, seg: SegmentInfo):
    """Foreground-probability-weighted per-instance centers; the weights
    carry no gradient."""
    w = w.detach().clamp(min=1e-5)[:, None]
    sw = seg.sum(torch.cat([xyz * w, w], dim=1))
    return sw[:, :3] / sw[:, 3:4].clamp(min=1e-6)


def encode_preds_2d(preds_2d, img_w: int, img_h: int, num_classes: int):
    """[K, 9] anno rows → [K, 4 + 1 + (C+1)] features."""
    scale = torch.tensor([img_w, img_h, img_w, img_h], dtype=preds_2d.dtype, device=preds_2d.device)
    category = preds_2d[:, 5].to(torch.int32).clamp(0, num_classes)
    onehot = F.one_hot(category.long(), num_classes + 1).to(preds_2d.dtype)
    return torch.cat([preds_2d[:, :4] / scale, preds_2d[:, 4:5], onehot], dim=1)


def object_preds_2d(cam: CameraData, obj_batch, obj_row, num_classes: int):
    """Per-object anno rows; rows without an instance get category = bg."""
    b, a, d = cam.anno.shape
    flat = cam.anno.reshape(b * a, d)
    ok = obj_row >= 0
    idx = (obj_batch * a + obj_row.clamp(min=0)).clamp(0, b * a - 1)
    rows = torch.where(ok[:, None], flat[idx.long()], torch.zeros_like(flat[:1]))
    rows[:, 5] = torch.where(ok, rows[:, 5], torch.full_like(rows[:, 5], float(num_classes)))
    return rows


def per_point_class_scores(obj_ids, obj_scores):
    """Per-class 2D scores of the camera slot with the most mask hits → [N, cls]."""
    hits = (obj_ids > 0).sum(-1)                              # [N, cams]
    best = torch.argmax(hits, dim=1)                          # first max
    per_cls = obj_ids[torch.arange(obj_ids.shape[0], device=obj_ids.device), best]
    scores = obj_scores[torch.arange(obj_ids.shape[0], device=obj_ids.device), best]
    return torch.where(per_cls > 0, scores, torch.zeros_like(scores))


class FrustumBranch(nn.Module):
    """Frustum SIR + 2D-pred encoder → camera-query features."""

    def __init__(self, point_dim: int, feat_dim: int, sir_num_blocks=3,
                 sir_feat_channels=((128, 128),) * 3, sir_rel_mlp_hidden=((16, 32),) * 3,
                 sir_xyz_normalizer=(20.0, 20.0, 4.0), encode_2d_dims=(128, 128),
                 num_classes=10, overlap_k=3, frustum_points=8192, frustum_objects=256):
        super().__init__()
        self.num_classes = num_classes
        self.overlap_k = overlap_k
        self.frustum_points = frustum_points
        self.frustum_objects = frustum_objects
        self.SIR_0 = SIR(point_dim, feat_dim, sir_num_blocks, sir_feat_channels,
                         sir_rel_mlp_hidden, sir_xyz_normalizer)
        self.MLP_0 = MLP(4 + 1 + num_classes + 1, tuple(encode_2d_dims), norm="ln", act="gelu")
        self.out_dim = self.SIR_0.out_dim + encode_2d_dims[-1]

    def forward(self, points, seg_feats, seg_logits, obj_ids, batch_idx, cam: CameraData):
        sel = select_frustum_points(obj_ids, batch_idx, self.overlap_k, self.frustum_points)
        seg, obj_batch, obj_row = frustum_segments(sel, cam.max_anno, self.frustum_objects)
        f_valid = sel.valid & (seg.seg_id < self.frustum_objects)
        pidx = sel.point_idx.long()
        pts = points[pidx]
        feats = seg_feats[pidx]
        fg_w = 1.0 - torch.softmax(seg_logits, dim=1)[:, -1]
        w = fg_w[pidx] * f_valid
        centers = weighted_cluster_centers(pts[:, :3], w, seg)
        sid = seg.seg_id.clamp(0, self.frustum_objects - 1).long()
        f_cluster = pts[:, :3] - centers[sid]
        _, cluster_feats = self.SIR_0(pts, feats, f_cluster, seg, f_valid)
        preds_2d = object_preds_2d(cam, obj_batch, obj_row, self.num_classes)
        enc = encode_preds_2d(preds_2d, cam.img_w, cam.img_h, self.num_classes)
        img_feat = self.MLP_0(enc, seg.seg_valid)
        return dict(
            obj_feat=torch.cat([cluster_feats, img_feat], dim=1),
            obj_centers=centers,
            obj_batch=obj_batch,
            obj_valid=seg.seg_valid,
            obj_row=obj_row,
            preds_2d=preds_2d,
        )
