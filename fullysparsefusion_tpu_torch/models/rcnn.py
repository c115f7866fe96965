"""Two-stage RCNN refinement head, the FSD second stage (port of
``models/rcnn.py``).

First-stage proposals (RoIs) are assigned to GT by 3D IoU; each RoI's
member points are pooled with canonical-frame geometry
(:func:`.roi.extract_roi_points`), a SIR stack makes per-RoI features, and
class and box-residual MLPs refine each proposal. The decode is one
multiclass rotated NMS over every RoI (one K3 launch).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import Capacities, HeadConfig
from ..core import losses as L
from ..core.coders import BasePointBBoxCoder
from ..ops.geometry import boxes_iou_3d
from ..ops.nms import NMSResult, multiclass_nms_bev_batched
from ..utils.containers import GroundTruth
from .layers import MLP, mesh_mean
from .roi import FullySparseBboxHead, extract_roi_points


def assign_rois_by_iou(rois, roi_batch, roi_valid, gt: GroundTruth, pos_iou_thr: float = 0.55
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The best-3D-IoU GT of each proposal among its sample's valid GT
    (first on ties). Returns (flat GT index [Q], -1 below ``pos_iou_thr``;
    best IoU [Q], -1 where the proposal has no candidate)."""
    b, m, _ = gt.boxes.shape
    flat = gt.boxes.reshape(b * m, -1)
    labels = gt.labels.reshape(b * m)
    gvalid = gt.valid.reshape(b * m) & (labels >= 0)
    gbatch = torch.arange(b, dtype=torch.int32, device=rois.device).repeat_interleave(m)
    iou = boxes_iou_3d(rois[:, :7], flat[:, :7])
    mask = roi_valid[:, None] & gvalid[None, :] & (roi_batch[:, None] == gbatch[None, :])
    iou = torch.where(mask, iou, torch.full_like(iou, -1.0))
    best_iou, best = iou.max(dim=1)
    assigned = torch.where(best_iou >= pos_iou_thr, best, torch.full_like(best, -1))
    return assigned.to(torch.int32), best_iou


class GroupCorrectionHead(nn.Module):
    """RoI pooling + SIR (``FullySparseBboxHead_0``) + per-RoI class
    (``MLP_0``) and box-residual (``MLP_1``) heads, under flax's names."""

    def __init__(self, cfg: HeadConfig, caps: Capacities, point_dim: int, feat_dim: int,
                 extra_wlh: Tuple[float, float, float] = (0.5, 0.5, 0.5),
                 reg_mlp: Sequence[int] = (512, 512), cls_mlp: Sequence[int] = (512, 512),
                 sir_feat_channels: Sequence[Sequence[int]] = ((128, 128),) * 3,
                 sir_rel_mlp_hidden: Sequence[Sequence[int]] = ((16, 32),) * 3):
        super().__init__()
        self.caps = caps
        self.extra_wlh = tuple(extra_wlh)
        self.FullySparseBboxHead_0 = FullySparseBboxHead(
            point_dim, feat_dim, num_blocks=len(sir_feat_channels),
            feat_channels=sir_feat_channels, rel_mlp_hidden=sir_rel_mlp_hidden)
        d = self.FullySparseBboxHead_0.out_dim
        self.MLP_0 = MLP(d, tuple(cls_mlp) + (cfg.num_classes,), norm=cfg.norm, act=cfg.act,
                         is_head=True)
        self.MLP_1 = MLP(d, tuple(reg_mlp) + (cfg.code_size,), norm=cfg.norm, act=cfg.act,
                         is_head=True)

    def forward(self, points, point_feats, point_batch, point_valid, rois, roi_batch,
                roi_valid) -> Dict[str, torch.Tensor]:
        """``cls_logits`` [Q, C], ``reg_preds`` [Q, code], ``nonempty`` [Q]
        (a valid RoI with pooled points), and the pooling's valid pairs
        (``num_roi_points``) and ``dropped`` memberships."""
        rp = extract_roi_points(points[:, :3], point_batch, point_valid, rois[:, :7], roi_batch,
                                roi_valid, self.extra_wlh, self.caps.roi_points)
        idx = rp.point_idx.long()
        roi_feats, nonempty = self.FullySparseBboxHead_0(
            points[idx], point_feats[idx], rp.geometry, rp.roi_idx, rp.valid, rois.shape[0])
        return dict(
            cls_logits=self.MLP_0(roi_feats, roi_valid),
            reg_preds=self.MLP_1(roi_feats, roi_valid),
            nonempty=nonempty & roi_valid,
            num_roi_points=rp.valid.sum(dtype=torch.int32),
            dropped=rp.dropped,
        )


def rcnn_loss(outs, rois, roi_batch, roi_valid, gt: GroundTruth, cfg: HeadConfig,
              pos_iou_thr: float = 0.55, prefix: str = "rcnn_") -> Dict[str, torch.Tensor]:
    """Focal class loss over the valid RoIs and L1 box residuals over the
    positive ones, targets encoded against the proposal centers; both
    normalisers ``mesh_mean``'d over the ranks of a data-parallel step."""
    coder = BasePointBBoxCoder(cfg.code_size)
    b, m, _ = gt.boxes.shape
    flat = gt.boxes.reshape(b * m, -1)
    labels = gt.labels.reshape(b * m)
    assigned, _ = assign_rois_by_iou(rois, roi_batch, roi_valid, gt, pos_iou_thr)
    pos = assigned >= 0
    safe = assigned.clamp(min=0).long()
    cls_target = torch.where(pos, labels[safe], torch.full_like(labels[safe], cfg.num_classes))
    # class num_classes (background) is the all-zero row
    onehot = F.one_hot(cls_target.long(), cfg.num_classes + 1)[:, :cfg.num_classes].float()
    focal = L.sigmoid_focal_loss(outs["cls_logits"], onehot, cfg.focal_gamma, cfg.focal_alpha)
    w = roi_valid.float()
    cls_avg = mesh_mean(w.sum())
    loss_cls = cfg.loss_cls_weight * (focal * w[:, None]).sum() / cls_avg.clamp(min=1.0)
    targets = coder.encode(flat[safe], rois[:, :3])
    pw = pos.float()
    num_pos = mesh_mean(pw.sum())
    diff = (outs["reg_preds"] - targets).abs() * pw[:, None]
    loss_reg = diff[:, :min(8, cfg.code_size)].sum() / num_pos.clamp(min=1.0)
    return {prefix + "loss_cls": loss_cls, prefix + "loss_reg": loss_reg,
            prefix + "num_pos": num_pos}


def rcnn_get_bboxes(outs, rois, roi_batch, batch_size: int, cfg: HeadConfig) -> NMSResult:
    """Refined boxes decoded against the proposal centers, scored by the
    sigmoid of the class logits, then one multiclass rotated NMS over the
    non-empty RoIs: [B, max_num] leaves."""
    coder = BasePointBBoxCoder(cfg.code_size)
    boxes = coder.decode(outs["reg_preds"], rois[:, :3])
    return multiclass_nms_bev_batched(boxes, torch.sigmoid(outs["cls_logits"]), outs["nonempty"],
                                      roi_batch, batch_size, cfg.nms_thr, cfg.score_thr,
                                      cfg.max_num)
