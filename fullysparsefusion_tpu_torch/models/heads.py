"""Sparse cluster detection heads (port of ``models/heads.py``): a shared
MLP, one small MLP per regression attribute plus the score branch; the
single-task loss (focal classification over valid clusters, L1 on the
coder's targets for positives, the optional corner loss, and the
``assign_recall`` / ``num_pos`` diagnostics); decode + per-sample
multiclass rotated NMS. Under ``layers.bn_group`` the loss normalizers and
the diagnostics' counts are means over the ranks (``layers.mesh_mean``)."""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import HeadConfig
from ..core import losses as L
from ..core.coders import BasePointBBoxCoder
from ..ops.geometry import corners_3d, points_box_assignment_batched
from ..ops.nms import NMSResult, multiclass_nms_bev_batched
from ..utils.containers import GroundTruth
from .layers import MLP, mesh_mean


class SeparateHead(nn.Module):
    """One MLP per attribute: ``num_layers`` hidden Linear+Norm+Act, then a
    biased head Linear."""

    def __init__(self, in_dim: int, attrs: Tuple[Tuple[str, int, int, int], ...],
                 norm="ln", act="gelu"):
        super().__init__()
        self.names = [a[0] for a in attrs]
        for i, (_, out_dim, num_layers, hidden) in enumerate(attrs):
            setattr(self, f"MLP_{i}", MLP(in_dim, tuple([hidden] * num_layers + [out_dim]),
                                          norm=norm, act=act, is_head=True))

    def forward(self, x, valid=None):
        return {name: getattr(self, f"MLP_{i}")(x, valid) for i, name in enumerate(self.names)}


class SparseClusterHead(nn.Module):
    """Single-task cluster head (the shipped FSF configs run one task of all
    classes): returns cls_logits [C, num_classes] and reg_preds [C, code]."""

    def __init__(self, cfg: HeadConfig, num_classes: int):
        super().__init__()
        if cfg.with_iou:
            raise NotImplementedError("the IoU branch is not ported")
        self.MLP_0 = MLP(cfg.in_channel, tuple(cfg.shared_mlp_dims), norm=cfg.norm, act=cfg.act)
        attrs = tuple(cfg.common_attrs) + (
            ("score", num_classes, cfg.num_cls_layer, cfg.cls_hidden_dim),)
        self.SeparateHead_0 = SeparateHead(cfg.shared_mlp_dims[-1], attrs, cfg.norm, cfg.act)

    def forward(self, cluster_feats, valid):
        ret = self.SeparateHead_0(self.MLP_0(cluster_feats, valid), valid)
        reg = torch.cat([ret[k] for k in ("center", "dim", "rot", "vel") if k in ret], dim=-1)
        return dict(cls_logits=ret["score"], reg_preds=reg)


def assign_clusters_in_box(cluster_xyz, cluster_batch, cluster_valid, gt: GroundTruth
                           ) -> torch.Tensor:
    """Cluster center inside a GT box of its sample → that flat GT index, else -1."""
    b, m, _ = gt.boxes.shape
    flat_valid = gt.valid.reshape(b * m) & (gt.labels.reshape(b * m) >= 0)
    box_batch = torch.arange(b, dtype=torch.int32, device=gt.boxes.device).repeat_interleave(m)
    assign = points_box_assignment_batched(cluster_xyz, cluster_batch,
                                           gt.boxes.reshape(b * m, -1)[:, :7], box_batch,
                                           flat_valid)
    return torch.where(cluster_valid, assign, torch.full_like(assign, -1))


def cluster_head_loss(cls_logits, reg_preds, cluster_xyz, cluster_batch, cluster_valid,
                      gt: GroundTruth, cfg: HeadConfig, assign: Optional[torch.Tensor] = None,
                      prefix: str = "") -> Dict[str, torch.Tensor]:
    """Single-task head loss: ``loss_cls`` (focal over valid clusters, per
    valid cluster), ``loss_center``/``loss_size``/``loss_rot``/``loss_vel``
    (L1 per positive), ``loss_corner`` when configured, and the diagnostics
    ``assign_recall`` and ``num_pos``. ``assign`` defaults to
    :func:`assign_clusters_in_box`."""
    coder = BasePointBBoxCoder(cfg.code_size)
    num_classes = cls_logits.shape[-1]
    b, m, _ = gt.boxes.shape
    flat_boxes = gt.boxes.reshape(b * m, -1)
    flat_labels = gt.labels.reshape(b * m)
    if assign is None:
        assign = assign_clusters_in_box(cluster_xyz, cluster_batch, cluster_valid, gt)
    pos = assign >= 0
    safe = assign.clamp(min=0).long()
    labels = torch.where(pos, flat_labels[safe], torch.full_like(flat_labels[safe], num_classes))
    # one-hot over the real classes; background rows all zero
    onehot = F.one_hot(labels.long(), num_classes + 1)[:, :num_classes].to(cls_logits.dtype)
    focal = L.sigmoid_focal_loss(cls_logits, onehot, cfg.focal_gamma, cfg.focal_alpha)
    vmask = cluster_valid.to(cls_logits.dtype)
    cls_avg = mesh_mean(vmask.sum())
    loss_cls = cfg.loss_cls_weight * (focal * vmask[:, None]).sum() / cls_avg.clamp(min=1.0)

    targets = coder.encode(flat_boxes[safe], cluster_xyz)
    w = pos.to(reg_preds.dtype)
    num_pos = mesh_mean(w.sum())
    diff = (reg_preds - targets).abs() * w[:, None]
    den = num_pos.clamp(min=1.0)

    def part(lo, hi, weight):
        return weight * diff[:, lo:hi].sum() / den

    losses = {
        prefix + "loss_cls": loss_cls,
        prefix + "loss_center": part(0, 3, cfg.loss_center_weight),
        prefix + "loss_size": part(3, 6, cfg.loss_size_weight),
        prefix + "loss_rot": part(6, 8, cfg.loss_rot_weight),
    }
    if cfg.code_size == 10:
        vel_flag = flat_boxes[safe, 9] * w   # zero for pasted objects
        losses[prefix + "loss_vel"] = cfg.loss_vel_weight * (
            (reg_preds[:, 8:10] - targets[:, 8:10]).abs() * vel_flag[:, None]).sum() / den
    if cfg.with_corner_loss:
        # huber on each corner's distance to the GT box or its yaw-flipped twin
        dets = coder.decode(reg_preds, cluster_xyz)
        gts_dec = coder.decode(targets, cluster_xyz)
        pc = corners_3d(dets[:, :7])
        gc = corners_3d(gts_dec[:, :7])
        gcf = corners_3d(torch.cat([gts_dec[:, :6], gts_dec[:, 6:7] + math.pi], dim=1))
        dist = torch.minimum(torch.linalg.norm(pc - gc, dim=2), torch.linalg.norm(pc - gcf, dim=2))
        quad = dist.clamp(0.0, cfg.corner_delta)
        huber = 0.5 * quad ** 2 + cfg.corner_delta * (dist - quad)
        losses[prefix + "loss_corner"] = cfg.corner_loss_weight * (huber.mean(dim=1) * w).sum() / den

    # fraction of valid GT boxes claimed by a positive cluster (no "loss" in the key)
    flat_ok = gt.valid.reshape(b * m) & (flat_labels >= 0)
    gt_ids = torch.arange(b * m, device=assign.device)
    claimed = ((assign[None, :] == gt_ids[:, None]) & pos[None, :]).any(dim=1)
    n_claimed = mesh_mean((claimed & flat_ok).float().sum())
    n_gt = mesh_mean(flat_ok.float().sum())
    losses[prefix + "assign_recall"] = torch.where(
        n_gt > 0, n_claimed / n_gt.clamp(min=1e-6), torch.zeros_like(n_gt))
    losses[prefix + "num_pos"] = num_pos
    return losses


def cluster_head_get_bboxes(cls_logits, reg_preds, cluster_xyz, cluster_batch, cluster_valid,
                            batch_size: int, cfg: HeadConfig) -> NMSResult:
    """Decode + per-sample multiclass rotated NMS; [B, max_num] leaves."""
    boxes = BasePointBBoxCoder(cfg.code_size).decode(reg_preds, cluster_xyz)
    return multiclass_nms_bev_batched(
        boxes, torch.sigmoid(cls_logits), cluster_valid, cluster_batch, batch_size,
        cfg.nms_thr, cfg.score_thr, cfg.max_num)
