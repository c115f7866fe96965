"""Sparse cluster detection heads (port of ``models/heads.py``): a shared
MLP, then per CenterPoint-style task one small MLP per regression
attribute plus the score branch (and the optional IoU branch); the
single-task loss (focal classification over valid clusters, L1 on the
coder's targets for positives, the optional corner and IoU losses, and the
``assign_recall`` / ``num_pos`` diagnostics) and its per-task form over
task-remapped GT; decode + per-sample multiclass rotated NMS, per task with
the task-local labels mapped back to global ones. Under ``layers.bn_group``
the loss normalizers and the diagnostics' counts are means over the ranks
(``layers.mesh_mean``)."""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import HeadConfig
from ..core import losses as L
from ..core.coders import BasePointBBoxCoder
from ..ops.geometry import boxes_iou_3d, corners_3d, points_box_assignment_batched
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
    """Task-grouped cluster head: the shared ``MLP_0``, then one
    ``SeparateHead_{t}`` per task with a ``score`` attr of ``len(task)``
    classes (and an ``iou`` attr of 1 when ``cfg.with_iou``). Returns lists
    over the tasks, ``cls_logits_tasks`` [C, len(task)], ``reg_preds_tasks``
    [C, code] (and ``iou_logits_tasks`` [C]); with one task also that task's
    ``cls_logits`` / ``reg_preds`` (/ ``iou_logits``)."""

    def __init__(self, cfg: HeadConfig, tasks: Sequence[Sequence[str]],
                 class_names: Sequence[str]):
        super().__init__()
        self.with_iou = cfg.with_iou
        self.num_tasks = len(tasks)
        self.MLP_0 = MLP(cfg.in_channel, tuple(cfg.shared_mlp_dims), norm=cfg.norm, act=cfg.act)
        for t, names in enumerate(tasks):
            attrs = tuple(cfg.common_attrs) + (
                ("score", len(names), cfg.num_cls_layer, cfg.cls_hidden_dim),)
            if cfg.with_iou:
                attrs = attrs + (("iou", 1, cfg.num_cls_layer, cfg.cls_hidden_dim),)
            setattr(self, f"SeparateHead_{t}",
                    SeparateHead(cfg.shared_mlp_dims[-1], attrs, cfg.norm, cfg.act))

    def forward(self, cluster_feats, valid):
        x = self.MLP_0(cluster_feats, valid)
        out = {"cls_logits_tasks": [], "reg_preds_tasks": []}
        if self.with_iou:
            out["iou_logits_tasks"] = []
        for t in range(self.num_tasks):
            ret = getattr(self, f"SeparateHead_{t}")(x, valid)
            out["cls_logits_tasks"].append(ret["score"])
            out["reg_preds_tasks"].append(torch.cat(
                [ret[k] for k in ("center", "dim", "rot", "vel") if k in ret], dim=-1))
            if self.with_iou:
                out["iou_logits_tasks"].append(ret["iou"][:, 0])
        if self.num_tasks == 1:
            for k in list(out):
                out[k.removesuffix("_tasks")] = out[k][0]
        return out


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
                      prefix: str = "", iou_logits: Optional[torch.Tensor] = None
                      ) -> Dict[str, torch.Tensor]:
    """Single-task head loss: ``loss_cls`` (focal over valid clusters, per
    valid cluster), ``loss_center``/``loss_size``/``loss_rot``/``loss_vel``
    (L1 per positive), ``loss_corner`` when configured, ``loss_iou`` when
    ``iou_logits`` is given, and the diagnostics ``assign_recall`` and
    ``num_pos``. ``assign`` defaults to :func:`assign_clusters_in_box`.

    The IoU branch's labels (``cfg.iou_label_mode``): "dist", a ramp from 1
    to 0 of a positive's BEV distance to its GT center between
    ``dist_min_thre`` and ``dist_max_thre`` (0 for background); "iou", the
    best 3D IoU of the decoded, detached prediction with a valid GT box of
    its own sample, ramped from 0 to 1 between ``iou_bg_thresh`` and
    ``iou_fg_thresh``. L1 against the logits over valid clusters, normalised
    as ``loss_cls``."""
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

    if iou_logits is not None:
        if cfg.iou_label_mode == "dist":
            dist = torch.linalg.norm(cluster_xyz[:, :2] - flat_boxes[safe, :2], dim=-1)
            lo, hi = cfg.dist_min_thre, cfg.dist_max_thre
            ramp = ((hi - dist) / max(hi - lo, 1e-6)).clamp(0.0, 1.0)
            iou_labels = torch.where(pos, ramp, torch.zeros_like(ramp))
        else:
            dets = coder.decode(reg_preds.detach(), cluster_xyz)
            iou_all = boxes_iou_3d(dets[:, :7], flat_boxes[:, :7])
            box_batch = torch.arange(b, dtype=torch.int32, device=gt.boxes.device
                                     ).repeat_interleave(m)
            pair_ok = (cluster_batch[:, None] == box_batch[None, :]) \
                & (gt.valid.reshape(-1) & (flat_labels >= 0))[None, :]
            ious = torch.where(pair_ok, iou_all, torch.zeros_like(iou_all)).amax(dim=1)
            lo, hi = cfg.iou_bg_thresh, cfg.iou_fg_thresh
            iou_labels = ((ious.clamp(0.0, 1.0) - lo) / max(hi - lo, 1e-6)).clamp(0.0, 1.0)
        losses[prefix + "loss_iou"] = cfg.loss_iou_weight * (
            (iou_logits - iou_labels).abs() * vmask).sum() / cls_avg.clamp(min=1.0)

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


def task_label_tables(class_names: Sequence[str], tasks: Sequence[Sequence[str]]
                      ) -> Tuple[Tuple[Tuple[int, ...], ...], Tuple[Tuple[int, ...], ...]]:
    """``(to_local, to_global)``: ``to_local[t][global_cls]`` is the class's
    label within task ``t`` (-1 if the task lacks it), ``to_global[t][local]``
    the global class id."""
    to_local, to_global = [], []
    for names in tasks:
        tl = [-1] * len(class_names)
        tg = []
        for i, n in enumerate(names):
            ci = list(class_names).index(n)
            tl[ci] = i
            tg.append(ci)
        to_local.append(tuple(tl))
        to_global.append(tuple(tg))
    return tuple(to_local), tuple(to_global)


def remap_gt_for_task(gt: GroundTruth, to_local: Sequence[int]) -> GroundTruth:
    """GT of one task: labels mapped to the task's local ones, the boxes of
    other tasks' classes (and of label -1) invalid."""
    table = torch.tensor(to_local, dtype=torch.int32, device=gt.labels.device)
    lab = torch.where(gt.labels >= 0, table[gt.labels.clamp(min=0).long()],
                      torch.full_like(gt.labels, -1)).to(gt.labels.dtype)
    return dataclasses.replace(gt, labels=lab, valid=gt.valid & (lab >= 0))


def multi_task_cluster_head_loss(cls_logits_list, reg_preds_list, cluster_xyz, cluster_batch,
                                 cluster_valid, gt: GroundTruth, cfg: HeadConfig,
                                 tasks: Sequence[Sequence[str]], class_names: Sequence[str],
                                 prefix: str = "", iou_logits_list=None
                                 ) -> Dict[str, torch.Tensor]:
    """:func:`cluster_head_loss` per task against that task's GT
    (:func:`remap_gt_for_task`), keys ``{prefix}task{t}_...``; one task keeps
    the unsuffixed keys, and when it holds every class the GT as it is."""
    to_local, _ = task_label_tables(class_names, tasks)
    single = len(tasks) == 1
    out: Dict[str, torch.Tensor] = {}
    for t in range(len(tasks)):
        gt_t = gt if single and len(tasks[t]) == len(class_names) else \
            remap_gt_for_task(gt, to_local[t])
        out.update(cluster_head_loss(
            cls_logits_list[t], reg_preds_list[t], cluster_xyz, cluster_batch, cluster_valid,
            gt_t, cfg, prefix=prefix if single else f"{prefix}task{t}_",
            iou_logits=None if iou_logits_list is None else iou_logits_list[t]))
    return out


def multi_task_get_bboxes(cls_logits_list, reg_preds_list, cluster_xyz, cluster_batch,
                          cluster_valid, batch_size: int, cfg: HeadConfig,
                          tasks: Sequence[Sequence[str]], class_names: Sequence[str]
                          ) -> NMSResult:
    """Per task: decode, multiclass rotated NMS (one K3 launch), task-local
    labels → global; the tasks' results concatenated to [B, T · max_num]
    (one task's returned as it is)."""
    _, to_global = task_label_tables(class_names, tasks)
    results = []
    for t in range(len(tasks)):
        r = cluster_head_get_bboxes(cls_logits_list[t], reg_preds_list[t], cluster_xyz,
                                    cluster_batch, cluster_valid, batch_size, cfg)
        tg = torch.tensor(to_global[t], dtype=torch.int32, device=r.labels.device)
        results.append(r._replace(labels=torch.where(
            r.valid, tg[r.labels.clamp(min=0).long()], torch.full_like(r.labels, -1))))
    if len(results) == 1:
        return results[0]
    return NMSResult(*[torch.cat([getattr(r, f) for r in results], dim=1)
                       for f in NMSResult._fields])
