"""Rotated multiclass NMS with fixed shapes (port of ``ops/nms.py``).

:func:`nms_keep` is the plain greedy scan (the benchmark's frozen copy).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .geometry import boxes_iou_bev


def nms_keep_plain(iou: torch.Tensor, order: torch.Tensor, valid_sorted: torch.Tensor,
                   iou_thr: float) -> torch.Tensor:
    """Plain version of :func:`nms_keep`: the greedy scan row by row, all
    classes at once over per-class permuted copies of the IoU matrix."""
    c, n = order.shape
    o = order.long()
    over = iou[o[:, :, None], o[:, None, :]] > iou_thr       # [C, N, N]
    keep = torch.zeros(c, n, dtype=torch.bool, device=iou.device)
    sup = torch.zeros(c, n, dtype=torch.bool, device=iou.device)
    for i in range(n):
        can = valid_sorted[:, i] & ~sup[:, i]
        keep[:, i] = can
        sup |= over[:, i] & can[:, None]
    return keep


def nms_keep(iou: torch.Tensor, order: torch.Tensor, valid_sorted: torch.Tensor,
             iou_thr: float) -> torch.Tensor:
    """Greedy NMS keep masks in each class's sorted order → [C, N] bool.

    iou [N, N] f32 in the boxes' original order; order [C, N] i32 — each
    class's descending-score order; valid_sorted [C, N] bool in that order.
    Row i of class c is kept iff it is valid and no earlier kept row of c
    has IoU > ``iou_thr`` with it. On a CUDA tensor the kernel takes any N
    whose scratch fits on the card: its bitmask is ``C · N² / 8`` bytes
    (295 MB at C = 10, N = 15,360), beside the caller's ``4 · N²`` of IoU.
    """
    n = iou.shape[0]
    if iou.dtype != torch.float32 or order.dtype != torch.int32 or valid_sorted.dtype != torch.bool:
        raise TypeError("nms_keep takes f32 iou, int32 order, bool valid_sorted")
    if iou.shape != (n, n) or order.dim() != 2 or order.shape[1] != n \
            or valid_sorted.shape != order.shape:
        raise ValueError("nms_keep: iou [N, N], order and valid_sorted [C, N]")
    if iou.device.type not in ("cpu", "cuda") or order.device != iou.device \
            or valid_sorted.device != iou.device:
        raise ValueError("nms_keep: all tensors on one CUDA device (or the CPU)")
    return nms_keep_plain(iou, order, valid_sorted, float(iou_thr))




def class_orders(scores_cn: torch.Tensor, valid_cn: torch.Tensor):
    """Each class's stable descending order of its masked scores and the
    validity in that order: ([C, N] i32, [C, N] bool)."""
    neg = torch.finfo(scores_cn.dtype).min
    masked = torch.where(valid_cn, scores_cn, torch.full_like(scores_cn, neg))
    order = torch.sort(-masked, dim=1, stable=True).indices
    return order.to(torch.int32), torch.gather(valid_cn, 1, order)


def nms_mask_from_iou(iou, scores, valid, iou_thr: float) -> torch.Tensor:
    """Greedy NMS keep mask (original order) for one score channel."""
    order, v = class_orders(scores[None], valid[None])
    keep_sorted = nms_keep(iou.contiguous(), order, v, iou_thr)[0]
    keep = torch.zeros_like(keep_sorted)
    keep[order[0].long()] = keep_sorted
    return keep


class NMSResult(NamedTuple):
    """Batched: [B, max_num] leaves; one sample: [max_num]."""

    boxes: torch.Tensor   # [B, max_num, code]
    scores: torch.Tensor  # [B, max_num]
    labels: torch.Tensor  # [B, max_num] i32
    valid: torch.Tensor   # [B, max_num] bool


def _topk_from_keeps(boxes, scores_cn, keeps, max_num):
    """Top ``max_num`` (box, score, label) over a [C, N] kept-score table;
    ties keep the lower flat index first."""
    _, n = scores_cn.shape
    neg = torch.finfo(scores_cn.dtype).min
    flat = torch.where(keeps, scores_cn, torch.full_like(scores_cn, neg)).reshape(-1)
    k = min(max_num, flat.shape[0])
    top_scores, top_flat = torch.sort(flat, descending=True, stable=True)
    top_scores, top_flat = top_scores[:k], top_flat[:k]
    if k < max_num:
        pad = max_num - k
        top_scores = torch.cat([top_scores, top_scores.new_full((pad,), neg)])
        top_flat = torch.cat([top_flat, top_flat.new_zeros(pad)])
    out_valid = top_scores > neg
    return NMSResult(
        boxes=boxes[top_flat % n],
        scores=torch.where(out_valid, top_scores, torch.zeros_like(top_scores)),
        labels=torch.where(out_valid, torch.div(top_flat, n, rounding_mode="floor"),
                           torch.full_like(top_flat, -1)).to(torch.int32),
        valid=out_valid,
    )


def nms_bev_mask(boxes, scores, valid, iou_thr: float) -> torch.Tensor:
    """Greedy rotated-BEV NMS keep mask [N] in the boxes' original order:
    invalid rows are never kept and never suppress; IoU > ``iou_thr``
    suppresses. One K3 launch."""
    return nms_mask_from_iou(boxes_iou_bev(boxes, boxes), scores, valid, iou_thr)


def _class_keeps(iou, scores, valid, iou_thr: float, score_thr: float):
    """Per-class keep masks [C, N] in the original order over a shared IoU
    matrix (one K3 launch for every class), and the scores as [C, N]."""
    scores_cn = scores.T.contiguous()
    valid_cn = valid[None, :] & (scores_cn > score_thr)
    order, v = class_orders(scores_cn, valid_cn)
    keep_sorted = nms_keep(iou.contiguous(), order, v.contiguous(), iou_thr)
    keeps = torch.zeros_like(keep_sorted)
    keeps.scatter_(1, order.long(), keep_sorted)
    return keeps, scores_cn


def multiclass_nms_bev(boxes, scores, valid, iou_thr: float, score_thr: float,
                       max_num: int) -> NMSResult:
    """mmdet3d's ``box3d_multiclass_nms`` for one sample: boxes [N, code],
    per-class scores [N, C]; NMS per class channel (a box may survive under
    several classes), then the top ``max_num`` (box, score, label) over all
    channels. Returns [max_num] leaves."""
    keeps, scores_cn = _class_keeps(boxes_iou_bev(boxes, boxes), scores, valid, iou_thr,
                                    score_thr)
    return _topk_from_keeps(boxes, scores_cn, keeps, max_num)


def multiclass_nms_bev_batched(boxes, scores, valid, batch_idx, batch_size: int,
                               iou_thr: float, score_thr: float, max_num: int) -> NMSResult:
    """Per-sample multiclass rotated NMS for the whole batch in one pass:
    cross-sample IoU is zeroed, so one greedy scan per class equals the
    per-sample scans. Returns [B, max_num] leaves."""
    iou = boxes_iou_bev(boxes, boxes)
    iou = torch.where(batch_idx[:, None] == batch_idx[None, :], iou, torch.zeros_like(iou))
    keeps, scores_cn = _class_keeps(iou, scores, valid, iou_thr, score_thr)
    results = [
        _topk_from_keeps(boxes, scores_cn, keeps & (batch_idx == b)[None, :], max_num)
        for b in range(batch_size)
    ]
    return NMSResult(*[torch.stack([getattr(r, f) for r in results]) for f in NMSResult._fields])
