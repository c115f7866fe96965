"""Target assigners (port of ``core/assigners.py``): point-in-box, 2D
max-IoU on projected GT, nearest same-class center, and their merge.

Results are per-query flat GT indices into the [B·M]-flattened padded GT
table, -1 for background. Ties resolve as in the JAX package: the lowest
index among equal maxima (``argmax``/``argmin``), and in the low-quality
match the highest-index 2D GT that claims a prediction.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..ops.geometry import axis_aligned_iou_2d, corners_3d, hull_canvas_aabb, \
    points_box_assignment_batched
from ..utils.containers import GroundTruth


def flatten_gt(gt: GroundTruth):
    """(boxes [B·M, D], labels [B·M], valid [B·M], batch [B·M])."""
    b, m, _ = gt.boxes.shape
    labels = gt.labels.reshape(b * m)
    valid = gt.valid.reshape(b * m) & (labels >= 0)
    batch = torch.arange(b, dtype=torch.int32, device=gt.boxes.device).repeat_interleave(m)
    return gt.boxes.reshape(b * m, -1), labels, valid, batch


def assign_point_in_box(query_xyz, query_batch, query_valid, gt: GroundTruth,
                        extra_height: float = 0.0) -> torch.Tensor:
    """A query center inside a (height-enlarged) GT box → that GT, else -1."""
    boxes, _, valid, batch = flatten_gt(gt)
    b7 = boxes[:, :7]
    if extra_height != 0.0:
        z = b7[:, 2] - extra_height * 0.5
        dz = b7[:, 5] + extra_height
        b7 = torch.cat([b7[:, :2], z[:, None], b7[:, 3:5], dz[:, None], b7[:, 6:7]], dim=1)
    assign = points_box_assignment_batched(query_xyz, query_batch, b7, batch, valid)
    return torch.where(query_valid, assign, torch.full_like(assign, -1))


def project_gt_boxes_2d(gt_boxes, lidar2img, img_w: int, img_h: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """3D boxes [G, 7+] through per-box projections [G, 4, 4] onto one
    camera: the axis-aligned box of the corners' hull clipped to the canvas.
    Returns (bboxes [G, 4] xyxy, valid [G])."""
    corners = corners_3d(gt_boxes[:, :7])
    pts4 = torch.cat([corners, corners.new_ones(corners.shape[:2] + (1,))], dim=-1)
    proj = torch.einsum("gnd,gkd->gnk", pts4, lidar2img)
    depth = proj[..., 2]
    any_front = (depth > 1e-5).any(dim=1)
    z = depth.clamp(1e-5, 1e5)
    uv = torch.stack([proj[..., 0] / z, proj[..., 1] / z], dim=-1)
    bboxes, nonempty = hull_canvas_aabb(uv, float(img_w), float(img_h))
    valid = (any_front & nonempty & (bboxes[:, 2] > bboxes[:, 0])
             & (bboxes[:, 3] > bboxes[:, 1]))
    return bboxes, valid


def max_iou_assign_2d(pred_boxes, pred_cam, pred_batch, pred_valid, gt_boxes_2d, gt_cam,
                      gt_batch, gt_valid, gt_index, pos_iou_thr: float = 0.7,
                      neg_iou_thr: float = 0.3, min_pos_iou: float = 0.3,
                      match_low_quality: bool = True) -> torch.Tensor:
    """mmdet MaxIoUAssigner per camera → per-prediction flat 3D-GT index
    (-1 = not positive)."""
    iou = axis_aligned_iou_2d(pred_boxes, gt_boxes_2d)
    mask = (pred_valid[:, None] & gt_valid[None, :] & (pred_cam[:, None] == gt_cam[None, :])
            & (pred_batch[:, None] == gt_batch[None, :]))
    iou = torch.where(mask, iou, torch.full_like(iou, -1.0))
    best_iou = iou.amax(dim=1)
    best_gt = torch.argmax(iou, dim=1)
    assigned = torch.where(best_iou >= pos_iou_thr, best_gt, torch.full_like(best_gt, -1))
    if match_low_quality:
        # each 2D GT claims its best prediction at IoU ≥ min_pos_iou; of the
        # GTs claiming one prediction the highest index wins
        best_pred_per_gt = torch.argmax(iou, dim=0)
        qualify = iou.amax(dim=0) >= min_pos_iou
        order = torch.arange(gt_boxes_2d.shape[0], device=iou.device)
        claim = torch.where(qualify, order, torch.full_like(order, -1))
        winner = torch.full((pred_boxes.shape[0],), -1, dtype=claim.dtype, device=iou.device)
        winner.scatter_reduce_(0, best_pred_per_gt, claim, reduce="amax", include_self=True)
        assigned = torch.where(winner >= 0, winner, assigned)
    return torch.where(assigned >= 0, gt_index[assigned.clamp(min=0)].long(),
                       torch.full_like(assigned, -1)).to(torch.int32)


def build_gt_boxes_2d(gt: GroundTruth, lidar2img, img_w: int, img_h: int):
    """Every (GT, camera) pair projected → the flat 2D GT table of
    :func:`max_iou_assign_2d`: (boxes, cam, batch, valid, 3D-GT index)."""
    boxes, _, valid, batch = flatten_gt(gt)
    num_cams = lidar2img.shape[1]
    gf = boxes.shape[0]
    mats = lidar2img[batch.long()]
    all_boxes, all_valid = [], []
    for c in range(num_cams):
        b2, v2 = project_gt_boxes_2d(boxes, mats[:, c], img_w, img_h)
        all_boxes.append(b2)
        all_valid.append(v2 & valid)
    dev = boxes.device
    cam = torch.arange(num_cams, dtype=torch.int32, device=dev).repeat_interleave(gf)
    index = torch.arange(gf, dtype=torch.int32, device=dev).repeat(num_cams)
    return (torch.cat(all_boxes), cam, batch.repeat(num_cams), torch.cat(all_valid), index)


def assign_by_dist(query_xyz, query_logits, query_batch, query_valid, gt: GroundTruth,
                   max_dist_per_class: Sequence[float]) -> torch.Tensor:
    """A query of predicted class c → the nearest same-class GT center in
    BEV within ``max_dist_per_class[c]``, else -1."""
    boxes, labels, valid, batch = flatten_gt(gt)
    pred_label = torch.argmax(query_logits, dim=-1)
    d = torch.linalg.norm(query_xyz[:, None, :2] - boxes[None, :, :2], dim=-1)
    mask = (valid[None, :] & (query_batch[:, None] == batch[None, :])
            & (pred_label[:, None] == labels[None, :]))
    d = torch.where(mask, d, torch.full_like(d, float("inf")))
    best = torch.argmin(d, dim=1)
    maxd = torch.as_tensor(max_dist_per_class, dtype=d.dtype, device=d.device)[
        pred_label.clamp(0, len(max_dist_per_class) - 1)]
    ok = query_valid & (d.amin(dim=1) < maxd)
    return torch.where(ok, best, torch.full_like(best, -1)).to(torch.int32)


def merge_assign(primary: torch.Tensor, secondary: torch.Tensor) -> torch.Tensor:
    """Backgrounds of ``primary`` take ``secondary``'s positives."""
    return torch.where(primary >= 0, primary, secondary)


def hybrid_assign(query_xyz, query_batch, query_valid, preds_2d, gt: GroundTruth,
                  no_aug_gt: GroundTruth, lidar2img, img_w: int, img_h: int,
                  query_logits: Optional[torch.Tensor] = None,
                  max_dist_per_class: Optional[Sequence[float]] = None,
                  extra_height: float = 0.0, restrict_3d_to_noaug: bool = False) -> torch.Tensor:
    """3D point-in-box first, 2D max-IoU on the projected no-aug GT for the
    rest, then (given logits and distances) the distance assigner. The
    padded augmented and no-aug GT tables are row-aligned per sample, so
    their indices merge directly."""
    gt3d = no_aug_gt if restrict_3d_to_noaug else gt
    a3d = assign_point_in_box(query_xyz, query_batch, query_valid, gt3d, extra_height)
    gt2d, gt2d_cam, gt2d_batch, gt2d_valid, gt2d_index = build_gt_boxes_2d(
        no_aug_gt, lidar2img, img_w, img_h)
    has_2d = query_valid & (preds_2d[:, 8] > 0)
    a2d = max_iou_assign_2d(preds_2d[:, :4], preds_2d[:, 6].to(torch.int32), query_batch, has_2d,
                            gt2d, gt2d_cam, gt2d_batch, gt2d_valid, gt2d_index)
    out = merge_assign(a3d, a2d)
    if query_logits is not None and max_dist_per_class is not None:
        out = merge_assign(out, assign_by_dist(query_xyz, query_logits, query_batch, query_valid,
                                               gt, max_dist_per_class))
    return torch.where(query_valid, out, torch.full_like(out, -1))
