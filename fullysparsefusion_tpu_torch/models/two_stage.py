"""Two-stage FSD (port of ``models/two_stage.py``): ``SingleStageFSD``
proposals refined by the ``GroupCorrectionHead``.

The first stage's decoded cluster boxes, detached, are the RoIs; their
member points are re-pooled with the segmentor's point features and
refined. The first stage runs no NMS; the decode is the RCNN's.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import FSDConfig, HeadConfig
from ..core.coders import BasePointBBoxCoder
from ..utils.containers import GroundTruth, PointBatch
from .fsd import SingleStageFSD
from .layers import bn_form
from .rcnn import GroupCorrectionHead, rcnn_get_bboxes, rcnn_loss


class TwoStageFSD(nn.Module):
    """``rpn`` = ``SingleStageFSD`` (one task: its single-task ``reg_preds``
    are the proposals), ``roi_head`` = ``GroupCorrectionHead`` under
    ``rcnn_cfg`` (default: the first stage's head config)."""

    def __init__(self, cfg: FSDConfig, rcnn_cfg: Optional[HeadConfig] = None):
        super().__init__()
        if len(cfg.task_tuple()) != 1:
            raise ValueError("TwoStageFSD reads the first stage's single-task reg_preds: "
                             "its FSDConfig must have one task (tasks=None)")
        self.cfg = cfg
        self.rcnn_cfg = rcnn_cfg or cfg.head
        self.rpn = SingleStageFSD(cfg)
        self.roi_head = GroupCorrectionHead(self.rcnn_cfg, cfg.caps, cfg.segmentor.point_dim,
                                            self.rpn.segmentor.SegmentorCore_0.feat_dim)
        self.coder = BasePointBBoxCoder(cfg.head.code_size)

    def forward(self, pb: PointBatch, batch_size: int, gt: Optional[GroundTruth] = None,
                train: Optional[bool] = None, thresh_buffer=0.0, detection_weight=1.0):
        """The JAX package's ``TwoStageFSD.__call__``: the first stage's
        result plus ``rcnn`` (the head's outputs), ``rois``, ``roi_batch``
        and ``roi_valid``; with ``gt`` its ``losses`` add the ``rcnn_``
        terms, each loss scaled by ``detection_weight``. ``train`` picks the
        BN form for this call (None: the module's mode)."""
        with bn_form(self, train):
            out1 = self.rpn(pb, batch_size, gt, None, thresh_buffer, detection_weight)
            rois = self.coder.decode(out1["reg_preds"], out1["cluster_xyz"]).detach()
            roi_batch, roi_valid = out1["cluster_batch"], out1["cluster_valid"]
            seg_out = out1["seg_out"]
            outs2 = self.roi_head(pb.points, seg_out["seg_feats"], pb.batch_idx, seg_out["valid"],
                                  rois, roi_batch, roi_valid)
            result = dict(out1, rcnn=outs2, rois=rois, roi_batch=roi_batch, roi_valid=roi_valid)
            if gt is not None:
                losses = dict(out1["losses"])
                det = rcnn_loss(outs2, rois, roi_batch, roi_valid, gt, self.rcnn_cfg)
                losses.update({k: v * detection_weight if "loss" in k else v
                               for k, v in det.items()})
                result["losses"] = losses
        return result

    @torch.no_grad()
    def get_bboxes(self, result, batch_size: int):
        """The RCNN decode: one multiclass NMS (one K3 launch), [B, max_num]."""
        return rcnn_get_bboxes(result["rcnn"], result["rois"], result["roi_batch"], batch_size,
                               self.rcnn_cfg)
