"""Sparse cluster detection heads, forward and decode (port of
``models/heads.py``): a shared MLP, one small MLP per regression attribute
plus the score branch, and decode + per-sample multiclass rotated NMS."""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..config import HeadConfig
from ..core.coders import BasePointBBoxCoder
from ..ops.nms import NMSResult, multiclass_nms_bev_batched
from .layers import MLP


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


def cluster_head_get_bboxes(cls_logits, reg_preds, cluster_xyz, cluster_batch, cluster_valid,
                            batch_size: int, cfg: HeadConfig) -> NMSResult:
    """Decode + per-sample multiclass rotated NMS; [B, max_num] leaves."""
    boxes = BasePointBBoxCoder(cfg.code_size).decode(reg_preds, cluster_xyz)
    return multiclass_nms_bev_batched(
        boxes, torch.sigmoid(cls_logits), cluster_valid, cluster_batch, batch_size,
        cfg.nms_thr, cfg.score_thr, cfg.max_num)
