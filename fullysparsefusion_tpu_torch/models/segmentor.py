"""VoteSegmentor (port of ``models/segmentor.py``): voxelize → VFE → sparse
UNet → voxel-to-point neck (``SegmentorCore``), then the per-point head
emitting (C+1)-way logits and sqrt-encoded center votes (``VoteSegHead``),
the two together as SingleStageFSD's ``VoteSegmentor``; the per-point
targets from GT boxes and the segmentation + vote loss."""
from __future__ import annotations

import torch
from torch import nn

from ..config import Capacities, VoteSegmentorConfig
from ..core import losses as L
from ..ops.geometry import gravity_center, points_box_assignment_batched
from ..ops.sparse_conv import SparseTensor
from ..ops.voxelize import grid_dims, voxelize_points
from ..utils.containers import GroundTruth, PointBatch
from ..utils.profiling import span
from .layers import MLP
from .sparse_unet import SparseUNet
from .vfe import DynamicScatterVFE


def encode_vote_targets(delta: torch.Tensor) -> torch.Tensor:
    return torch.sign(delta) * torch.sqrt(delta.abs())


def decode_vote_targets(preds: torch.Tensor) -> torch.Tensor:
    return preds * preds.abs()


class SegmentorCore(nn.Module):
    """voxelize → VFE → sparse UNet → voxel2point neck → per-point features."""

    def __init__(self, cfg: VoteSegmentorConfig, caps: Capacities):
        super().__init__()
        self.cfg = cfg
        self.caps = caps
        c = cfg
        self.DynamicScatterVFE_0 = DynamicScatterVFE(
            c.point_dim, tuple(c.vfe_channels), c.voxel_size, tuple(c.point_cloud_range[:3]))
        self.SparseUNet_0 = SparseUNet(
            c.vfe_channels[-1], caps.voxels,
            base_channels=c.unet_base_channels,
            output_channels=c.unet_output_channels,
            encoder_channels=c.unet_encoder_channels,
            encoder_strided_paddings=c.unet_strided_paddings,
            decoder_channels=c.unet_decoder_channels,
            stage_capacity_divisors=c.unet_capacity_divisors,
            stage_capacities=c.unet_stage_capacities,
            dense_min_occupancy=c.unet_dense_min_occupancy,
        )
        self.feat_dim = c.unet_output_channels + 3

    def forward(self, pb: PointBatch, batch_size: int):
        c = self.cfg
        xyz = pb.xyz
        with span("seg_core"):
            with span("vfe"):
                seg, _, vox_batch, vox_coords = voxelize_points(
                    xyz, pb.batch_idx, pb.valid, c.voxel_size, c.point_cloud_range,
                    self.caps.voxels)
                pt_valid = pb.valid & (seg.seg_id < self.caps.voxels)
                voxel_feats = self.DynamicScatterVFE_0(pb.points, seg, vox_coords, pt_valid)
            st = SparseTensor(feats=voxel_feats, coords=vox_coords, batch=vox_batch,
                              valid=seg.seg_valid,
                              dims=grid_dims(c.voxel_size, c.point_cloud_range),
                              batch_size=batch_size)
            with span("sparse_unet"):
                unet_out = self.SparseUNet_0(st)
            sid = seg.seg_id.clamp(0, self.caps.voxels - 1).long()
            vs = torch.tensor(c.voxel_size, dtype=xyz.dtype, device=xyz.device)
            lo = torch.tensor(c.point_cloud_range[:3], dtype=xyz.dtype, device=xyz.device)
            centers = vox_coords.to(xyz.dtype) * vs + vs * 0.5 + lo
            seg_feats = torch.cat([unet_out[sid], xyz - centers[sid]], dim=1)
            return seg_feats * pt_valid[:, None].to(seg_feats.dtype), pt_valid


class VoteSegHead(nn.Module):
    """Per-point MLP head → (C+1)-way logits + per-class center votes."""

    def __init__(self, cfg: VoteSegmentorConfig, in_dim: int):
        super().__init__()
        n_out = cfg.num_classes + 1
        self.MLP_0 = MLP(in_dim, tuple(cfg.head_hidden_dims), norm="bn", act="relu")
        self.Dense_0 = nn.Linear(cfg.head_hidden_dims[-1], n_out)
        self.Dense_1 = nn.Linear(cfg.head_hidden_dims[-1], n_out * 3)

    def forward(self, seg_feats, valid):
        hidden = self.MLP_0(seg_feats, valid)
        vote_preds = self.Dense_1(hidden)
        return dict(
            seg_feats=seg_feats,
            seg_logits=self.Dense_0(hidden),
            vote_preds=vote_preds,
            offsets=decode_vote_targets(vote_preds),
            valid=valid,
        )


class VoteSegmentor(nn.Module):
    """``SegmentorCore`` then ``VoteSegHead``, under flax's compact names."""

    def __init__(self, cfg: VoteSegmentorConfig, caps: Capacities):
        super().__init__()
        self.SegmentorCore_0 = SegmentorCore(cfg, caps)
        self.VoteSegHead_0 = VoteSegHead(cfg, self.SegmentorCore_0.feat_dim)

    def forward(self, pb: PointBatch, batch_size: int):
        seg_feats, pt_valid = self.SegmentorCore_0(pb, batch_size)
        return self.VoteSegHead_0(seg_feats, pt_valid)


def segmentor_targets(pb: PointBatch, gt: GroundTruth, num_classes: int):
    """Per point: (label, the box's class or ``num_classes`` for background;
    vote target, the sqrt-encoded offset to the containing box's gravity
    center; vote mask, in a box) — the lowest-index box of the point's
    sample that contains it."""
    b, m, _ = gt.boxes.shape
    flat_boxes = gt.boxes.reshape(b * m, -1)
    flat_labels = gt.labels.reshape(b * m)
    flat_valid = gt.valid.reshape(b * m) & (flat_labels >= 0)
    box_batch = torch.arange(b, dtype=torch.int32, device=gt.boxes.device).repeat_interleave(m)
    assign = points_box_assignment_batched(pb.xyz, pb.batch_idx, flat_boxes[:, :7], box_batch,
                                           flat_valid)
    in_box = assign >= 0
    safe = assign.clamp(min=0).long()
    bg = torch.full_like(flat_labels[safe], num_classes)
    labels = torch.where(in_box & pb.valid, flat_labels[safe], bg).to(torch.int32)
    centers = gravity_center(flat_boxes[:, :7])
    delta = torch.where(in_box[:, None], centers[safe] - pb.xyz, torch.zeros_like(pb.xyz))
    return labels, encode_vote_targets(delta), in_box & pb.valid


def segmentor_loss(out, labels, vote_targets, vote_mask, cfg: VoteSegmentorConfig):
    """``loss_sem_seg``: cross-entropy with the background weighted
    ``bg_class_weight``, normalised by the valid points' summed class
    weights, times ``seg_loss_weight``; ``loss_vote``: L1 of the labelled
    class's vote against the sqrt target over in-box points (3 per point),
    times ``vote_loss_weight``."""
    n_cls = cfg.num_classes + 1
    valid = out["valid"]
    logits = out["seg_logits"]
    class_weight = torch.ones(n_cls, dtype=logits.dtype, device=logits.device)
    class_weight[-1] = cfg.bg_class_weight
    vf = valid.to(logits.dtype)
    ce = L.softmax_ce_loss(logits, labels, class_weight)
    safe = labels.clamp(0, n_cls - 1).long()
    w_per = class_weight[safe] * vf
    loss_sem = cfg.seg_loss_weight * (ce * vf).sum() / w_per.sum().clamp(min=1.0)
    votes = out["vote_preds"].reshape(-1, n_cls, 3)
    picked = votes.gather(1, safe[:, None, None].expand(-1, 1, 3))[:, 0]
    vm = (vote_mask & valid).to(picked.dtype)
    loss_vote = cfg.vote_loss_weight * ((picked - vote_targets).abs() * vm[:, None]).sum() \
        / (vm.sum() * 3).clamp(min=1.0)
    return dict(loss_sem_seg=loss_sem, loss_vote=loss_vote)
