"""LiDAR-query branch and the LiDAR-only single-stage FSD (port of
``models/fsd.py``).

Segmentor output → 0.1 m pre-voxelize dedup → ``group_sample`` (softmax
foreground per class group, voted centers) → per-group clustering (voxelize
the voted centers, drop near-empty voxels, connected components per sample;
or, per group, FPS + ball grouping) → SIR over (group, batch, cluster)
segments → the task-grouped cluster head. :class:`SingleStageFSD` is the
``VoteSegmentor`` followed by that branch, with the segmentor and per-task
head losses and the per-task decode.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from ..config import FSDConfig
from ..ops.ccl import connected_components_bev, connected_components_bev_batched
from ..ops.fps import ssg_cluster
from ..ops.segment import SegmentInfo, unique_segments
from ..ops.voxelize import grid_dims, linearize_coords, voxel_coords, voxelize_points
from ..utils.containers import GroundTruth, PointBatch
from ..utils.gather import masked_gather
from ..utils.profiling import span
from .heads import (SparseClusterHead, cluster_head_get_bboxes, multi_task_cluster_head_loss,
                    multi_task_get_bboxes)
from .layers import bn_form
from .segmentor import VoteSegmentor, segmentor_loss, segmentor_targets
from .sir import SIR


class ForegroundSet(NamedTuple):
    points: torch.Tensor     # [F, D]
    feats: torch.Tensor      # [F, Cf] logits + votes + seg_feats
    centers: torch.Tensor    # [F, 3] voted centers
    batch_idx: torch.Tensor  # [F]
    group_idx: torch.Tensor  # [F]
    valid: torch.Tensor      # [F]


def _force_one_fg_per_sample(fg, batch_idx, valid, batch_size: int):
    """Any sample whose group mask came up empty gets its first valid point
    forced to foreground."""
    n = fg.shape[0]
    iota = torch.arange(n, dtype=torch.int32, device=fg.device)
    sample = batch_idx[None, :] == torch.arange(batch_size, dtype=batch_idx.dtype,
                                                device=fg.device)[:, None]
    sv = sample & valid[None, :]
    has_fg = (sv & fg[None, :]).any(dim=1)
    first = torch.where(sv, iota[None, :], torch.full_like(iota[None, :], n)).amin(dim=1)
    force_slot = torch.where(~has_fg & (first < n), first, torch.full_like(first, -1))
    b_ok = (batch_idx >= 0) & (batch_idx < batch_size)
    forced = valid & b_ok & (force_slot[batch_idx.clamp(0, batch_size - 1).long()] == iota)
    return fg | forced


def group_sample(seg_logits, offsets, xyz, valid, cfg: FSDConfig, thresh_buffer=0.0,
                 batch_idx=None, batch_size: int = 1):
    """Per-group foreground masks + voted centers (offset of the max-logit
    member class, ties split evenly)."""
    num_classes = cfg.num_classes
    scores = torch.softmax(seg_logits, dim=1)[:, :num_classes]
    off = offsets.reshape(-1, num_classes + 1, 3)
    fg_masks, centers = [], []
    for g, cls_ids in enumerate(cfg.group_class_ids()):
        ids = torch.tensor(cls_ids, device=seg_logits.device)
        fg = valid & (scores[:, ids].sum(dim=1) > cfg.score_thresh[g] + thresh_buffer)
        if batch_idx is not None:
            fg = _force_one_fg_per_sample(fg, batch_idx, valid, batch_size)
        logits_g = seg_logits[:, ids]
        mx = logits_g.amax(dim=1, keepdim=True)
        w = ((logits_g - mx).abs() < 1e-6).to(off.dtype)
        w = w / w.sum(dim=1, keepdim=True).clamp(min=1e-6)
        fg_masks.append(fg)
        centers.append(xyz + torch.einsum("pc,pcd->pd", w, off[:, ids, :]))
    return fg_masks, centers


def _cluster_voxelize_group(centers, batch_idx, valid, group_id: int, cfg: FSDConfig):
    vsize = cfg.cluster_voxel_sizes[group_id]
    pc_range = cfg.segmentor.point_cloud_range
    vcap = cfg.caps.cluster_voxels_per_group
    coords, in_range = voxel_coords(centers, vsize, pc_range)
    ok = valid & in_range
    keys = linearize_coords(coords, batch_idx, grid_dims(vsize, pc_range))
    seg = unique_segments(keys, ok, vcap)
    ok = ok & (seg.seg_id < vcap)
    cnt_per_point = seg.counts[seg.seg_id.clamp(0, vcap - 1).long()]
    ok = ok & (cnt_per_point >= cfg.min_cluster_points)
    vox_nonempty = seg.seg_valid & (seg.counts >= cfg.min_cluster_points)
    vox_centers = seg.mean(centers)
    return seg, ok, vox_centers, vox_nonempty


def cluster_one_group(centers, batch_idx, valid, group_id: int, cfg: FSDConfig):
    """One group's clustering without the per-sample re-slotting: voxelize
    the voted centers, drop near-empty voxels, connected components over
    the voxel mean centers (xy closer than the group's ``connected_dists``,
    same sample), labels back per point. Returns (label [K] i32, -1 where
    not clustered; point_valid [K])."""
    vcap = cfg.caps.cluster_voxels_per_group
    seg, ok, vox_centers, vox_nonempty = _cluster_voxelize_group(
        centers, batch_idx, valid, group_id, cfg)
    vox_batch = seg.mean(batch_idx.float()).to(torch.int32)
    labels_vox = connected_components_bev(vox_centers, vox_batch, vox_nonempty,
                                          cfg.connected_dists[group_id])
    lab = labels_vox[seg.seg_id.clamp(0, vcap - 1).long()]
    return torch.where(ok, lab, torch.full_like(lab, -1)).to(torch.int32), ok


def hybrid_cluster_one_group(centers, batch_idx, valid, group_id: int, cfg: FSDConfig,
                             method: str = "ccl", num_fps: int = 256, radius: float = 1.0,
                             max_batch: int = 8, batch_size: Optional[int] = None):
    """Per-group clustering by ``method``: "ccl", :func:`cluster_one_group`;
    "ssg", FPS + ball grouping per sample (samples ``0 .. batch_size - 1``,
    or ``max_batch`` when no ``batch_size`` is given; points of later
    samples get no cluster), sample b's labels offset by ``b · num_fps``.
    Returns (label [K] i32, -1 where not clustered; point_valid [K])."""
    if method == "ccl":
        return cluster_one_group(centers, batch_idx, valid, group_id, cfg)
    if batch_size is not None:
        max_batch = batch_size
    own = torch.full_like(batch_idx, -1, dtype=torch.int32)
    for b in range(max_batch):
        mine = batch_idx == b
        lab_b = ssg_cluster(centers, valid & mine, num_fps, radius)
        own = torch.where(mine, lab_b, own)
    ok = valid & (batch_idx < max_batch) & (own >= 0)
    lab = torch.where(ok, own + batch_idx * num_fps, torch.full_like(own, -1)).to(torch.int32)
    return lab, valid & (lab >= 0)


def _per_sample_slots(seg: SegmentInfo, batch_size: int, cells: int, vps: int):
    """Each sample's voxels are one contiguous run of the ascending-key slot
    table; re-slot them into ``batch_size`` runs of ``vps`` slots. Returns
    (start [B], gather_idx [B·vps], gather_valid [B·vps])."""
    vcap = seg.capacity
    slot_b = torch.where(seg.seg_valid, seg.unique_keys // cells,
                         torch.full_like(seg.unique_keys, batch_size))
    cnt_b = torch.bincount(slot_b.long(), minlength=batch_size + 1)[:batch_size]
    start = torch.cumsum(cnt_b, 0) - cnt_b
    r = torch.arange(vps, device=slot_b.device)
    gather_idx = (start[:, None] + r[None, :]).reshape(-1)
    gather_valid = (r[None, :] < cnt_b.clamp(max=vps)[:, None]).reshape(-1)
    return start, gather_idx.clamp(0, vcap - 1), gather_valid


def cluster_all_groups(centers_list, batch_list, valid_list, cfg: FSDConfig, batch_size: int = 1):
    """All groups' CCL as G·B per-sample problems of N = vcap // B nodes in
    one call (coords pre-scaled by each group's connect distance). Returns
    per-group (label [K], point_valid [K]); labels are compact within each
    (group, sample)."""
    with span("clustering"):
        vcap = cfg.caps.cluster_voxels_per_group
        vps = max(vcap // max(batch_size, 1), 1)
        pc_range = cfg.segmentor.point_cloud_range
        xys, vns, per_group = [], [], []
        for g in range(cfg.num_groups):
            seg, ok, vc, vn = _cluster_voxelize_group(
                centers_list[g], batch_list[g], valid_list[g], g, cfg)
            dims = grid_dims(cfg.cluster_voxel_sizes[g], pc_range)
            start, gidx, gok = _per_sample_slots(seg, batch_size, dims[0] * dims[1] * dims[2], vps)
            xys.append((vc[:, :2] / cfg.connected_dists[g])[gidx].reshape(batch_size, vps, 2))
            vns.append((gok & vn[gidx]).reshape(batch_size, vps))
            per_group.append((seg, ok, start))
        nprob = cfg.num_groups * batch_size
        labels = connected_components_bev_batched(
            torch.stack(xys).reshape(nprob, vps, 2),
            torch.zeros(nprob, vps, dtype=torch.int32, device=xys[0].device),
            torch.stack(vns).reshape(nprob, vps),
        ).reshape(cfg.num_groups, batch_size * vps)
        out = []
        for g in range(cfg.num_groups):
            seg, ok, start = per_group[g]
            b = batch_list[g].clamp(0, batch_size - 1).long()
            r = seg.seg_id.long() - start[b]
            ok = ok & (r >= 0) & (r < vps)
            lab = labels[g][b * vps + r.clamp(0, vps - 1)]
            out.append((torch.where(ok, lab, torch.full_like(lab, -1)).to(torch.int32), ok))
        return out


class FSDQueryBranch(nn.Module):
    """Clustering + SIR + head: segmentor output → LiDAR queries."""

    def __init__(self, cfg: FSDConfig):
        super().__init__()
        self.cfg = cfg
        seg = cfg.segmentor
        feat_dim = (seg.num_classes + 1) * 4 + seg.unet_output_channels + 3
        self.backbone = SIR(seg.point_dim, feat_dim, cfg.sir_num_blocks, cfg.sir_feat_channels,
                            cfg.sir_rel_mlp_hidden, cfg.sir_xyz_normalizer)
        self.bbox_head = SparseClusterHead(cfg.head, cfg.task_tuple(), cfg.class_names)

    def extract_foreground(self, pb: PointBatch, seg_out, batch_size: int, thresh_buffer=0.0):
        with span("foreground"):
            c = self.cfg
            data = dict(points=pb.points, logits=seg_out["seg_logits"], votes=seg_out["vote_preds"],
                        feats=seg_out["seg_feats"], offsets=seg_out["offsets"])
            pvseg, _, pv_batch, _ = voxelize_points(
                pb.xyz, pb.batch_idx, seg_out["valid"], c.pre_voxel_size,
                c.segmentor.point_cloud_range, c.caps.prevox)
            red = {k: pvseg.mean(v) for k, v in data.items()}
            fg_masks, centers = group_sample(
                red["logits"], red["offsets"], red["points"][:, :3], pvseg.seg_valid, c,
                thresh_buffer, batch_idx=pv_batch, batch_size=batch_size)

            kcap = c.caps.fg_per_group
            feats_all = torch.cat([red["logits"], red["votes"], red["feats"]], dim=1)
            g_points, g_feats, g_group, cen_list, bat_list, v_list = [], [], [], [], [], []
            for g in range(c.num_groups):
                idx, v = masked_gather(fg_masks[g], kcap)
                idx = idx.long()
                g_points.append(red["points"][idx])
                g_feats.append(feats_all[idx])
                cen_list.append(centers[g][idx])
                bat_list.append(pv_batch[idx])
                v_list.append(v)
                g_group.append(torch.full((idx.shape[0],), g, dtype=torch.int32, device=idx.device))
            clustered = cluster_all_groups(cen_list, bat_list, v_list, c, batch_size)
            labels = torch.cat([lab for lab, _ in clustered])
            fg = ForegroundSet(
                points=torch.cat(g_points), feats=torch.cat(g_feats), centers=torch.cat(cen_list),
                batch_idx=torch.cat(bat_list), group_idx=torch.cat(g_group),
                valid=torch.cat([ok for _, ok in clustered]))

            vcap = c.caps.cluster_voxels_per_group
            key = (fg.group_idx * batch_size + fg.batch_idx) * vcap + labels.clamp(min=0)
            ok = fg.valid & (labels >= 0)
            cseg = unique_segments(key, ok, c.caps.clusters)
            fg = fg._replace(valid=ok & (cseg.seg_id < c.caps.clusters))

            cluster_xyz = cseg.mean(fg.centers)
            cluster_batch = cseg.mean(fg.batch_idx.float()).to(torch.int32)
            cluster_group = cseg.mean(fg.group_idx.float()).to(torch.int32)
            return fg, cseg, cluster_xyz, cluster_batch, cluster_group, cseg.seg_valid

    def forward(self, pb: PointBatch, seg_out, batch_size: int, thresh_buffer=0.0):
        with span("lidar_queries"):
            fg, cseg, cluster_xyz, cluster_batch, cluster_group, cluster_valid = (
                self.extract_foreground(pb, seg_out, batch_size, thresh_buffer))
            sid = cseg.seg_id.clamp(0, self.cfg.caps.clusters - 1).long()
            f_cluster = fg.points[:, :3] - cluster_xyz[sid]
            _, cluster_feats = self.backbone(fg.points, fg.feats, f_cluster, cseg, fg.valid)
            outs = self.bbox_head(cluster_feats, cluster_valid)
            result = dict(
                obj_feat=cluster_feats,
                cluster_xyz=cluster_xyz,
                cluster_batch=cluster_batch,
                cluster_group=cluster_group,
                cluster_valid=cluster_valid,
                cls_logits_tasks=outs["cls_logits_tasks"],
                reg_preds_tasks=outs["reg_preds_tasks"],
                num_clusters=cluster_valid.sum(dtype=torch.int32),
                num_fg_points=fg.valid.sum(dtype=torch.int32),
            )
            if len(self.cfg.task_tuple()) == 1:
                # the one task's tensors, which FSF's fusion reads
                result["cls_logits"] = outs["cls_logits"]
                result["reg_preds"] = outs["reg_preds"]
            return result


class SingleStageFSD(nn.Module):
    """LiDAR-only fully sparse detector: ``VoteSegmentor`` → clustering +
    SIR + the task-grouped cluster head."""

    def __init__(self, cfg: FSDConfig):
        super().__init__()
        self.cfg = cfg
        self.segmentor = VoteSegmentor(cfg.segmentor, cfg.caps)
        self.query_branch = FSDQueryBranch(cfg)

    def forward(self, pb: PointBatch, batch_size: int, gt: Optional[GroundTruth] = None,
                train: Optional[bool] = None, thresh_buffer=0.0, detection_weight=1.0):
        """The JAX package's ``SingleStageFSD.__call__``. ``train`` picks the
        BN form for this call (None: the module's mode); with ``gt`` the
        result holds ``losses``: the segmentor's, and the head's per task
        (``task{t}_`` keys when there are several) with every ``loss`` term
        scaled by ``detection_weight``. ``thresh_buffer`` raises the
        foreground thresholds. Serving calls it under
        ``torch.inference_mode()``."""
        c = self.cfg
        with bn_form(self, train):
            seg_out = self.segmentor(pb, batch_size)
            result = self.query_branch(pb, seg_out, batch_size, thresh_buffer)
            result["seg_out"] = seg_out
            if gt is not None:
                losses = segmentor_loss(seg_out, *segmentor_targets(pb, gt, c.num_classes),
                                        c.segmentor)
                det = multi_task_cluster_head_loss(
                    result["cls_logits_tasks"], result["reg_preds_tasks"],
                    result["cluster_xyz"], result["cluster_batch"], result["cluster_valid"],
                    gt, c.head, c.task_tuple(), c.class_names)
                # every loss term of every task (the JAX package scales only
                # keys that start with "loss", which misses the task{t}_ ones)
                for k in det:
                    if "loss" in k:
                        det[k] = det[k] * detection_weight
                losses.update(det)
                result["losses"] = losses
        return result

    @torch.no_grad()
    def get_bboxes(self, result, batch_size: int):
        """Decode + rotated NMS: [B, max_num] for one task, else per task
        (one K3 launch each) concatenated to [B, T · max_num]."""
        c = self.cfg
        if len(c.task_tuple()) == 1:
            return cluster_head_get_bboxes(
                result["cls_logits"], result["reg_preds"], result["cluster_xyz"],
                result["cluster_batch"], result["cluster_valid"], batch_size, c.head)
        return multi_task_get_bboxes(
            result["cls_logits_tasks"], result["reg_preds_tasks"], result["cluster_xyz"],
            result["cluster_batch"], result["cluster_valid"], batch_size, c.head,
            c.task_tuple(), c.class_names)
