"""FSF — the LiDAR + camera fusion detector (port of ``models/fsf.py``).

① segmentor core → image-feature enhancement (best-camera 2D class scores
through a zero-init MLP added to the point features) → vote-seg head;
② camera queries from mask-grouped frustums; ③ LiDAR queries from the FSD
clustering branch; ④ fusion of both query sets; ⑤ cascade refinement (RoI
point pooling → RoI SIR → residual query update → refined head); then
decode with rotated NMS (:meth:`FSF.get_bboxes`). Given ground truth, the
forward also returns the training losses (:meth:`FSF._losses`); its BN
layers take their train form in ``model.train()`` mode.

Points carry their pre-augmentation xyz in the last 3 channels; projection
into the cameras uses those.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..config import FSFConfig
from ..core.assigners import hybrid_assign
from ..core.coders import BasePointBBoxCoder
from ..utils.containers import GroundTruth, PointBatch
from ..utils.profiling import span
from .camera import CameraData, FrustumBranch, gather_point_instances, per_point_class_scores
from .fsd import FSDQueryBranch
from .heads import SparseClusterHead, cluster_head_get_bboxes, cluster_head_loss
from .layers import MLP, LayerNorm, bn_form, get_activation
from .roi import FullySparseBboxHead, extract_roi_points_grid
from .segmentor import SegmentorCore, VoteSegHead, segmentor_loss, segmentor_targets


class ZeroInitMLP(nn.Module):
    """MLP whose final biased layer starts at zero (the enhancement starts
    as the identity)."""

    def __init__(self, in_dim: int, hidden_dims, act: str = "gelu"):
        super().__init__()
        dims = tuple(hidden_dims)
        self.n = len(dims)
        self.act = get_activation(act)
        d = in_dim
        for i, c in enumerate(dims[:-1]):
            setattr(self, f"Dense_{i}", nn.Linear(d, c, bias=False))
            setattr(self, f"LayerNorm_{i}", LayerNorm(c, 1e-3))
            d = c
        setattr(self, f"Dense_{self.n - 1}", nn.Linear(d, dims[-1], bias=True))

    def forward(self, x):
        for i in range(self.n - 1):
            x = self.act(getattr(self, f"LayerNorm_{i}")(getattr(self, f"Dense_{i}")(x)))
        return getattr(self, f"Dense_{self.n - 1}")(x)


class FSF(nn.Module):
    def __init__(self, cfg: FSFConfig):
        super().__init__()
        c = cfg
        f = c.fsd
        if f.tasks and len(f.tasks) > 1:
            raise ValueError("FSF fuses single-task FSD queries")
        self.cfg = cfg
        seg_cfg = f.segmentor
        self.seg_core = SegmentorCore(seg_cfg, f.caps)
        seg_feat_dim = self.seg_core.feat_dim
        self.seg_enhance_mlp = ZeroInitMLP(f.num_classes,
                                           (seg_cfg.head_hidden_dims[-1], seg_feat_dim))
        self.seg_head = VoteSegHead(seg_cfg, seg_feat_dim)
        self.frustum = FrustumBranch(
            seg_cfg.point_dim, seg_feat_dim,
            sir_num_blocks=f.sir_num_blocks, sir_feat_channels=f.sir_feat_channels,
            sir_rel_mlp_hidden=f.sir_rel_mlp_hidden, sir_xyz_normalizer=f.sir_xyz_normalizer,
            encode_2d_dims=c.encode_2d_dims, num_classes=f.num_classes, overlap_k=c.overlap_k,
            frustum_points=f.caps.frustum_points, frustum_objects=f.caps.frustum_objects)
        self.frustum_head = SparseClusterHead(c.frustum_head, (f.class_names,), f.class_names)
        self.fsd_branch = FSDQueryBranch(f)
        self.combine_frustum_mlp = MLP(self.frustum.out_dim, (c.embed_dims,), norm="ln", act="gelu")
        self.combine_fsd_mlp = MLP(self.fsd_branch.backbone.out_dim, (c.embed_dims,),
                                   norm="ln", act="gelu")
        for i in range(c.num_refine_stages):
            img_mlp = MLP(f.num_classes, c.refine_img_mlp_dims, norm="ln", act="gelu")
            sir = FullySparseBboxHead(
                seg_cfg.point_dim, seg_feat_dim + img_mlp.out_dim,
                feat_channels=f.sir_feat_channels, rel_mlp_hidden=f.sir_rel_mlp_hidden,
                xyz_normalizer=f.sir_xyz_normalizer)
            setattr(self, f"refine_img_mlp_{i}", img_mlp)
            setattr(self, f"refine_sir_{i}", sir)
            setattr(self, f"lidar_img_mlp_{i}", MLP(sir.out_dim, (c.embed_dims, c.embed_dims),
                                                    norm="ln", act="gelu"))
            setattr(self, f"position_encoder_{i}", MLP(3, (c.embed_dims, c.embed_dims),
                                                       norm="ln", act="gelu"))
            setattr(self, f"out_proj_{i}", MLP(c.embed_dims, (c.embed_dims, c.embed_dims),
                                               norm="ln", act="gelu", is_head=True))
            setattr(self, f"refined_head_{i}", SparseClusterHead(c.refined_head, (f.class_names,),
                                                                 f.class_names))
        self.coder = BasePointBBoxCoder(f.head.code_size)

    def forward(self, pb: PointBatch, cam: CameraData, batch_size: int,
                gt: Optional[GroundTruth] = None, no_aug_gt: Optional[GroundTruth] = None,
                train: Optional[bool] = None, thresh_buffer=0.0, detection_weight=1.0) -> Dict:
        """The JAX package's ``FSF.__call__``. ``train`` picks the BN form for
        this call (None: the module's mode); with ``gt`` the result holds
        ``losses``, the detection terms scaled by ``detection_weight``;
        ``thresh_buffer`` raises the foreground thresholds of the LiDAR
        branch. Serving calls it under ``torch.inference_mode()``."""
        with bn_form(self, train):
            result = self._forward(pb, cam, batch_size, thresh_buffer)
            if gt is not None:
                pb_inner = PointBatch(points=pb.points[:, :-3], batch_idx=pb.batch_idx,
                                      valid=pb.valid)
                with span("losses"):
                    losses = self._losses(pb_inner, cam, gt, no_aug_gt, result)
                for k in list(losses):
                    if k.startswith(("frustum_loss", "fsd_loss", "stage")) and "loss" in k:
                        losses[k] = losses[k] * detection_weight
                result["losses"] = losses
        return result

    def _forward(self, pb: PointBatch, cam: CameraData, batch_size: int, thresh_buffer):
        c = self.cfg
        f = c.fsd
        points = pb.points[:, :-3]
        noaug_xyz = pb.points[:, -3:]
        pb_inner = PointBatch(points=points, batch_idx=pb.batch_idx, valid=pb.valid)

        # ① segmentation with image enhancement
        seg_feats, pt_valid = self.seg_core(pb_inner, batch_size)
        with span("seg_head"):
            obj_ids, obj_scores = gather_point_instances(noaug_xyz, pb.batch_idx, pt_valid, cam)
            cls_scores_2d = per_point_class_scores(obj_ids, obj_scores)
            seg_feats = seg_feats + self.seg_enhance_mlp(cls_scores_2d)
            seg_feats = seg_feats * pt_valid[:, None].to(seg_feats.dtype)
            seg_out = self.seg_head(seg_feats, pt_valid)

        # ② camera queries
        with span("camera_queries"):
            fr = self.frustum(points, seg_feats, seg_out["seg_logits"], obj_ids, pb.batch_idx,
                              cam)
            fr_out = self.frustum_head(fr["obj_feat"], fr["obj_valid"])

        # ③ LiDAR queries
        fsd = self.fsd_branch(pb_inner, seg_out, batch_size, thresh_buffer)

        # ④ fusion
        with span("fusion"):
            centers = torch.cat([fr["obj_centers"], fsd["cluster_xyz"]])
            q_batch = torch.cat([fr["obj_batch"], fsd["cluster_batch"]])
            q_valid = torch.cat([fr["obj_valid"], fsd["cluster_valid"]])
            cls_logits = torch.cat([fr_out["cls_logits"], fsd["cls_logits"]])
            reg_preds = torch.cat([fr_out["reg_preds"], fsd["reg_preds"]])
            n_fr = fr["obj_feat"].shape[0]
            res_query = torch.cat([
                self.combine_frustum_mlp(fr["obj_feat"], q_valid[:n_fr]),
                self.combine_fsd_mlp(fsd["obj_feat"], fsd["cluster_valid"]),
            ])
        result = dict(
            seg_out=seg_out,
            frustum=dict(out=fr_out, **{k: v for k, v in fr.items() if k != "obj_feat"}),
            fsd=fsd,
            stages=[],
        )

        # ⑤ cascade refinement
        with span("refine"):
            pcr = f.segmentor.point_cloud_range
            for i in range(c.num_refine_stages):
                boxes = self.coder.decode(reg_preds, centers).detach()
                new_centers = boxes[:, :3]
                with span("roi_points"):
                    rp = extract_roi_points_grid(
                        points[:, :3], pb.batch_idx, pt_valid, boxes[:, :7], q_batch, q_valid,
                        c.extra_wlh, f.caps.roi_points, c.rois_per_point,
                        batch_size=batch_size, bev_lo=(pcr[0], pcr[1]), bev_hi=(pcr[3], pcr[4]))
                pidx = rp.point_idx.long()
                sel_img = getattr(self, f"refine_img_mlp_{i}")(cls_scores_2d[pidx], rp.valid)
                feats_in = torch.cat([seg_feats[pidx], sel_img], dim=1)
                roi_feats, _ = getattr(self, f"refine_sir_{i}")(
                    points[pidx], feats_in, rp.geometry, rp.roi_idx, rp.valid, centers.shape[0])
                cur = getattr(self, f"lidar_img_mlp_{i}")(roi_feats, q_valid)
                pos = getattr(self, f"position_encoder_{i}")(new_centers.detach(), q_valid)
                query = getattr(self, f"out_proj_{i}")(cur + res_query + pos, q_valid)
                head_out = getattr(self, f"refined_head_{i}")(query, q_valid)
                centers = new_centers
                cls_logits = head_out["cls_logits"]
                reg_preds = head_out["reg_preds"]
                res_query = query
                result["stages"].append(dict(centers=centers, cls_logits=cls_logits,
                                             reg_preds=reg_preds))
        result["final"] = dict(centers=centers, cls_logits=cls_logits, reg_preds=reg_preds,
                               q_batch=q_batch, q_valid=q_valid)
        return result

    def _losses(self, pb_inner: PointBatch, cam: CameraData, gt: GroundTruth,
                 no_aug_gt: Optional[GroundTruth], result) -> Dict[str, torch.Tensor]:
        """Segmentor loss; the camera-query head's against the hybrid
        assignment (3D point-in-box ∪ 2D max-IoU on the projected no-aug
        GT); the LiDAR-query head's by cluster-center-in-box; each refinement
        stage's against the hybrid assignment with the distance assigner."""
        c = self.cfg
        f = c.fsd
        no_aug_gt = gt if no_aug_gt is None else no_aug_gt
        seg_out, fr, fsd = result["seg_out"], result["frustum"], result["fsd"]
        losses = segmentor_loss(seg_out, *segmentor_targets(pb_inner, gt, f.num_classes),
                                f.segmentor)
        fr_assign = hybrid_assign(fr["obj_centers"], fr["obj_batch"], fr["obj_valid"],
                                  fr["preds_2d"], gt, no_aug_gt, cam.lidar2img, cam.img_w,
                                  cam.img_h)
        losses.update(cluster_head_loss(
            fr["out"]["cls_logits"], fr["out"]["reg_preds"], fr["obj_centers"], fr["obj_batch"],
            fr["obj_valid"], gt, c.frustum_head, assign=fr_assign, prefix="frustum_"))
        losses.update(cluster_head_loss(
            fsd["cls_logits"], fsd["reg_preds"], fsd["cluster_xyz"], fsd["cluster_batch"],
            fsd["cluster_valid"], gt, f.head, prefix="fsd_"))
        fin = result["final"]
        preds_2d_all = torch.cat([fr["preds_2d"],
                                  fr["preds_2d"].new_zeros(f.caps.clusters,
                                                           fr["preds_2d"].shape[1])])
        for i, st in enumerate(result["stages"]):
            st_assign = hybrid_assign(st["centers"], fin["q_batch"], fin["q_valid"], preds_2d_all,
                                      gt, no_aug_gt, cam.lidar2img, cam.img_w, cam.img_h,
                                      query_logits=st["cls_logits"],
                                      max_dist_per_class=c.refine_max_dist)
            losses.update(cluster_head_loss(
                st["cls_logits"], st["reg_preds"], st["centers"], fin["q_batch"], fin["q_valid"],
                gt, c.refined_head, assign=st_assign, prefix=f"stage{i}_"))
        return losses

    @torch.no_grad()
    def get_bboxes(self, result, batch_size: int):
        fin = result["final"]
        with span("decode"):
            return cluster_head_get_bboxes(
                fin["cls_logits"], fin["reg_preds"], fin["centers"], fin["q_batch"],
                fin["q_valid"], batch_size, self.cfg.refined_head)
