"""Reference-config interpreter (the port's copy of the JAX package's
``config_compat.py``).

Executes a reference-style config file (plain Python with mmcv's ``_base_``
inheritance and ``_delete_`` override, reimplemented without mmcv) and maps
the resulting ``model`` dict onto the port's own dataclasses in
``config.py``: spconv's ``encoder_paddings`` come in (z, y, x) and are
flipped to (x, y, z); the refinement's DistAssigner ``max_dist`` table is
laid out in class order.
"""
from __future__ import annotations

import copy
import os
from typing import Any, Dict, Optional

from .config import Capacities, FSDConfig, FSFConfig, HeadConfig, VoteSegmentorConfig


def _exec_config_file(path: str) -> Dict[str, Any]:
    """Execute a config ``.py`` in an isolated namespace (mmcv's
    ``Config.fromfile``), merging its ``_base_`` files first."""
    path = os.path.abspath(path)
    with open(path) as f:
        src = f.read()
    ns: Dict[str, Any] = {}
    exec(compile(src, path, "exec"), ns)
    ns = {k: v for k, v in ns.items() if not k.startswith("__")}
    base = ns.pop("_base_", None)
    if base:
        if isinstance(base, str):
            base = [base]
        merged: Dict[str, Any] = {}
        for b in base:
            merged = _merge(merged, _exec_config_file(os.path.join(os.path.dirname(path), b)))
        ns = _merge(merged, ns)
    return ns


def _merge(base: Dict, override: Dict) -> Dict:
    """``override`` merged into a copy of ``base``, dict by dict; a dict
    with ``_delete_=True`` replaces the base's instead."""
    out = copy.deepcopy(base)
    for k, v in override.items():
        if (k in out and isinstance(out[k], dict) and isinstance(v, dict)
                and not v.get("_delete_", False)):
            out[k] = _merge(out[k], v)
        else:
            v = copy.deepcopy(v)
            if isinstance(v, dict):
                v.pop("_delete_", None)
            out[k] = v
    return out


def load_reference_config(path: str) -> Dict[str, Any]:
    """mmcv-style config dict of a reference config file."""
    return _exec_config_file(path)


def _head_from_dict(d: Dict, num_classes: int) -> HeadConfig:
    coder = d.get("bbox_coder", {})
    common = d.get("common_attrs", {})
    attrs = tuple(
        (name, spec[0], spec[1], spec[2]) for name, spec in common.items()
    ) or HeadConfig().common_attrs
    loss_cls = d.get("loss_cls", {})
    test_cfg = d.get("test_cfg") or {}
    kw = dict(
        num_classes=num_classes,
        in_channel=d.get("in_channel", 768),
        shared_mlp_dims=tuple(d.get("shared_mlp_dims", (1024, 1024))),
        code_size=coder.get("code_size", 10),
        common_attrs=attrs,
        num_cls_layer=d.get("num_cls_layer", 2),
        cls_hidden_dim=d.get("cls_hidden_dim", 128),
        act=d.get("separate_head", {}).get("act", "gelu"),
        focal_gamma=loss_cls.get("gamma", 4.0),
        focal_alpha=loss_cls.get("alpha", 0.25),
        loss_cls_weight=loss_cls.get("loss_weight", 1.0),
        loss_center_weight=d.get("loss_center", {}).get("loss_weight", 0.5),
        loss_size_weight=d.get("loss_size", {}).get("loss_weight", 0.5),
        loss_rot_weight=d.get("loss_rot", {}).get("loss_weight", 0.2),
        loss_vel_weight=d.get("loss_vel", {}).get("loss_weight", 0.2),
    )
    if test_cfg:
        kw.update(
            nms_thr=test_cfg.get("nms_thr", 0.25),
            score_thr=test_cfg.get("score_thr", 0.05),
            max_num=test_cfg.get("max_num", 500),
        )
    return HeadConfig(**kw)


def interpret_fsf_config(cfg: Dict[str, Any], caps: Optional[Capacities] = None) -> FSFConfig:
    """Reference config dict (from :func:`load_reference_config`) →
    ``FSFConfig``."""
    m = cfg["model"]
    if m.get("type") != "FSF":
        raise ValueError(f"expected an FSF model config, got {m.get('type')!r}")
    seg = m["segmentor"]
    class_names = tuple(cfg["class_names"])
    num_classes = len(class_names)
    vl = seg["voxel_layer"]
    backbone = seg["backbone"]
    enc_channels = backbone.get("encoder_channels")

    # spconv encoder_paddings come in (z, y, x); a stage's strided padding is
    # its first conv's, for stages 1 on
    strided = []
    for stage in (backbone.get("encoder_paddings") or ())[1:]:
        p = stage[0]
        strided.append((p[2], p[1], p[0]) if isinstance(p, (tuple, list)) else (p, p, p))
    seg_cfg = VoteSegmentorConfig(
        num_classes=num_classes,
        point_dim=seg["voxel_encoder"].get("in_channels", 5),
        voxel_size=tuple(vl["voxel_size"]),
        point_cloud_range=tuple(vl["point_cloud_range"]),
        vfe_channels=tuple(seg["voxel_encoder"].get("feat_channels", (64, 64))),
        unet_base_channels=backbone.get("base_channels", 64),
        unet_output_channels=backbone.get("output_channels", 128),
        unet_encoder_channels=tuple(tuple(s) for s in enc_channels),
        unet_decoder_channels=tuple(
            tuple(s) for s in backbone.get("decoder_channels"))[: len(enc_channels) - 1],
        unet_strided_paddings=tuple(strided),
        unet_capacity_divisors=tuple(
            [1] + [2 ** max(i - 1, 0) for i in range(1, len(enc_channels))]),
        head_hidden_dims=tuple(seg["segmentation_head"].get("hidden_dims", (128, 128))),
        seg_loss_weight=seg["segmentation_head"]["loss_decode"].get("loss_weight", 10.0),
        bg_class_weight=seg["segmentation_head"]["loss_decode"].get(
            "class_weight", [1.0] * num_classes + [0.1])[-1],
    )
    train_cfg = m.get("train_cfg") or {}
    ca = m["cluster_assigner"]
    sir = m["backbone"]
    # CenterPoint-style task groups: one task of every class is the
    # canonical single-task form
    tasks = tuple(tuple(t["class_names"]) for t in m["bbox_head"].get("tasks") or []) or None
    if tasks and len(tasks) == 1 and tasks[0] == class_names:
        tasks = None
    fsd = FSDConfig(
        class_names=class_names,
        tasks=tasks,
        group_names=tuple(tuple(g) for g in train_cfg.get("group_names", ())),
        segmentor=seg_cfg,
        head=_head_from_dict({**m["bbox_head"], "test_cfg": m.get("test_cfg")}, num_classes),
        score_thresh=tuple(train_cfg.get("score_thresh", (0.1,) * 6)),
        pre_voxel_size=tuple(train_cfg.get("pre_voxelization_size", (0.1, 0.1, 0.1))),
        cluster_voxel_sizes=tuple(tuple(v) for v in ca["cluster_voxel_size"]),
        connected_dists=tuple(ca["connected_dist"]),
        min_cluster_points=ca.get("min_points", 2),
        sir_num_blocks=sir.get("num_blocks", 3),
        sir_feat_channels=tuple(tuple(fc) for fc in sir.get("feat_channels")),
        sir_rel_mlp_hidden=tuple(tuple(r) for r in sir.get("rel_mlp_hidden_dims")),
        sir_xyz_normalizer=tuple(sir.get("xyz_normalizer", (20, 20, 4))),
        caps=caps or Capacities(),
    )
    refined_list = m.get("refined_obj_head", [])
    refined = refined_list[0] if refined_list else {}
    max_dist = None
    ad = refined.get("assigner", {}).get("assigner_dist") if refined else None
    if ad:
        order = {n: i for i, n in enumerate(class_names)}
        md = [0.0] * num_classes
        for task, dists in zip(ad["assign_tasks"], ad["max_dist"]):
            for n, dv in zip(task["class_names"], dists):
                md[order[n]] = dv
        max_dist = tuple(md)
    mlp_cfg = m.get("mlp_cfg", {})
    return FSFConfig(
        fsd=fsd,
        num_cams=m.get("num_cams", 6),
        frustum_head=_head_from_dict(m["frustum_obj_head"], num_classes),
        refined_head=_head_from_dict(refined or m["frustum_obj_head"], num_classes),
        embed_dims=mlp_cfg.get("embed_dims", 1024),
        extra_wlh=tuple(m.get("roi_extractor", {}).get("extra_wlh", (1, 1, 1))),
        refine_img_mlp_dims=tuple(
            m.get("refine_encode_2d_mlp_cfg", {}).get("mlp_channel", (32, 32))),
        num_refine_stages=len(refined_list) or 1,
        refine_max_dist=max_dist or (1.0,) * num_classes,
    )


def load_fsf_config(path: str, caps: Optional[Capacities] = None) -> FSFConfig:
    """Reference config file → ``FSFConfig`` in one call."""
    return interpret_fsf_config(load_reference_config(path), caps)
