"""HTC activation parity, the port's side (port of ``utils/htc_parity.py``).

:func:`dump_torch_activations` gives the port's HTC activations under the
JAX package's keys and layouts (``ACTIVATION_ORDER``, NHWC): the
image-level taps (backbone C2–C5, FPN P2–P6, RPN outputs per level, the
semantic head) and, on a FIXED RoI set, the cascade's bbox and mask stages
(so that discrete proposal selection cannot bury a head's difference).
:func:`compare_activations` lists the taps in that order, so the first row
that is not ok names the earliest module that diverges.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.htc import delta_decode

# canonical tap order, earliest module first
ACTIVATION_ORDER: Tuple[str, ...] = (
    "backbone.c2", "backbone.c3", "backbone.c4", "backbone.c5",
    "fpn.p2", "fpn.p3", "fpn.p4", "fpn.p5", "fpn.p6",
    "rpn.cls.l0", "rpn.cls.l1", "rpn.cls.l2", "rpn.cls.l3", "rpn.cls.l4",
    "rpn.reg.l0", "rpn.reg.l1", "rpn.reg.l2", "rpn.reg.l3", "rpn.reg.l4",
    "semantic.logits", "semantic.embed",
    "roi.bbox_feats0", "bbox_head0.cls", "bbox_head0.reg", "bbox_head0.rois",
    "roi.bbox_feats1", "bbox_head1.cls", "bbox_head1.reg", "bbox_head1.rois",
    "roi.bbox_feats2", "bbox_head2.cls", "bbox_head2.reg", "bbox_head2.rois",
    "roi.mask_feats",
    "mask_head0.logits", "mask_head1.logits", "mask_head2.logits",
)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).float().cpu().numpy()


@torch.inference_mode()
def dump_torch_activations(model, images: torch.Tensor,
                           rois: Optional[torch.Tensor] = None) -> Dict[str, np.ndarray]:
    """The port's HTC activation dict. ``images`` [1, H, W, 3] RGB 0–255;
    ``rois`` [P, 4] xyxy image px on the model's device (without them only
    the image-level taps)."""
    cs = model.backbone(model.normalize(images))
    pyramid = model.neck(cs)
    cls_lvls, reg_lvls = model.rpn_head(pyramid)
    sem_logits, sem_embed = model.semantic_head(pyramid)
    acts: Dict[str, np.ndarray] = {}
    for i, c in enumerate(cs):
        acts[f"backbone.c{i + 2}"] = _nhwc(c)
    for i, p in enumerate(pyramid):
        acts[f"fpn.p{i + 2}"] = _nhwc(p)
    for i, (c, r) in enumerate(zip(cls_lvls, reg_lvls)):
        acts[f"rpn.cls.l{i}"] = _nhwc(c)
        acts[f"rpn.reg.l{i}"] = _nhwc(r)
    acts["semantic.logits"] = _nhwc(sem_logits)
    acts["semantic.embed"] = _nhwc(sem_embed)
    if rois is None:
        return acts
    ih, iw = images.shape[1:3]
    pyr0 = [p[0].permute(1, 2, 0) for p in pyramid]
    sem0 = sem_embed[0].permute(1, 2, 0)
    valid = torch.ones(rois.shape[0], dtype=torch.bool, device=rois.device)
    taps = {}
    r = rois
    for si in range(3):
        feats = model.roi_feats(pyr0, sem0, r, valid, 7)
        taps[f"roi.bbox_feats{si}"] = feats
        cls, reg = model.bbox_head(si)(feats)
        taps[f"bbox_head{si}.cls"], taps[f"bbox_head{si}.reg"] = cls, reg
        r = delta_decode(r, reg, model.stage_stds[si], (ih, iw))
        taps[f"bbox_head{si}.rois"] = r
    mfeats = model.roi_feats(pyr0, sem0, rois, valid, 14)
    taps["roi.mask_feats"] = mfeats
    acts.update({k: v.float().cpu().numpy() for k, v in taps.items()})
    for si, lg in enumerate(model.mask_logits(mfeats)):
        acts[f"mask_head{si}.logits"] = _nhwc(lg)
    return acts


def compare_activations(ref: Dict[str, np.ndarray], ours: Dict[str, np.ndarray],
                        atol: float = 1e-3, rtol: float = 1e-3) -> List[Dict]:
    """Ordered per-module report. Each row: name, shapes, max_abs, max_rel,
    ok. Rows appear in ``ACTIVATION_ORDER`` so the first not-ok row is the
    earliest divergent module; keys present on only one side report
    ok=False with max_abs=None (a naming-contract violation)."""
    keys = [k for k in ACTIVATION_ORDER if k in ref or k in ours]
    keys += sorted((set(ref) | set(ours)) - set(keys))  # unexpected extras
    rows = []
    for k in keys:
        a, b = ref.get(k), ours.get(k)
        if a is None or b is None or tuple(a.shape) != tuple(b.shape):
            rows.append(dict(name=k, shape_ref=None if a is None else a.shape,
                             shape_ours=None if b is None else b.shape,
                             max_abs=None, max_rel=None, ok=False))
            continue
        a64 = a.astype(np.float64)
        diff = np.abs(a64 - b.astype(np.float64))
        max_abs = float(diff.max()) if diff.size else 0.0
        max_rel = float((diff / np.maximum(np.abs(a64), 1e-12)).max()) if diff.size else 0.0
        ok = bool(np.all(diff <= atol + rtol * np.abs(a64)))
        rows.append(dict(name=k, shape_ref=a.shape, shape_ours=b.shape,
                         max_abs=max_abs, max_rel=max_rel, ok=ok))
    return rows


def first_divergent(rows: List[Dict]) -> Optional[str]:
    for r in rows:
        if not r["ok"]:
            return r["name"]
    return None


def save_activations(acts: Dict[str, np.ndarray], path: str) -> None:
    """Taps to a compressed ``.npz`` under their keys, as the JAX package
    saves them, so either package reads the other's dump."""
    np.savez_compressed(path, **acts)


def load_activations(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
