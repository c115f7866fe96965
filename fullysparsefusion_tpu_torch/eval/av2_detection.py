"""Argoverse 2 detection metrics (AP / ATE / ASE / AOE / CDS): the port's
copy of the JAX package's ``eval/av2_detection.py``, NumPy only.

The reference evaluates AV2 through ``av2.evaluation.detection``
(argo2_dataset.py:429-511); that package isn't available here, so this
module implements the published protocol:

  * matching: per class, predictions sorted by score greedily match the
    nearest unmatched GT by 3-D EUCLIDEAN center distance under thresholds
    {0.5, 1, 2, 4} m (av2 ``affinity_thresholds_m``);
  * range gate: boxes beyond ``max_range_m`` (150 m) from the ego origin are
    dropped (the av2 ROI/map gate needs HD maps and is not applied — noted);
  * AP: 101-point interpolated precision (av2 integrates the raw
    interpolated curve without nuScenes' 0.1 clipping);
  * TP errors at the 2 m threshold: ATE (3-D translation), ASE
    (1 − aligned 3-D IoU), AOE (yaw difference wrapped to [0, π]);
  * per-class CDS = AP · mean(1 − err/norm) with norms
    (ATE 2 m, ASE 1, AOE π) — av2 ``DetectionCfg`` defaults; the headline
    CDS is the class mean.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from .detection import DetectionRecord, _aligned_iou_3d

AFFINITY_THRESHOLDS_M = (0.5, 1.0, 2.0, 4.0)
TP_THRESHOLD_M = 2.0
MAX_RANGE_M = 150.0
TP_NORMS = {"ate": 2.0, "ase": 1.0, "aoe": np.pi}


def _wrap_pi(x: float) -> float:
    d = abs(x) % (2 * np.pi)
    return min(d, 2 * np.pi - d)


def _accumulate(records: Sequence[DetectionRecord], cls: int, th: float):
    preds = []
    n_gt = 0
    gts, gidxs = [], []
    for si, r in enumerate(records):
        m = r.labels == cls
        for b, s in zip(r.boxes[m], r.scores[m]):
            if np.linalg.norm(b[:3]) <= MAX_RANGE_M:
                preds.append((float(s), si, b))
        gm = r.gt_labels == cls
        gt = r.gt_boxes[gm]
        ok = (np.linalg.norm(gt[:, :3], axis=1) <= MAX_RANGE_M
              if len(gt) else np.zeros(0, bool))
        gts.append(gt[ok])
        gidxs.append(np.where(gm)[0][ok])
        n_gt += int(ok.sum())
    if n_gt == 0:
        return None
    if not preds:
        return 0.0, {"ate": [], "ase": [], "aoe": []}
    preds.sort(key=lambda x: -x[0])
    taken = [set() for _ in records]
    tp, fp = [], []
    errs = {"ate": [], "ase": [], "aoe": []}
    for score, si, box in preds:
        gt, gidx = gts[si], gidxs[si]
        best, best_d = -1, th
        for j in range(len(gt)):
            if gidx[j] in taken[si]:
                continue
            d = float(np.linalg.norm(box[:3] - gt[j, :3]))
            if d < best_d:
                best, best_d = j, d
        if best >= 0:
            taken[si].add(gidx[best])
            tp.append(1.0)
            fp.append(0.0)
            g = gt[best]
            errs["ate"].append(best_d)
            errs["ase"].append(1.0 - _aligned_iou_3d(box, g))
            errs["aoe"].append(_wrap_pi(float(box[6]) - float(g[6])))
        else:
            tp.append(0.0)
            fp.append(1.0)
    tp = np.cumsum(tp)
    fp = np.cumsum(fp)
    recall = tp / n_gt
    precision = tp / np.maximum(tp + fp, 1e-9)
    rec_interp = np.linspace(0, 1, 101)
    prec_at = np.interp(rec_interp, recall, precision, right=0)
    ap = float(np.mean(prec_at))
    return ap, errs


def evaluate_av2(
    records: Sequence[DetectionRecord],
    num_classes: int,
    class_names: Optional[Sequence[str]] = None,
) -> Dict:
    """AV2 protocol: per-class AP (4 thresholds), TP errors at 2 m, CDS."""
    class_names = class_names or [str(i) for i in range(num_classes)]
    per_class = {}
    for c in range(num_classes):
        aps, tp_errs = {}, None
        for th in AFFINITY_THRESHOLDS_M:
            out = _accumulate(records, c, th)
            if out is None:
                continue
            ap, errs = out
            aps[th] = ap
            if th == TP_THRESHOLD_M:
                tp_errs = {
                    k: (float(np.mean(v)) if v else TP_NORMS[k])
                    for k, v in errs.items()
                }
        if not aps:
            continue
        ap_mean = float(np.mean(list(aps.values())))
        tp_errs = tp_errs or {k: TP_NORMS[k] for k in TP_NORMS}
        cds = ap_mean * float(np.mean(
            [1.0 - min(tp_errs[k] / TP_NORMS[k], 1.0) for k in TP_NORMS]
        ))
        # full precision — golden-vector tests assert these at 1e-6
        per_class[class_names[c]] = dict(
            AP=ap_mean, CDS=cds,
            **{k.upper(): float(v) for k, v in tp_errs.items()},
        )
    if not per_class:
        return {"mAP": 0.0, "CDS": 0.0, "per_class": {}}
    return {
        "mAP": float(np.mean([v["AP"] for v in per_class.values()])),
        "CDS": float(np.mean([v["CDS"] for v in per_class.values()])),
        "per_class": per_class,
    }
