"""Self-contained nuScenes-protocol detection metrics (the port's copy of
the JAX package's ``eval/detection.py``, NumPy only: the same records give
the same metrics).

The reference delegates evaluation to the nuScenes devkit / av2 API
(argo2_dataset.py:429-511); neither ships in this environment, so the
framework carries its own implementation of the published protocol,
transcribed from nuscenes-devkit ``eval/detection/algo.py`` +
``eval/detection/evaluate.py`` + ``eval/common/utils.py`` semantics:

  * per-class range filtering: GT and predictions beyond the class's ego
    range (50 m vehicles / 40 m pedestrian+bikes / 30 m cone+barrier) are
    dropped before matching (devkit ``filter_eval_boxes``);
  * matching (devkit ``accumulate``): per class, predictions sorted by
    score greedily match the nearest unmatched GT by BEV *center distance*
    under thresholds {0.5, 1, 2, 4} m — not IoU;
  * 101-point resampling: precision, confidence, and the cumulative-mean
    (``cummean``, NaN-aware) TP errors are interpolated onto
    ``rec_interp = linspace(0, 1, 101)``; the error curves are resampled
    BY CONFIDENCE (``np.interp(conf[::-1], match_conf[::-1],
    cummean[::-1])[::-1]``), exactly as the devkit does — interpolating
    them on the recall axis directly is a protocol drift this module
    previously carried (fixed round 4);
  * AP (devkit ``calc_ap``): ``mean(clip(prec[11:] − 0.1, 0)) / 0.9`` —
    note the ``round(100·min_recall) + 1`` start index: the recall=0.10
    bin itself is EXCLUDED ("+1 to exclude the min recall bin"), i.e. 90
    bins, not 91;
  * TP metrics at the 2.0 m threshold (devkit ``calc_tp``): mean of the
    resampled error curve over bins ``[11, max_recall_ind]`` where
    ``max_recall_ind`` is the last bin with nonzero interpolated
    confidence; 1.0 when ``max_recall_ind < 11``. ATE (BEV translation),
    ASE (1 − aligned 3D IoU), AOE (yaw diff; period π for barrier; NaN
    for traffic_cone), AVE (velocity L2; NaN for cone+barrier), AAE
    (1 − attribute accuracy; NaN for cone+barrier);
  * NDS (devkit ``DetectionMetrics.nd_score``):
    ``(5·mAP + Σ_m clip(1 − tp_err[m], 0, 1)) / (5 + n_metrics)`` with
    NO normalizers — the error enters as ``1 − min(1, err)`` per the
    nuScenes paper/devkit, and ``tp_err[m]`` is the ``nanmean`` over
    classes.

Documented deviations (only reachable on data the devkit never sees):
  * classes with zero in-range GT are skipped from mAP / the TP nanmeans
    (the devkit's val split always contains all 10 classes; on synthetic
    subsets skipping keeps the numbers meaningful);
  * a TP metric whose value is NaN for EVERY class (velocity-less boxes,
    attribute-less records — real nuScenes data always has both) is
    dropped from the NDS numerator AND denominator instead of poisoning
    the composite with NaN.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

DIST_THRESHOLDS = (0.5, 1.0, 2.0, 4.0)
TP_THRESHOLD = 2.0
MIN_RECALL = 0.1
MIN_PRECISION = 0.1
NELEM = 101                      # devkit DetectionMetricData.nelem
TP_METRICS = ("ate", "ase", "aoe", "ave", "aae")

# devkit attribute vocabulary; ids index this tuple
ATTRIBUTES = (
    "cycle.with_rider", "cycle.without_rider", "pedestrian.moving",
    "pedestrian.standing", "pedestrian.sitting_lying_down",
    "vehicle.moving", "vehicle.parked", "vehicle.stopped",
)
ATTR_ID = {n: i for i, n in enumerate(ATTRIBUTES)}
# classes with no attributes (devkit skips AAE for them)
NO_ATTR_CLASSES = ("traffic_cone", "barrier")
# mmdet3d NuScenesDataset.DefaultAttribute
DEFAULT_ATTR = {
    "car": "vehicle.parked", "pedestrian": "pedestrian.moving",
    "trailer": "vehicle.parked", "truck": "vehicle.parked",
    "bus": "vehicle.moving", "motorcycle": "cycle.without_rider",
    "construction_vehicle": "vehicle.parked",
    "bicycle": "cycle.without_rider",
}
_VEHICLES = ("car", "construction_vehicle", "bus", "truck", "trailer")


def default_attributes(
    boxes: np.ndarray, labels: np.ndarray, class_names: Sequence[str],
    speed_thresh: float = 0.2,
) -> np.ndarray:
    """mmdet3d ``_format_bbox`` attribute heuristic → attr ids (−1 = none).

    Moving vehicles (BEV speed > 0.2 m/s) → 'vehicle.moving'; moving
    cycles → 'cycle.with_rider'; otherwise the class default.
    """
    out = np.full(len(labels), -1, np.int32)
    speed = (np.hypot(boxes[:, 7], boxes[:, 8])
             if boxes.shape[1] >= 9 else np.zeros(len(labels)))
    for i, (l, s) in enumerate(zip(labels, speed)):
        name = class_names[int(l)] if 0 <= int(l) < len(class_names) else ""
        if name in NO_ATTR_CLASSES or name not in DEFAULT_ATTR:
            continue
        if s > speed_thresh:
            attr = ("vehicle.moving" if name in _VEHICLES
                    else "cycle.with_rider" if name in ("bicycle", "motorcycle")
                    else DEFAULT_ATTR[name])
        else:
            attr = DEFAULT_ATTR[name]
        out[i] = ATTR_ID[attr]
    return out


# devkit class_range (eval/detection/configs/detection_cvpr_2019.json)
CLASS_RANGES = {
    "car": 50.0, "truck": 50.0, "bus": 50.0, "trailer": 50.0,
    "construction_vehicle": 50.0, "pedestrian": 40.0, "motorcycle": 40.0,
    "bicycle": 40.0, "traffic_cone": 30.0, "barrier": 30.0,
}
DEFAULT_RANGE = 50.0


@dataclass
class DetectionRecord:
    """One sample's detections + ground truth (arrays, box layout [x,y,z_b,
    dx,dy,dz,yaw(,vx,vy)], ego at the origin of the frame)."""

    boxes: np.ndarray
    scores: np.ndarray
    labels: np.ndarray
    gt_boxes: np.ndarray
    gt_labels: np.ndarray
    # optional attribute ids (index into ATTRIBUTES, −1 = none); AAE joins
    # the TP metrics only when both sides are present
    attrs: Optional[np.ndarray] = None
    gt_attrs: Optional[np.ndarray] = None


def _aligned_iou_3d(a: np.ndarray, b: np.ndarray) -> float:
    """IoU of two boxes after aligning centers and yaw (nuScenes ASE,
    devkit ``scale_iou``)."""
    inter = np.prod(np.minimum(a[3:6], b[3:6]))
    union = np.prod(a[3:6]) + np.prod(b[3:6]) - inter
    return float(inter / max(union, 1e-9))


def _yaw_diff(a: float, b: float, period: float = 2 * np.pi) -> float:
    d = abs(a - b) % period
    return min(d, period - d)


def cummean(x: np.ndarray) -> np.ndarray:
    """NaN-sensitive cumulative mean (devkit ``eval/common/utils.cummean``):
    NaN entries contribute nothing; prefixes whose every entry is NaN
    give 0."""
    x = np.asarray(x, np.float64)
    sum_vals = np.nancumsum(x)
    count_vals = np.cumsum(~np.isnan(x))
    return np.divide(sum_vals, count_vals,
                     out=np.zeros_like(sum_vals), where=count_vals != 0)


def _accumulate_class(
    records: Sequence[DetectionRecord], cls: int, dist_th: float,
    class_name: str = "",
):
    """Greedy score-ordered matching + 101-bin resampling for one
    (class, threshold) — devkit ``accumulate``.

    Returns (precision [101], confidence [101], md {metric: [101]}) or
    None when the class has no GT in range. With no matches at all,
    mirrors devkit ``DetectionMetricData.no_predictions`` (zero precision
    / confidence, unit errors).
    """
    max_range = CLASS_RANGES.get(class_name, DEFAULT_RANGE)
    preds = []  # (score, sample_idx, box, pred attr id)
    n_gt = 0
    gts, gidxs, gattrs = [], [], []
    for si, r in enumerate(records):
        m = r.labels == cls
        pa = (r.attrs[m] if r.attrs is not None
              else np.full(int(m.sum()), -1, np.int32))
        for b, s, a in zip(r.boxes[m], r.scores[m], pa):
            if np.hypot(b[0], b[1]) <= max_range:  # devkit range filter
                preds.append((float(s), si, b, int(a)))
        gm = r.gt_labels == cls
        gt = r.gt_boxes[gm]
        ga = (r.gt_attrs[gm] if r.gt_attrs is not None
              else np.full(int(gm.sum()), -1, np.int32))
        in_range = np.hypot(gt[:, 0], gt[:, 1]) <= max_range if len(gt) else np.zeros(0, bool)
        gts.append(gt[in_range])
        gidxs.append(np.where(gm)[0][in_range])
        gattrs.append(np.asarray(ga)[in_range])
        n_gt += int(in_range.sum())
    if n_gt == 0:
        return None

    no_pred = (
        np.zeros(NELEM), np.zeros(NELEM),
        {k: np.ones(NELEM) for k in TP_METRICS},
    )
    if not preds:
        return no_pred
    preds.sort(key=lambda x: -x[0])
    taken = [set() for _ in records]
    tp, fp, conf = [], [], []
    md = {k: [] for k in TP_METRICS}
    m_conf: List[float] = []
    aoe_period = np.pi if class_name == "barrier" else 2 * np.pi
    for score, si, box, pattr in preds:
        gt = gts[si]
        gidx = gidxs[si]
        # devkit: closest unmatched GT overall, then threshold test
        best, best_d = -1, np.inf
        for j in range(len(gt)):
            if gidx[j] in taken[si]:
                continue
            d = float(np.hypot(box[0] - gt[j, 0], box[1] - gt[j, 1]))
            if d < best_d:
                best, best_d = j, d
        if best >= 0 and best_d < dist_th:
            taken[si].add(gidx[best])
            tp.append(1.0)
            fp.append(0.0)
            conf.append(score)
            g = gt[best]
            md["ate"].append(best_d)
            md["ase"].append(1.0 - _aligned_iou_3d(box, g))
            # per-class NaN rules are devkit evaluate.py's; NaNs flow
            # through cummean / the class-level nanmean
            md["aoe"].append(
                np.nan if class_name == "traffic_cone"
                else _yaw_diff(float(box[6]), float(g[6]), aoe_period))
            md["ave"].append(
                np.nan if (class_name in NO_ATTR_CLASSES
                           or len(box) < 9 or len(g) < 9)
                else float(np.hypot(box[7] - g[7], box[8] - g[8])))
            gattr = int(gattrs[si][best]) if len(gattrs[si]) else -1
            md["aae"].append(
                np.nan if (class_name in NO_ATTR_CLASSES
                           or pattr < 0 or gattr < 0)
                else (0.0 if pattr == gattr else 1.0))
            m_conf.append(score)
        else:
            tp.append(0.0)
            fp.append(1.0)
            conf.append(score)
    if not m_conf:  # no matches: devkit no_predictions()
        return no_pred
    tp = np.cumsum(tp).astype(np.float64)
    fp = np.cumsum(fp).astype(np.float64)
    conf = np.asarray(conf, np.float64)
    prec = tp / (fp + tp)
    rec = tp / float(n_gt)
    rec_interp = np.linspace(0, 1, NELEM)
    prec_i = np.interp(rec_interp, rec, prec, right=0)
    conf_i = np.interp(rec_interp, rec, conf, right=0)
    m_conf_arr = np.asarray(m_conf, np.float64)
    md_i = {}
    for key, vals in md.items():
        tmp = cummean(np.asarray(vals))
        # devkit: resample the cummean BY CONFIDENCE onto the 101-bin
        # interpolated-confidence curve (np.interp needs ascending xp)
        md_i[key] = np.interp(
            conf_i[::-1], m_conf_arr[::-1], tmp[::-1])[::-1]
    return prec_i, conf_i, md_i


def calc_ap(precision: np.ndarray) -> float:
    """devkit ``calc_ap``: bins above min recall (EXCLUSIVE of the 0.10 bin
    — index 11 onward), precision clipped below 0.1, renormalized."""
    prec = np.copy(precision)[round(100 * MIN_RECALL) + 1:]
    prec -= MIN_PRECISION
    prec[prec < 0] = 0
    return float(np.mean(prec)) / (1.0 - MIN_PRECISION)


def calc_tp(md_metric: np.ndarray, confidence: np.ndarray) -> float:
    """devkit ``calc_tp``: mean of the resampled error over bins
    [11, max_recall_ind]; 1.0 when max recall never clears min recall."""
    first_ind = round(100 * MIN_RECALL) + 1
    nz = np.nonzero(confidence)[0]
    last_ind = int(nz[-1]) if len(nz) else 0
    if last_ind < first_ind:
        return 1.0
    return float(np.mean(md_metric[first_ind:last_ind + 1]))


def evaluate_detections(
    records: Sequence[DetectionRecord],
    num_classes: int,
    class_names: Optional[Sequence[str]] = None,
) -> Dict:
    """nuScenes-protocol mAP + TP metrics + NDS over a result set."""
    class_names = class_names or [str(i) for i in range(num_classes)]
    ap_table: Dict[str, Dict[float, float]] = {}
    tp_table: Dict[str, Dict[str, float]] = {}
    for c in range(num_classes):
        cname = class_names[c]
        aps = {}
        tp_errs = None
        for th in DIST_THRESHOLDS:
            out = _accumulate_class(records, c, th, cname)
            if out is None:
                continue
            prec_i, conf_i, md_i = out
            aps[th] = calc_ap(prec_i)
            if th == TP_THRESHOLD:
                # devkit evaluate.py class/metric NaN rules
                tp_errs = {}
                for k in TP_METRICS:
                    if cname == "traffic_cone" and k in ("aoe", "ave", "aae"):
                        tp_errs[k] = np.nan
                    elif cname == "barrier" and k in ("ave", "aae"):
                        tp_errs[k] = np.nan
                    else:
                        v = calc_tp(md_i[k], conf_i)
                        # deviation: velocity-less boxes / attribute-less
                        # records give an all-NaN cummean (== zeros); mark
                        # the metric absent instead of reporting perfect 0
                        if (k in ("ave", "aae")
                                and np.all(np.isnan(_raw_metric(records, c, cname, k)))):
                            v = np.nan
                        tp_errs[k] = v
        if aps:
            ap_table[cname] = aps
            if tp_errs is not None:
                tp_table[cname] = tp_errs

    if not ap_table:
        return {"mAP": 0.0, "NDS": 0.0, "per_class": {}}

    mean_ap = float(np.mean([np.mean(list(a.values())) for a in ap_table.values()]))
    tp_scores = []
    agg_tp: Dict[str, float] = {}
    for metric in TP_METRICS:
        vals = [
            t[metric] for t in tp_table.values()
            if metric in t and not np.isnan(t[metric])
        ]
        if vals:
            err = float(np.mean(vals))  # nanmean over classes (NaNs excluded)
            agg_tp[metric.upper()] = err
            # devkit tp_scores: 1 − err, clipped to [0, 1] — NO normalizer
            tp_scores.append(float(np.clip(1.0 - err, 0.0, 1.0)))
    nds = (5 * mean_ap + sum(tp_scores)) / (5 + len(tp_scores))
    # full precision — golden-vector tests assert these at 1e-6; consumers
    # round for display
    return {
        "mAP": mean_ap,
        "NDS": float(nds),
        "tp_errors": dict(agg_tp),
        "per_class": {
            k: {"AP": float(np.mean(list(v.values())))}
            for k, v in ap_table.items()
        },
    }


def _raw_metric(records, cls: int, class_name: str, key: str) -> np.ndarray:
    """Raw per-match availability probe for the ave/aae deviation above:
    returns one value per candidate (pred or GT) — NaN when the data can't
    express the metric at all (no velocity columns / no attribute ids)."""
    vals = []
    for r in records:
        if key == "ave":
            has = r.boxes.shape[1] >= 9 and r.gt_boxes.shape[1] >= 9
            vals.append(0.0 if has else np.nan)
        else:  # aae
            has = (r.attrs is not None and r.gt_attrs is not None
                   and class_name not in NO_ATTR_CLASSES)
            if has:
                pm = (r.labels == cls) & (np.asarray(r.attrs) >= 0)
                gm = (r.gt_labels == cls) & (np.asarray(r.gt_attrs) >= 0)
                has = bool(pm.any() and gm.any())
            vals.append(0.0 if has else np.nan)
    return np.asarray(vals, np.float64)
