"""How ``correct`` is decided: the program's answers against the reference's.

Serving. An answer is a frame's detections (boxes, scores, labels, valid)
as they reached the host. The reference serves the same frame with the
same weights, and every valid detection of either side is matched to the
nearest one of the same label on the other side; its gap is the largest of
the centre's distance in metres (per axis), the sizes' relative change,
the yaw's change in radians, the velocity's change in m/s and the score's
change. The number compared is the share of detections, of both sides,
whose gap exceeds ``GAP``: a detection that the other side lacks, or that
moved, counts.

Training. The checked steps are the configuration's segmentor-only
warm-up (``train.enable_detection_step``: the detection terms are scaled by
0, as FSD's recipe starts from scratch), and the reference follows them from
the same weights on the same scenes. Their losses, gradients and updates lie
upstream of every discrete decision of the detection branch (which points
are foreground, which cluster centre falls in a box, NMS), which with random
weights flip on rounding and swing the detection terms from seed to seed
(PERF.md gives the readings). Compared are the first step's segmentation
terms and each step's loss, by the largest relative gap; and, over the
leaves that the reference's first gradient reaches (at least a thousandth
of the median of its nonzero leaves), the first gradient as AdamW got it and
the change of the parameters after the checked steps, each by its worst
leaf. A leaf's gap is the gap between the program's norm and the
reference's, over the larger of the reference's norm of that leaf and of
the median of those leaves; the first gradient is also compared
elementwise, ``‖g − g_ref‖`` over the same norm, since the norms average
away errors that are random from element to element (the control's).
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping, Sequence

import torch

# a detection "moved" past 1 cm, 1 %, 0.01 rad, 0.01 m/s or 0.01 in score
GAP = 0.01


def _gaps_one_way(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]) -> torch.Tensor:
    """For each valid detection of ``a``, its gap to the nearest same-label
    valid detection of ``b`` (inf where ``b`` has none)."""
    ka, kb = a["valid"], b["valid"]
    ba, bb = a["boxes"][ka].double(), b["boxes"][kb].double()
    la, lb = a["labels"][ka], b["labels"][kb]
    sa, sb = a["scores"][ka].double(), b["scores"][kb].double()
    if ba.shape[0] == 0:
        return torch.zeros(0, dtype=torch.float64)
    if bb.shape[0] == 0:
        return torch.full((ba.shape[0],), math.inf, dtype=torch.float64)
    centre = (ba[:, None, :3] - bb[None, :, :3]).abs().amax(-1)
    dims = ((ba[:, None, 3:6] - bb[None, :, 3:6]).abs()
            / ba[:, None, 3:6].abs().clamp(min=1e-6)).amax(-1)
    d_yaw = ba[:, None, 6] - bb[None, :, 6]
    yaw = torch.atan2(torch.sin(d_yaw), torch.cos(d_yaw)).abs()
    gap = torch.maximum(torch.maximum(centre, dims), yaw)
    if ba.shape[1] > 7:
        gap = torch.maximum(gap, (ba[:, None, 7:] - bb[None, :, 7:]).abs().amax(-1))
    gap = torch.maximum(gap, (sa[:, None] - sb[None, :]).abs())
    gap = torch.where(la[:, None] == lb[None, :], gap, torch.full_like(gap, math.inf))
    return gap.amin(1)


def detection_gaps(ref: Dict[str, torch.Tensor], got: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The gaps of every valid detection of both sides (CPU tensors of one
    frame: boxes [K, C], scores [K], labels [K], valid [K])."""
    return torch.cat([_gaps_one_way(ref, got), _gaps_one_way(got, ref)])


def moved_share(ref: Dict[str, torch.Tensor], got: Dict[str, torch.Tensor],
                gap: float = GAP) -> float:
    """Share of the detections of both sides whose gap exceeds ``gap``; 1
    where one side has detections and the other none, 0 where neither has."""
    g = detection_gaps(ref, got)
    if g.numel() == 0:
        return 0.0
    return float((g > gap).double().mean())


def as_dict(det) -> Dict[str, torch.Tensor]:
    """One frame (batch row 0) of an ``NMSResult``-like tuple, on the CPU."""
    return {k: getattr(det, k)[0].detach().cpu() for k in ("boxes", "scores", "labels", "valid")}


# --- training ------------------------------------------------------------

def median(values: Sequence[float]) -> float:
    v = sorted(values)
    n = len(v)
    return 0.0 if n == 0 else (v[n // 2] if n % 2 else 0.5 * (v[n // 2 - 1] + v[n // 2]))


def leaf_gaps(ref: Mapping[str, float], got: Mapping[str, float], leaves=None,
              diff: Mapping[str, float] = None) -> List[tuple]:
    """``(|got − ref| / max(ref, median ref), leaf)`` over ``leaves``
    (default all), the median taken over the same leaves; largest first.
    With ``diff`` (each leaf's ‖got − ref‖ elementwise) that takes the place
    of ``|got − ref|``."""
    keys = list(ref) if leaves is None else list(leaves)
    med = median([ref[k] for k in keys])
    gap = (lambda k: diff[k]) if diff is not None else (lambda k: abs(got.get(k, 0.0) - ref[k]))
    return sorted(((gap(k) / max(ref[k], med, 1e-30), k) for k in keys), reverse=True)


def worst_leaf_gap(ref: Mapping[str, float], got: Mapping[str, float],
                   leaves=None) -> tuple:
    """(largest leaf gap over ``leaves`` (default all), its leaf)."""
    gaps = leaf_gaps(ref, got, leaves)
    return gaps[0] if gaps else (0.0, "")


def reached_leaves(first_grad_ref: Mapping[str, float]) -> List[str]:
    """The leaves that the reference's first gradient reaches: at least a
    thousandth of the median of its nonzero leaves (the others, and those
    whose loss terms the warm-up scales by 0, move by weight decay and
    round-off alone)."""
    med = median([v for v in first_grad_ref.values() if v > 0])
    return [k for k, v in first_grad_ref.items() if v > 0 and v >= 1e-3 * med]


def adam_first_grads(opt: torch.optim.Optimizer, names: Mapping[int, str]) -> Dict[str, float]:
    """Each leaf's gradient norm as AdamW got it at its first step: the
    first moment after one step is ``(1 − β1) · g``."""
    out = {}
    for group in opt.param_groups:
        b1 = group["betas"][0]
        for p in group["params"]:
            st = opt.state.get(p)
            if st and "exp_avg" in st:
                out[names[id(p)]] = float(st["exp_avg"].double().norm()) / (1.0 - b1)
            else:
                out[names[id(p)]] = 0.0
    return out


def adam_first_grad_tensors(opt: torch.optim.Optimizer,
                            names: Mapping[int, str]) -> Dict[str, torch.Tensor]:
    """Each leaf's gradient as AdamW got it at its first step, elementwise,
    on the host: the leaves that it reached (a first moment not all zero)."""
    out = {}
    for group in opt.param_groups:
        b1 = group["betas"][0]
        for p in group["params"]:
            st = opt.state.get(p)
            if st and "exp_avg" in st and bool(st["exp_avg"].any()):
                out[names[id(p)]] = (st["exp_avg"].float() / (1.0 - b1)).cpu()
    return out


def adam_first_grad_diffs(opt: torch.optim.Optimizer, names: Mapping[int, str],
                          got: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    """Each leaf's ‖g_ref − g_got‖ of the first gradients as AdamW got them,
    elementwise (``got`` from :func:`adam_first_grad_tensors`; a leaf that
    it lacks counts as zero)."""
    ref = adam_first_grad_tensors(opt, names)
    out = {}
    for group in opt.param_groups:
        for p in group["params"]:
            k = names[id(p)]
            r = ref.get(k, torch.zeros(p.shape))
            out[k] = float((r.double() - got.get(k, torch.zeros(p.shape)).double()).norm())
    return out


SEG_TERMS = ("loss_sem_seg", "loss_vote")


def seg_loss_gap(ref: Mapping[str, float], got: Mapping[str, float]) -> float:
    """Largest relative gap of the segmentation loss terms of one step (inf
    when one is not finite or missing)."""
    worst = 0.0
    for k in SEG_TERMS:
        r, g = ref[k], got.get(k, math.nan)
        if not (math.isfinite(r) and math.isfinite(g)):
            return math.inf
        worst = max(worst, abs(g - r) / max(abs(r), 1e-30))
    return worst


def loss_gap(ref: Sequence[float], got: Sequence[float]) -> float:
    """Largest relative gap of the steps' summed losses (inf when a side's
    loss is not finite)."""
    worst = 0.0
    for r, g in zip(ref, got):
        if not (math.isfinite(r) and math.isfinite(g)):
            return math.inf
        worst = max(worst, abs(g - r) / max(abs(r), 1e-30))
    return worst
