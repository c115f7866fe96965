"""The FSF family: the program's ``models.fsf.FSF`` against the reference's
frozen copy (``benchmark/reference/models/fsf.py``), on LiDAR scenes with
the cameras' mask planes painted from the boxes.

Serving runs ``FSF.forward`` + ``FSF.get_bboxes`` under
``torch.inference_mode`` and copies the detections to the host; training
runs the program's ``parallel.train.train_step``. The names below are the
ones the harness calls (``benchmark/harness/cell.py`` lists them); the
harness loads this file by the configuration's ``"family": "fsf"``."""
from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from benchmark.harness import configs, costs, judge, scenes, traffic as traffic_mod, weights

# the traffic modes this family runs, each with the mix keys it reads beyond the harness's
MODES = {"serve": (), "train": ()}
# the program's train-step marks, as the spans of forward_ms.train / backward_ms.train
TRAIN_MARKS = {"forward": "forward", "backward": "backward"}
# calibrate.py's witness (--detection-from): the step from which the detection
# terms count, over the configuration's ``train.enable_detection_step``
_detection_from_override = None


# --- configuration ---------------------------------------------------------

def program_config(cfg_file: Mapping[str, Any]):
    """The program's ``FSFConfig`` of a configuration file."""
    from fullysparsefusion_tpu_torch.config import FSFConfig

    return configs.dataclass_from_dict(FSFConfig, cfg_file["model"])


def reference_config(cfg_file: Mapping[str, Any]):
    """The reference's ``FSFConfig`` of a configuration file."""
    from benchmark.reference.config import FSFConfig

    return configs.dataclass_from_dict(FSFConfig, cfg_file["model"])


def check_cell(cfg_file: Mapping[str, Any], traffic: Mapping[str, Any]) -> None:
    if traffic["mode"] == "train" and \
            traffic["checked_steps"] > cfg_file["train"]["enable_detection_step"]:
        raise ValueError("the checked steps have to lie in the segmentor-only warm-up "
                         "(traffic checked_steps <= config train.enable_detection_step)")


def _detection_from(cfg_file: Mapping[str, Any]) -> int:
    if _detection_from_override is not None:
        return _detection_from_override
    return cfg_file["train"]["enable_detection_step"]


# --- models and weights ----------------------------------------------------

def reference_model(cfg_file: Mapping[str, Any], device):
    from benchmark.reference.models.fsf import FSF

    with torch.device(device):
        return FSF(reference_config(cfg_file))


def program_model(cfg_file: Mapping[str, Any], state, device):
    """The program's ``FSF`` on ``device`` with ``state`` loaded strictly, in
    eval mode."""
    from fullysparsefusion_tpu_torch.models.fsf import FSF

    with torch.device(device):
        model = FSF(program_config(cfg_file))
    model.load_state_dict(state, strict=True)
    return model.eval()


def _layout(model: nn.Module):
    """(name, fan_in) of each truncated-normal leaf, and the leaves that are
    0, 1, in the order of ``model.named_modules()``.

    The distributions are the program's initialisation
    (``weights.init_parameters``): dense and sparse-conv weights truncated
    normal with variance 1/fan_in, biases 0, norm scales 1 with statistics
    0 / 1, and the enhancement MLP's last layer 0."""
    from benchmark.reference.models.fsf import ZeroInitMLP
    from benchmark.reference.models.layers import LayerNorm, MaskedBatchNorm
    from benchmark.reference.models.sparse_unet import _ConvBlock

    normal, zeros, ones = [], [], []
    zero_last = set()
    for name, m in model.named_modules():
        if isinstance(m, ZeroInitMLP):
            zero_last.add(f"{name}.Dense_{m.n - 1}")
    for name, m in model.named_modules():
        p = f"{name}." if name else ""
        if isinstance(m, nn.Linear):
            if name in zero_last:
                zeros.append(p + "weight")
            else:
                normal.append((p + "weight", m.weight.shape[1]))
            if m.bias is not None:
                zeros.append(p + "bias")
        elif isinstance(m, _ConvBlock):
            normal.append((p + "w", m.w.shape[0] * m.w.shape[1]))
        elif isinstance(m, (LayerNorm, MaskedBatchNorm)):
            ones.append(p + "weight")
            zeros.append(p + "bias")
            if isinstance(m, MaskedBatchNorm):
                zeros.append(p + "running_mean")
                ones.append(p + "running_var")
    return normal, zeros, ones


def make_state(cfg_file: Mapping[str, Any], seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights of ``seed`` on ``device``: a full ``state_dict`` of the
    reference's FSF, whose names the program's shares."""
    return weights.make_state(reference_model(cfg_file, "meta"), seed, device, _layout)


# --- frames ----------------------------------------------------------------

@dataclass
class Frame:
    index: int                 # position in the pool
    objects: int               # GT boxes placed in the scene
    points: Any                # [N, D + 3] f32 with the no-aug xyz, host or device
    batch_idx: Any             # [N] i32
    valid: Any                 # [N] bool
    gt: Dict[str, torch.Tensor]   # boxes [1, M, 10], labels [1, M], valid [1, M] on the device
    cam: Dict[str, Any]        # masks, anno, lidar2img on the device; img_h, img_w


def make_frame(cfg_file: Mapping[str, Any], traffic: Mapping[str, Any], seed: int, i: int,
               objects: int, device) -> Frame:
    """Frame ``i`` of the pool: the configuration's LiDAR scene of
    ``objects`` boxes from ``(seed, i)``, its points where the mix's
    ``points_on`` says, and the cameras' mask planes painted on the device."""
    model = cfg_file["model"]
    caps = model["fsd"]["caps"]
    sc_cfg = dict(cfg_file["scene"])
    if sc_cfg.pop("generator") != "lidar_scene":
        raise ValueError("unknown scene generator")
    sc = scenes.make_lidar_scene_arrays(
        seed=traffic_mod.frame_seed(seed, i), n_cap=caps["points"], max_gt=caps["max_gt"],
        n_boxes=objects, num_classes=model["fsd"]["segmentor"]["num_classes"], **sc_cfg)
    pts = scenes.with_noaug_channels_array(sc["points"])
    cam = scenes.camera_tensors(sc["gt_boxes"], sc["gt_labels"], sc["gt_valid"], device,
                                batch_size=1, num_classes=model["fsd"]["segmentor"]["num_classes"],
                                **cfg_file["cameras"])
    on_host = traffic["points_on"] == "host"

    def put(a):
        return a if on_host else torch.as_tensor(a, device=device)

    gt = dict(boxes=torch.as_tensor(sc["gt_boxes"], device=device),
              labels=torch.as_tensor(sc["gt_labels"], device=device),
              valid=torch.as_tensor(sc["gt_valid"], device=device))
    return Frame(i, objects, put(pts), put(sc["batch_idx"]), put(sc["valid"]), gt, cam)


def _inputs(frame: Frame, device, point_cls, cam_cls, gt_cls):
    pts = torch.as_tensor(frame.points, device=device)
    pb = point_cls(points=pts, batch_idx=torch.as_tensor(frame.batch_idx, device=device),
                   valid=torch.as_tensor(frame.valid, device=device))
    c = frame.cam
    cam = cam_cls(masks=c["masks"], anno=c["anno"], lidar2img=c["lidar2img"],
                  img_h=c["img_h"], img_w=c["img_w"])
    gt = gt_cls(boxes=frame.gt["boxes"], labels=frame.gt["labels"], valid=frame.gt["valid"])
    return pb, cam, gt


def program_inputs(frame: Frame, device):
    """(PointBatch, CameraData, GroundTruth) of the program; points that
    live on the host are copied to ``device`` here, as a frame arrives."""
    from fullysparsefusion_tpu_torch.utils.containers import CameraData, GroundTruth, PointBatch

    return _inputs(frame, device, PointBatch, CameraData, GroundTruth)


def reference_inputs(frame: Frame, device):
    from benchmark.reference.utils.containers import CameraData, GroundTruth, PointBatch

    return _inputs(frame, device, PointBatch, CameraData, GroundTruth)


# --- serving ---------------------------------------------------------------

def serve_one(model, frame: Frame, device):
    """One frame, from its points on the host to its detections on the host."""
    pb, cam, _ = program_inputs(frame, device)
    with torch.inference_mode():
        res = model(pb, cam, 1)
        det = model.get_bboxes(res, 1)
    return {k: getattr(det, k)[0].cpu() for k in ("boxes", "scores", "labels", "valid")}


def failed(answer) -> bool:
    return not all(torch.isfinite(answer[k]).all() for k in ("boxes", "scores"))


def serve_spans(spans, model) -> None:
    """The spans of seg_core_ms.serve and foreground_ms.serve."""
    spans.module("seg_core", model.seg_core)
    spans.method("foreground", model.fsd_branch, "extract_foreground")


def reference_answer(ref, frame: Frame, device):
    """The reference's detections of ``frame``, in the answer's form."""
    pb, cam, _ = reference_inputs(frame, device)
    with torch.inference_mode():
        return judge.as_dict(ref.get_bboxes(ref(pb, cam, 1), 1))


def served_numbers(want, got) -> Dict[str, float]:
    """The numbers compared for one served frame, by the limits' names."""
    return {"moved_share": judge.moved_share(want, got)}


def work_count(ref, training: bool = False) -> costs.WorkCount:
    return costs.WorkCount(ref, training=training)


# --- training --------------------------------------------------------------

def program_batch(frame: Frame, device):
    from fullysparsefusion_tpu_torch.parallel.train import Batch

    pb, cam, gt = program_inputs(frame, device)
    return Batch(pb, cam, gt, gt)


def _optimizer(make, model, cfg):
    t = cfg["train"]
    return make(model, base_lr=t["base_lr"], total_steps=t["total_steps"],
                weight_decay=t["weight_decay"], grad_clip_norm=t["grad_clip_norm"],
                lr_mult_rules=t["lr_mult_rules"])


def program_train(run, model):
    """(the optimizer, ``step(batch, s, mark=None)``): the program's
    ``train_step`` on the configuration's AdamW and schedule."""
    from fullysparsefusion_tpu_torch.parallel.train import make_optimizer, train_step
    from fullysparsefusion_tpu_torch.train.hooks import RuntimeSchedule

    opt = _optimizer(make_optimizer, model, run.cfg)
    sched = RuntimeSchedule(enable_detection_step=_detection_from(run.cfg))
    return opt, functools.partial(train_step, model, opt, sched)


def judge_train(run, pool, losses, first, change, traced, readings) -> None:
    """The reference follows the checked steps from the same weights on the
    same scenes, on the same schedule; its passes over the traced units'
    scenes count their work."""
    from benchmark.reference.hooks import RuntimeSchedule
    from benchmark.reference.train import Batch, make_optimizer, train_step

    first_grad, first_grad_t = first
    state = run.state()
    ref = run.reference(state)
    opt = _optimizer(make_optimizer, ref, run.cfg)
    names = {id(p): n for n, p in ref.named_parameters()}
    sched = RuntimeSchedule(enable_detection_step=_detection_from(run.cfg))
    ref_losses, works = [], {}
    for s in range(len(losses)):
        idx = s % len(pool)
        pb, cam, gt = reference_inputs(pool[idx], run.device)
        wc = work_count(ref, training=True) if idx in traced and idx not in works else None
        loss, terms, _ = train_step(ref, opt, sched, Batch(pb, cam, gt, gt), s,
                                    wc.mark if wc is not None else None)
        ref_losses.append(float(loss))
        if s == 0:
            ref_terms = {k: float(v) for k, v in terms.items()}
        if wc is not None:
            works[idx] = wc.totals()
            wc.detach()
        if s == 0:
            ref_grad = judge.adam_first_grads(opt, names)
            grad_diff = judge.adam_first_grad_diffs(opt, names, first_grad_t)
    with torch.no_grad():
        ref_change = {n: float((p.double() - state[n].double()).norm())
                      for n, p in ref.named_parameters()}
    reached = judge.reached_leaves(ref_grad)
    g = judge.leaf_gaps(ref_grad, first_grad, reached)
    c = judge.leaf_gaps(ref_change, change, reached)
    d = judge.leaf_gaps(ref_grad, first_grad, reached, diff=grad_diff)
    got_terms = readings.pop("first_terms")
    numbers = dict(
        loss_gap=judge.loss_gap(ref_losses, losses), grad_leaf_gap=g[0][0],
        change_leaf_gap=c[0][0], grad_diff_gap=d[0][0],
        seg_loss_gap=judge.seg_loss_gap(ref_terms, got_terms),
        grad_median_gap=judge.median([v for v, _ in g]),
        change_median_gap=judge.median([v for v, _ in c]),
        grad_diff_median=judge.median([v for v, _ in d]))
    readings["not_compared"] = {}
    for name, value in numbers.items():     # a number the configuration sets no limit for
        if name in run.limits:              # is reported, not compared (PERF.md says why)
            run.check(name, value, run.limits[name])
        else:
            readings["not_compared"][name] = value
    readings["detail"] = dict(
        reached_leaves=len(reached),
        grad_worst=[[k, v] for v, k in g[:5]], change_worst=[[k, v] for v, k in c[:5]],
        grad_diff_worst=[[k, v] for v, k in d[:5]],
        losses=[ref_losses, losses],
        first_terms={k: [ref_terms[k], got_terms.get(k)] for k in ref_terms
                     if abs(ref_terms[k] - got_terms.get(k, 0.0)) > 1e-3 * max(abs(ref_terms[k]), 1e-6)},
        seg_terms={k: [ref_terms[k], got_terms.get(k)] for k in judge.SEG_TERMS})
    readings["leaves"] = dict(ref_grad=ref_grad, grad=first_grad, ref_change=ref_change,
                              change=change, grad_diff=grad_diff)
    counted = [i for i in traced if i in works]
    if counted:
        readings["work"] = {k: float(np.mean([works[i][k] for i in counted]))
                            for k in works[counted[0]]}
    del ref, opt, state
    run.free()


# --- calibration (calibrate.py): each entered around one run ----------------

@contextlib.contextmanager
def control():
    """The control in the program's place: the reference in the precision
    one step down (``reference/precision.py``), built as the program would
    be; the judge's own reference runs in the configuration's precision."""
    from benchmark.reference import precision

    g = globals()
    names = ("program_model", "program_inputs", "reference_answer", "judge_train")
    saved = {k: g[k] for k in names}

    def lowered(cfg_file, state, device):
        m = reference_model(cfg_file, device)
        m.load_state_dict(state, strict=True)
        return precision.lower_linears(m).eval()

    def judged(fn):
        def run(*a, **k):
            precision.LOW = False
            return fn(*a, **k)
        return run

    g.update(program_model=lowered, program_inputs=reference_inputs,
             reference_answer=judged(saved["reference_answer"]),
             judge_train=judged(saved["judge_train"]))
    precision.LOW = True
    try:
        yield
    finally:
        g.update(saved)
        precision.LOW = False


@contextlib.contextmanager
def detection_from(step: int):
    """The detection terms counted from ``step`` (the witness of a training
    cell's discrete decisions)."""
    global _detection_from_override
    saved, _detection_from_override = _detection_from_override, step
    try:
        yield
    finally:
        _detection_from_override = saved


def _plain_gather(reverse: bool):
    def gather_conv(feats, rows, w, plan=None):
        n_src, cin = feats.shape
        f_z = torch.cat([feats, feats.new_zeros(1, cin)]).float()
        wf = w.float()
        out = torch.zeros(rows.shape[1], w.shape[2], dtype=torch.float32, device=feats.device)
        taps = range(rows.shape[0])
        for k in (reversed(taps) if reverse else taps):
            out += f_z[rows[k].long()] @ wf[k]
        return out

    gather_conv.launches = 0
    return gather_conv


@contextlib.contextmanager
def program_path(kind: str):
    """The program's K1 and dw_per_tap with their plain arithmetic:
    ``plain`` (the reference's order of the taps) or ``plain_reversed``
    (the taps summed in the reverse order, a change of rounding alone)."""
    from fullysparsefusion_tpu_torch.ops import sparse_conv

    if kind not in ("plain", "plain_reversed"):
        raise ValueError(f"unknown program path {kind!r}")
    saved = sparse_conv.gather_conv, sparse_conv.dw_per_tap

    def dw_per_tap(feats, rows, g, plan=None):
        return sparse_conv.dw_per_tap_plain(feats, rows, g)

    dw_per_tap.launches = 0
    sparse_conv.gather_conv = _plain_gather(kind == "plain_reversed")
    sparse_conv.dw_per_tap = dw_per_tap
    try:
        yield
    finally:
        sparse_conv.gather_conv, sparse_conv.dw_per_tap = saved


@contextlib.contextmanager
def fault(kind: str):
    """The program's backward with fault ``kind``: ``dw_taps_reversed``
    (dw_per_tap's weight gradient with its taps in reverse order) or
    ``dfeats_scaled`` (each sparse convolution's input gradient × 1.25)."""
    from fullysparsefusion_tpu_torch.ops import sparse_conv

    fn = sparse_conv.GatherConvFunction
    saved = sparse_conv.dw_per_tap, fn.backward
    if kind == "dw_taps_reversed":
        def dw_per_tap(*a, **k):
            return saved[0](*a, **k).flip(0)

        dw_per_tap.launches = 0
        sparse_conv.dw_per_tap = dw_per_tap
    elif kind == "dfeats_scaled":
        def backward(ctx, g):
            d_feats, *rest = saved[1](ctx, g)
            return (None if d_feats is None else d_feats * 1.25, *rest)

        fn.backward = staticmethod(backward)
    else:
        raise ValueError(f"unknown fault {kind!r}")
    try:
        yield
    finally:
        sparse_conv.dw_per_tap, fn.backward = saved[0], staticmethod(saved[1])
