"""The HTC family: the program's ``models.htc.HTC`` served through the mask
tool's library path, ``generate_masks.sample_masks``, against the
reference's plain HTC and mask tool (``benchmark/reference/models/htc.py``,
``benchmark/reference/masks.py``).

A frame is one nuScenes sample: six uint8 RGB camera images on the host,
drawn from the seeded scene that the FSF cells draw (its boxes projected by
the harness's cameras and painted as filled boxes, one colour an object,
over a smooth seeded background, with a camera's noise). The weights are
the seed's draw with its logit layers calibrated on a sample of its own
(:func:`make_state`). The timed unit is ``sample_masks``: the
images in, the ``[cams, H, W, classes]`` instance planes and the ``[max_anno,
9]`` anno table on the host out. A forward hook keeps the model's
per-camera detections (device tensors, no copy) beside them for the judge.

``correct``: on the judged samples, every valid detection of either side
that scores at least the tool's ``score_thr`` (what the tool pastes) is
matched to the nearest one of the same label in the same camera on the
other side; it has moved where the nearest lies farther than ``box_gap_px``
in any coordinate or ``score_gap`` in score (``judge`` in the
configuration). ``moved_share`` is the share of both sides' detections that
moved (or have no match); ``mask_gap`` the largest |Δ| of the 28 × 28 mask
probabilities over the pairs that did not. The tool's output is held the
same way: ``anno_moved`` is the share of both sides' anno rows with no row
of the same camera and category on the other side within the judge, and
``paint_gap`` the share of the painted pixels of matched rows (either side)
whose instance differs, once the program's row numbers are mapped to the
reference's through that match. The configuration states f32 with
TF32 off: a program whose forward runs with TF32 allowed (PyTorch's default
for cuDNN) cannot run it, and its first sample raises. The names below are the ones the
harness calls (``benchmark/harness/cell.py`` lists them); the harness loads
this file by the configuration's ``"family": "htc"``."""
from __future__ import annotations

import contextlib
import functools
import inspect
import math
from dataclasses import dataclass
from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.harness import scenes, traffic as traffic_mod, weights

# the traffic modes this family runs, each with the mix keys it reads beyond the harness's
MODES = {"serve": ()}
# what both sides build, whatever the configuration says: it has to say the same
FIXED = dict(groups=64, base_width=4, stage_with_dcn=[False, True, True, True],
             fpn_channels=256, mask_size=28)


def _model_kw(cfg_file: Mapping[str, Any]) -> Dict[str, Any]:
    m = cfg_file["model"]
    return dict(num_classes=m["num_classes"], num_proposals=m["num_proposals"],
                rpn_pre_nms=m["rpn_pre_nms"], max_dets=m["max_dets"],
                depth_blocks=tuple(m["depth_blocks"]))


def check_cell(cfg_file: Mapping[str, Any], traffic: Mapping[str, Any]) -> None:
    model = cfg_file["model"]
    off = {k: model.get(k) for k, v in FIXED.items() if model.get(k) != v}
    if off:
        raise ValueError(f"the HTC family builds {FIXED}; the configuration says {off}")
    if traffic["points_on"] != "host":
        raise ValueError("the mask tool takes a sample's images on the host (points_on host)")


# --- models and weights ----------------------------------------------------

def reference_model(cfg_file: Mapping[str, Any], device):
    from benchmark.reference.models.htc import HTC

    with torch.device(device):
        return HTC(**_model_kw(cfg_file))


def _stated_precision(model, args):
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the program runs HTC's forward with TF32 allowed; the configuration "
                           "states f32 with TF32 off")


def _keep_detections(model, args, out):
    model.served = out


def program_model(cfg_file: Mapping[str, Any], state, device):
    """The program's ``HTC`` on ``device`` with ``state`` loaded strictly, in
    eval mode; a forward that would run with TF32 allowed (cuDNN's or
    cuBLAS's flag) raises, since that is not the configuration's precision;
    each forward's detections stay on ``model.served``."""
    from fullysparsefusion_tpu_torch.models.htc import HTC

    with torch.device(device):
        model = HTC(**_model_kw(cfg_file))
    model.load_state_dict(state, strict=True)
    model.register_forward_pre_hook(_stated_precision)
    model.register_forward_hook(_keep_detections)
    return model.eval()


def _layout(model: nn.Module, w: Mapping[str, float]):
    """(name, fan_in) of each truncated-normal leaf, and the leaves that are
    0, 1, in the order of ``model.named_modules()``: the variances of the
    program's ``weights.init_parameters`` (``build_htc``), conv and linear
    weights 1 / fan_in, deformable and transposed-conv weights 2 / fan_out,
    biases 0, BN the identity; the DCN offset branches (which ``build_htc``
    leaves 0) times the square of the configuration's ``weights.offset_std``
    (a "fan_in" here is 1 / the variance)."""
    from benchmark.reference.models.htc import BN, DeformConvBlock

    normal, zeros, ones = [], [], []
    gain = {f"{n}.conv_offset": w["offset_std"] for n, m in model.named_modules()
            if isinstance(m, DeformConvBlock)}
    for name, m in model.named_modules():
        p = f"{name}." if name else ""
        if isinstance(m, nn.ConvTranspose2d):
            normal.append((p + "weight", m.weight[0].numel() / 2.0))
            zeros.append(p + "bias")
        elif isinstance(m, (nn.Conv2d, nn.Linear)):
            normal.append((p + "weight", m.weight[0].numel() / gain.get(name, 1.0) ** 2))
            if m.bias is not None:
                zeros.append(p + "bias")
        elif isinstance(m, DeformConvBlock):
            normal.append((p + "weight", m.weight.shape[0] * m.weight[0, 0].numel() / 2.0))
        elif isinstance(m, BN):
            ones += [p + "weight", p + "running_var"]
            zeros += [p + "bias", p + "running_mean"]
    return normal, zeros, ones


LOGIT_LAYERS = ([f"bbox_head{i}.fc_cls" for i in range(3)]
                + [f"mask_head{i}.conv_logits" for i in range(3)])
CALIBRATION_FRAME = 1 << 20     # the index of the calibration sample, past any pool's
# the calibrated logit layers of each (configuration, seed, device), made once a process,
# so that the program's and the judge's weights are the same draw
_CALIBRATED: Dict[tuple, Dict[str, torch.Tensor]] = {}


def _logit_stats(cfg_file: Mapping[str, Any], seed: int, state, device):
    """(mean, std) of each logit layer's outputs per class over one
    calibration sample, made by the reference on ``state``: each cascade
    stage's class logits over the valid proposals it sees, each mask head's
    over the final stage's boxes of up to 256 valid proposals an image."""
    from benchmark.reference import masks
    from benchmark.reference.models import htc

    ref = reference_model(cfg_file, device)
    ref.load_state_dict(state, strict=True)
    ref.eval()
    frame = make_frame(cfg_file, None, seed, CALIBRATION_FRAME,
                       cfg_file["weights"]["calibration_objects"], device)
    outs: Dict[str, list] = {n: [] for n in LOGIT_LAYERS}
    mean = torch.tensor(htc.IMG_MEAN, device=device)
    std = torch.tensor(htc.IMG_STD, device=device)
    with torch.inference_mode(), htc.f32():
        for img in torch.from_numpy(masks.pad(frame.images)).to(device):
            x = ((img - mean) / std).permute(2, 0, 1)[None].contiguous()
            hw = tuple(x.shape[2:])
            pyramid = ref.neck(ref.backbone(x))
            rois, valid = ref.proposals(pyramid, hw)
            _, sem = ref.semantic_head(pyramid)
            for i in range(3):
                feats = ref.roi_feats(pyramid, sem, rois, valid, 7)
                cls, reg = getattr(ref, f"bbox_head{i}")(feats)
                outs[f"bbox_head{i}.fc_cls"].append(cls[valid])
                rois = htc.decode(rois, reg, htc.STAGE_STDS[i], hw)
            rois = rois[valid][:256]
            feats = ref.roi_feats(pyramid, sem, rois, torch.ones_like(rois[:, 0], dtype=torch.bool),
                                  14)
            res = None
            for i in range(3):
                lg, res = getattr(ref, f"mask_head{i}")(feats, res)
                outs[f"mask_head{i}.conv_logits"].append(lg.transpose(0, 1).flatten(1).T)
    return {n: (torch.cat(v).double().mean(0), torch.cat(v).double().std(0))
            for n, v in outs.items()}


def make_state(cfg_file: Mapping[str, Any], seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights of ``seed`` on ``device``: a full ``state_dict`` of the
    reference's HTC, whose names the program's shares. The logit layers are
    then calibrated on one sample of the seed's own (``_logit_stats``):
    each class's logits moved and scaled to mean 0 and the configuration's
    ``cls_logit_std`` (cascade stages) or ``mask_logit_std`` (mask heads).
    A random network tilts every RoI toward the classes its draw favours,
    so that without this one seed detects nothing and the next fills every
    camera's 100 with empty masks."""
    w = cfg_file["weights"]
    state = weights.make_state(reference_model(cfg_file, "meta"), seed, device,
                               functools.partial(_layout, w=w))
    key = (cfg_file["name"], seed, str(device))
    if key not in _CALIBRATED:
        layers = {}
        for name, (mu, sd) in _logit_stats(cfg_file, seed, state, device).items():
            std = w["cls_logit_std" if "fc_cls" in name else "mask_logit_std"]
            scale = std / sd.clamp_min(1e-12)
            wt = state[f"{name}.weight"].double()
            layers[f"{name}.weight"] = (wt * scale.view(-1, *[1] * (wt.dim() - 1))).float()
            layers[f"{name}.bias"] = (-mu * scale).float()
        _CALIBRATED[key] = layers
    state.update({k: v.clone() for k, v in _CALIBRATED[key].items()})
    return state


# --- frames ----------------------------------------------------------------

@dataclass
class Frame:
    index: int                 # position in the pool
    objects: int               # GT boxes placed in the scene
    images: np.ndarray         # [cams, H, W, 3] uint8 RGB on the host
    tool: Dict[str, Any]       # the mask tool's score_thr, max_anno, num_classes
    judge: Dict[str, float]    # box_gap_px, score_gap


# a camera's noise: each pixel and channel moved by a uniform integer in [-8, 8], so that no
# two RoIs see the same pixels (on flat fills a random network's RoIs on the anchor lattice
# tie to f32 rounding, and NMS then chooses among them by rounding alone)
PIXEL_NOISE = 8


def _images(rects, rng: np.random.Generator, num_cams: int, h: int, w: int) -> np.ndarray:
    """A smooth background (a 9 × 16 grid of colours a camera, resized
    bilinearly) with each rectangle filled in a colour of its own, and
    ``PIXEL_NOISE`` over all."""
    grid = torch.from_numpy(rng.uniform(0.0, 255.0, (num_cams, 3, 9, 16)).astype(np.float32))
    bg = F.interpolate(grid, size=(h, w), mode="bilinear", align_corners=False)
    img = bg.round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous().numpy()
    for _, cam, v0, v1, u0, u1, _, _ in rects:
        img[cam, v0:v1, u0:u1] = rng.integers(0, 256, 3, dtype=np.uint8)
    noise = rng.integers(-PIXEL_NOISE, PIXEL_NOISE + 1, img.shape, dtype=np.int16)
    return np.clip(img + noise, 0, 255).astype(np.uint8)


def make_frame(cfg_file: Mapping[str, Any], traffic: Mapping[str, Any], seed: int, i: int,
               objects: int, device) -> Frame:
    """Sample ``i`` of the pool: the configuration's LiDAR scene of
    ``objects`` boxes from ``(seed, i)`` (the FSF cells' scenes), its boxes
    seen by the cameras, painted into six images on the host."""
    sc_cfg = dict(cfg_file["scene"])
    if sc_cfg.pop("generator") != "lidar_scene":
        raise ValueError("unknown scene generator")
    fseed = traffic_mod.frame_seed(seed, i)
    cam = cfg_file["cameras"]
    sc = scenes.make_lidar_scene_arrays(seed=fseed, n_boxes=objects,
                                        num_classes=cfg_file["model"]["num_classes"], **sc_cfg)
    _, _, rects = scenes.camera_rectangles(sc["gt_boxes"], sc["gt_labels"], sc["gt_valid"],
                                           batch_size=1, **cam)
    rng = np.random.default_rng([fseed, 1])
    images = _images(rects, rng, cam["num_cams"], cam["img_h"], cam["img_w"])
    tool = dict(cfg_file["tool"], num_classes=cfg_file["model"]["num_classes"])
    return Frame(i, objects, images, tool, dict(cfg_file["judge"]))


# --- serving ---------------------------------------------------------------

def serve_one(model, frame: Frame, device):
    """One sample through the mask tool: (planes, anno) on the host, and the
    detections they were made from."""
    from fullysparsefusion_tpu_torch import generate_masks as gm

    t = frame.tool
    planes, anno = gm.sample_masks(model, frame.images, t["score_thr"], t["num_classes"],
                                   t["max_anno"])
    return dict(planes=planes, anno=anno, dets=model.served)


def failed(answer) -> bool:
    return not (np.isfinite(answer["anno"]).all()
                and all(bool(torch.isfinite(d.scores).all() and torch.isfinite(d.boxes).all()
                             and torch.isfinite(d.masks).all()) for d in answer["dets"]))


def serve_spans(spans, model) -> None:
    """The spans of dcn_ms.serve (every deformable conv), roi_align_ms.serve
    (``HTC.roi_feats``) and paste_ms.serve (the tool's paste and paint)."""
    from fullysparsefusion_tpu_torch import generate_masks as gm
    from fullysparsefusion_tpu_torch.models.htc import DeformConvBlock

    for m in model.modules():
        if isinstance(m, DeformConvBlock):
            spans.module("dcn", m)
    spans.method("roi_align", model, "roi_feats")
    for name in ("paste_detections", "paint_sample"):
        setattr(gm, name, inspect.unwrap(getattr(gm, name)))   # one wrapper a process
        spans.method("paste", gm, name)


def reference_answer(ref, frame: Frame, device):
    """The reference's detections of ``frame`` and its planes and anno."""
    from benchmark.reference import masks
    from benchmark.reference.models import htc

    n, h, w, _ = frame.images.shape
    with torch.inference_mode(), htc.f32():
        dets = ref(torch.from_numpy(masks.pad(frame.images)).to(device))
    host = [{k: getattr(d, k).cpu().numpy() for k in d._fields} for d in dets]
    t = frame.tool
    kept = masks.paste(host, (h, w), t["score_thr"])
    planes, anno = masks.paint(kept, n, t["num_classes"], (h, w), t["max_anno"])
    return dict(planes=planes, anno=anno, dets=dets, tool=t, judge=frame.judge)


def _kept(dets, score_thr: float):
    """Per camera: (boxes [n, 4] f64, scores [n] f64, labels [n], masks [n,
    784] f64) of the valid detections scoring at least ``score_thr``."""
    out = []
    for d in dets:
        k = (d.valid & (d.scores >= score_thr)).cpu()
        out.append((d.boxes.cpu()[k].double(), d.scores.cpu()[k].double(), d.labels.cpu()[k],
                    d.masks.cpu()[k].double().flatten(1)))
    return out


def _one_way(a, b, box_gap: float, score_gap: float):
    """For each detection of ``a`` (one camera): whether it moved, and the
    mask gap to its match (0 where it moved)."""
    ba, sa, la, ma = a
    bb, sb, lb, mb = b
    if len(ba) == 0:
        return torch.zeros(0, dtype=torch.bool), torch.zeros(0, dtype=torch.float64)
    if len(bb) == 0:
        return torch.ones(len(ba), dtype=torch.bool), torch.zeros(len(ba), dtype=torch.float64)
    gap = torch.maximum((ba[:, None] - bb[None]).abs().amax(-1) / box_gap,
                        (sa[:, None] - sb[None]).abs() / score_gap)
    gap = torch.where(la[:, None] == lb[None], gap, torch.full_like(gap, math.inf))
    best, at = gap.min(1)
    moved = best > 1.0
    mask = (ma - mb[at]).abs().amax(1)
    return moved, torch.where(moved, torch.zeros_like(mask), mask)


def _anno_match(a: np.ndarray, b: np.ndarray, box_gap: float, score_gap: float) -> np.ndarray:
    """For each row of anno table ``a``: the row of ``b`` that it matches
    (valid, same camera and category, the nearest within ``box_gap`` in
    every box coordinate and ``score_gap`` in score), or -1; -1 for the
    invalid rows of ``a``."""
    ia, ib = np.flatnonzero(a[:, 8] == 1), np.flatnonzero(b[:, 8] == 1)
    match = np.full(len(a), -1)
    if len(ia) and len(ib):
        ra, rb = a[ia].astype(np.float64), b[ib].astype(np.float64)
        gap = np.maximum(np.abs(ra[:, None, :4] - rb[None, :, :4]).max(-1) / box_gap,
                         np.abs(ra[:, None, 4] - rb[None, :, 4]) / score_gap)
        same = (ra[:, None, 5] == rb[None, :, 5]) & (ra[:, None, 6] == rb[None, :, 6])
        gap = np.where(same, gap, np.inf)
        at = gap.argmin(1)
        hit = gap[np.arange(len(ia)), at] <= 1.0
        match[ia[hit]] = ib[at[hit]]
    return match


def _row_lut(match: np.ndarray) -> np.ndarray:
    """Pixel value (row + 1, 0 unpainted) → the other side's row + 1 where
    the row matched, else -1."""
    lut = np.full(256, -1, np.int16)
    lut[0] = 0
    rows = np.flatnonzero(match >= 0)
    lut[rows + 1] = match[rows] + 1
    return lut


def _tool_numbers(want, got, box_gap: float, score_gap: float) -> Dict[str, float]:
    """``anno_moved`` and ``paint_gap`` of one sample's anno tables and
    planes."""
    g2w = _anno_match(got["anno"], want["anno"], box_gap, score_gap)
    w2g = _anno_match(want["anno"], got["anno"], box_gap, score_gap)
    valid = int((got["anno"][:, 8] == 1).sum() + (want["anno"][:, 8] == 1).sum())
    unmatched = int((got["anno"][:, 8] == 1).sum() - (g2w >= 0).sum()
                    + (want["anno"][:, 8] == 1).sum() - (w2g >= 0).sum())
    lut_g = _row_lut(g2w)
    lut_w = _row_lut(np.where(w2g >= 0, np.arange(len(w2g)), -1))
    seen = differ = 0
    for pg, pw in zip(got["planes"], want["planes"]):          # a camera at a time
        g, w = lut_g[pg], lut_w[pw]
        both = ((g != 0) | (w != 0)) & (g != -1) & (w != -1)
        seen += int(both.sum())
        differ += int((both & (g != w)).sum())
    return {"anno_moved": unmatched / valid if valid else 0.0,
            "paint_gap": differ / seen if seen else 0.0}


def served_numbers(want, got) -> Dict[str, float]:
    """The numbers compared for one served sample, by the limits' names."""
    thr, j = want["tool"]["score_thr"], want["judge"]
    moved, gaps = [], []
    for a, b in zip(_kept(want["dets"], thr), _kept(got["dets"], thr)):
        for x, y in ((a, b), (b, a)):
            m, g = _one_way(x, y, j["box_gap_px"], j["score_gap"])
            moved.append(m)
            gaps.append(g)
    moved, gaps = torch.cat(moved), torch.cat(gaps)
    return {"moved_share": float(moved.double().mean()) if len(moved) else 0.0,
            "mask_gap": float(gaps.max()) if len(gaps) else 0.0,
            **_tool_numbers(want, got, j["box_gap_px"], j["score_gap"])}


# --- work --------------------------------------------------------------------

def _conv_flop(x, out, weight, transposed: bool) -> float:
    if transposed:                       # every input pixel meets the whole kernel
        return 2.0 * x.numel() * weight[0].numel()
    return 2.0 * out.numel() * weight[0].numel()


class WorkCount:
    """Counts the work of the reference's passes while it is attached
    (``costs.WorkCount``'s interface: ``totals()``, ``detach()``).

    Operations: a dense or grouped convolution ``2 · out · (Cin / groups) ·
    kh · kw`` (a transposed one ``2 · in · Cout · kh · kw``), a linear layer
    ``2 · rows · in · out``, a deformable convolution its contraction ``2 ·
    out · (Cin / groups) · 9`` plus its sampling, 4 corners × 2 operations
    for each of the ``9 · Cin`` samples of an output pixel, and RoIAlign 4
    samples × 4 corners × 2 operations for each output value (the FPN level's
    and the semantic embedding's). Bytes (f32): each layer's input and
    output once, its weights once; RoIAlign the corners it reads and its
    output."""

    def __init__(self, model: nn.Module, training: bool = False):
        from benchmark.reference.models.htc import DeformConvBlock

        self.flop = dict(conv=0.0, dcn=0.0, linear=0.0, roi_align=0.0)
        self.bytes = 0.0
        self._handles = []
        self._model = model
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                self._handles.append(m.register_forward_hook(self._conv))
            elif isinstance(m, nn.Linear):
                self._handles.append(m.register_forward_hook(self._linear))
            elif isinstance(m, DeformConvBlock):
                self._handles.append(m.register_forward_hook(self._dcn))
        roi_feats = model.roi_feats

        def counted(pyramid, sem, rois, valid, out_size):
            out = roi_feats(pyramid, sem, rois, valid, out_size)
            c = out.shape[1]
            for size in (out_size, 14):     # the FPN level's, the semantic embedding's
                values = rois.shape[0] * size * size * c
                self.flop["roi_align"] += 32.0 * values
                self.bytes += 4.0 * (16 + 1) * values
            return out

        model.roi_feats = counted

    def _conv(self, m, args, out):
        x = args[0]
        self.flop["conv"] += _conv_flop(x, out, m.weight, isinstance(m, nn.ConvTranspose2d))
        self.bytes += 4.0 * (x.numel() + out.numel() + m.weight.numel())

    def _linear(self, m, args, out):
        x = args[0]
        self.flop["linear"] += 2.0 * (x.numel() // x.shape[-1]) * m.in_features * m.out_features
        self.bytes += 4.0 * (x.numel() + out.numel() + m.weight.numel())

    def _dcn(self, m, args, out):
        x = args[0]
        n, cin = x.shape[:2]
        pixels = out.numel() // out.shape[1]
        self.flop["dcn"] += 2.0 * out.numel() * m.weight[0].numel() + 8.0 * pixels * 9 * cin
        self.bytes += 4.0 * (x.numel() + 18 * pixels + out.numel() + m.weight.numel())

    def detach(self) -> None:
        for h in self._handles:
            h.remove()
        del self._model.roi_feats

    def totals(self) -> Dict[str, float]:
        return dict(flop=sum(self.flop.values()), bytes=self.bytes,
                    **{f"{k}_flop": v for k, v in self.flop.items()})


def work_count(ref, training: bool = False) -> WorkCount:
    return WorkCount(ref, training)


# --- calibration (calibrate.py): each entered around one run ----------------

def _tf32_conv(m: nn.Conv2d, x):
    from benchmark.reference.precision import round_tf32

    return F.conv2d(round_tf32(x), round_tf32(m.weight), m.bias, m.stride, m.padding,
                    m.dilation, m.groups)


def _tf32_deconv(m: nn.ConvTranspose2d, x):
    from benchmark.reference.precision import round_tf32

    return F.conv_transpose2d(round_tf32(x), round_tf32(m.weight), m.bias, m.stride, m.padding,
                              m.output_padding, m.groups, m.dilation)


def _tf32_linear(m: nn.Linear, x):
    from benchmark.reference.precision import round_tf32

    return F.linear(round_tf32(x), round_tf32(m.weight), m.bias)


def lower_to_tf32(model: nn.Module) -> nn.Module:
    """Every convolution, deformable contraction and linear layer of the
    reference ``model`` with its operands rounded to TF32 (the control)."""
    from benchmark.reference.models.htc import DeformConvBlock
    from benchmark.reference.precision import round_tf32

    for m in model.modules():
        if isinstance(m, nn.ConvTranspose2d):
            m.forward = functools.partial(_tf32_deconv, m)
        elif isinstance(m, nn.Conv2d):
            m.forward = functools.partial(_tf32_conv, m)
        elif isinstance(m, nn.Linear):
            m.forward = functools.partial(_tf32_linear, m)
        elif isinstance(m, DeformConvBlock):
            m.operand = round_tf32
    return model


@contextlib.contextmanager
def control():
    """The control in the program's place: the reference with TF32
    operands, serving through the reference's mask tool; the judge's own
    reference runs in the configuration's f32."""
    g = globals()
    saved = {k: g[k] for k in ("program_model", "serve_one")}

    def lowered(cfg_file, state, device):
        m = reference_model(cfg_file, device)
        m.load_state_dict(state, strict=True)
        return lower_to_tf32(m).eval()

    g.update(program_model=lowered, serve_one=lambda model, frame, device:
             reference_answer(model, frame, device))
    try:
        yield
    finally:
        g.update(saved)


@contextlib.contextmanager
def fault(kind: str):
    """The program with fault ``kind``: ``dcn_offsets_ignored`` (every
    deformable conv samples the plain 3 × 3 grid), ``roi_align_unaligned``
    (RoIAlign without its half-pixel offset, mmcv's ``aligned=False``) or
    ``paste_offset`` (every pasted mask placed one pixel right of its box's
    corner, clipped to the canvas)."""
    from fullysparsefusion_tpu_torch import generate_masks as gm
    from fullysparsefusion_tpu_torch.models import htc
    from fullysparsefusion_tpu_torch.ops import roi_align

    if kind == "dcn_offsets_ignored":
        owner, name = htc, "deform_conv2d"
        fn = getattr(owner, name)

        def planted(x, offsets, *a, **k):
            return fn(x, torch.zeros_like(offsets), *a, **k)
    elif kind == "roi_align_unaligned":
        owner, name = roi_align, "_pool"
        fn = getattr(owner, name)

        def planted(flat, base, h, w, rois, scale, *a):
            return fn(flat, base, h, w, rois + 0.5 / scale[:, None], scale, *a)
    elif kind == "paste_offset":
        owner, name = gm, "paste_detections"
        fn = getattr(owner, name)

        def planted(dets, img_hw, *a, **k):
            out = fn(dets, img_hw, *a, **k)
            for d in out:
                yy, xx = d["offset"]
                d["offset"] = (yy, xx + 1)
                d["mask"] = d["mask"][:, :max(0, img_hw[1] - xx - 1)]
            return out
    else:
        raise ValueError(f"unknown fault {kind!r}")
    setattr(owner, name, planted)
    try:
        yield
    finally:
        setattr(owner, name, fn)
