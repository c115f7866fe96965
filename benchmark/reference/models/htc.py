"""Hybrid Task Cascade (Chen et al. 2019, arXiv 1901.07518) for inference, as FSF's mask
tool runs it: the benchmark's plain reference of the program's
``models/htc.py`` (``htc_x101_64x4d_fpn_dconv_c3-c5`` on nuImages).

ResNeXt-101 64×4d (frozen BN) with DCNv1 in every 3 × 3 of stages c3–c5 →
FPN P2–P6 → RPN (per level: top ``rpn_pre_nms`` by sigmoid score, decode,
greedy NMS at IoU 0.7; then the top ``num_proposals`` kept) → three cascade
box stages on 7 × 7 RoIAlign features plus the fused semantic embedding's →
per-class greedy NMS at IoU 0.5 (scores over 0.001), top ``max_dets`` → three
mask heads with mask-information flow on 14 × 14 features → 28 × 28
probabilities for each detection's class.

The submodules carry the program's names, so one ``state_dict`` loads both.
Plain ``torch`` in f32, NCHW, one image at a time; the deformable
convolutions by their definition (``ops/dcn.py``), RoIAlign as mmcv's
(``ops/roi_align.py``), NMS as a greedy scan on the host
(``ops/nms_2d.py``). Run it with TF32 off (``torch.backends.cudnn.allow_tf32``
and ``torch.backends.cuda.matmul.allow_tf32`` False): :func:`f32` does so.

Departures from mmdet's HTC, all the program's as well:

- images are zero-padded to a multiple of 32 before they are normalized
  (mmdet pads the normalized image with 0);
- the fused semantic head resizes the levels bilinearly with antialiasing
  and half-pixel centres (mmdet: ``align_corners=True``, no antialiasing);
- a box's scores are the mean of the three stages' softmax (mmdet: the
  softmax of the stages' mean logits), and its mask the sigmoid of the
  three heads' mean logits (mmdet: the mean of their sigmoids);
- decoded boxes are clipped to ``[0, W − 1] × [0, H − 1]`` of the padded
  image (mmdet 2.x: ``[0, W] × [0, H]`` of the image);
- RoIAlign takes 2 × 2 samples per bin (mmdet: ``sampling_ratio=0``);
- the RPN keeps the top ``rpn_pre_nms`` of each level before its NMS and
  drops no small box (``min_bbox_size`` 0, as configured).
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import dcn, nms_2d, roi_align

IMG_MEAN = (123.675, 116.28, 103.53)
IMG_STD = (58.395, 57.12, 57.375)
STRIDES = (4, 8, 16, 32, 64)
STAGE_STDS = ((0.1, 0.1, 0.2, 0.2), (0.05, 0.05, 0.1, 0.1), (0.033, 0.033, 0.067, 0.067))
MAX_RATIO = abs(math.log(16.0 / 1000.0))


@contextlib.contextmanager
def f32():
    """Convolutions and matmuls in f32 (TF32 off) inside the block; the
    flags as they were after it."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


class BN(nn.Module):
    """Frozen BatchNorm: (x − mean) / √(var + 1e-5) · weight + bias."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        shape = (1, -1, 1, 1)
        return (x - self.running_mean.view(shape)) / torch.sqrt(self.running_var.view(shape)
                                                                + 1e-5) \
            * self.weight.view(shape) + self.bias.view(shape)


class DeformConvBlock(nn.Module):
    """DCNv1 3 × 3, one deformable group, ``groups`` conv groups; the
    offsets from a plain 3 × 3 conv (``conv_offset``) to 18 channels."""

    def __init__(self, cin: int, cout: int, stride: int = 1, groups: int = 1):
        super().__init__()
        self.stride, self.groups = stride, groups
        self.conv_offset = nn.Conv2d(cin, 18, 3, stride, 1)
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, 3, 3))
        # applied to both operands of each tap's contraction (the control's rounding)
        self.operand: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    def forward(self, x):
        return dcn.deform_conv2d(x, self.conv_offset(x), self.weight, self.stride, 1,
                                 self.groups, self.operand)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, mid: int, out: int, stride: int, groups: int, dcn_on: bool,
                 downsample: bool):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, mid, 1, bias=False)
        self.bn1 = BN(mid)
        self.conv2 = (DeformConvBlock(mid, mid, stride, groups) if dcn_on else
                      nn.Conv2d(mid, mid, 3, stride, 1, groups=groups, bias=False))
        self.bn2 = BN(mid)
        self.conv3 = nn.Conv2d(mid, out, 1, bias=False)
        self.bn3 = BN(out)
        if downsample:
            self.ds_conv = nn.Conv2d(cin, out, 1, stride, bias=False)
            self.ds_bn = BN(out)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        shortcut = self.ds_bn(self.ds_conv(x)) if hasattr(self, "ds_conv") else x
        return F.relu(y + shortcut)


class ResNeXt(nn.Module):
    """ResNeXt 64 × 4d (the stride on the 3 × 3) → C2–C5."""

    def __init__(self, depth_blocks: Sequence[int], groups: int = 64, base_width: int = 4,
                 stage_with_dcn: Sequence[bool] = (False, True, True, True)):
        super().__init__()
        self.depth_blocks = tuple(depth_blocks)
        self.stem_conv = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.stem_bn = BN(64)
        cin = 64
        for si, n in enumerate(self.depth_blocks):
            planes = 64 * 2 ** si
            mid = planes * base_width // 64 * groups
            for bi in range(n):
                self.add_module(f"layer{si + 1}_{bi}", Bottleneck(
                    cin, mid, planes * 4, 2 if (bi == 0 and si > 0) else 1, groups,
                    stage_with_dcn[si], bi == 0))
                cin = planes * 4

    def forward(self, x) -> List[torch.Tensor]:
        x = F.max_pool2d(F.relu(self.stem_bn(self.stem_conv(x))), 3, 2, 1)
        outs = []
        for si, n in enumerate(self.depth_blocks):
            for bi in range(n):
                x = getattr(self, f"layer{si + 1}_{bi}")(x)
            outs.append(x)
        return outs


class FPN(nn.Module):
    """1 × 1 laterals, top-down nearest × 2 (cropped to the finer level),
    3 × 3 outputs; P6 takes every second pixel of P5."""

    def __init__(self, in_channels=(256, 512, 1024, 2048), out_channels: int = 256):
        super().__init__()
        for i, c in enumerate(in_channels):
            self.add_module(f"lateral{i}", nn.Conv2d(c, out_channels, 1))
            self.add_module(f"fpn{i}", nn.Conv2d(out_channels, out_channels, 3, 1, 1))

    def forward(self, cs):
        lat = [getattr(self, f"lateral{i}")(c) for i, c in enumerate(cs)]
        for i in range(len(lat) - 1, 0, -1):
            h, w = lat[i - 1].shape[2:]
            up = lat[i].repeat_interleave(2, 2).repeat_interleave(2, 3)
            lat[i - 1] = lat[i - 1] + up[:, :, :h, :w]
        outs = [getattr(self, f"fpn{i}")(x) for i, x in enumerate(lat)]
        return outs + [outs[-1][:, :, ::2, ::2]]


class RPNHead(nn.Module):
    def __init__(self, anchors: int = 3, channels: int = 256):
        super().__init__()
        self.rpn_conv = nn.Conv2d(channels, 256, 3, 1, 1)
        self.rpn_cls = nn.Conv2d(256, anchors, 1)
        self.rpn_reg = nn.Conv2d(256, anchors * 4, 1)

    def forward(self, x):
        h = F.relu(self.rpn_conv(x))
        return self.rpn_cls(h), self.rpn_reg(h)


class Shared2FCBBoxHead(nn.Module):
    def __init__(self, num_classes: int, in_features: int = 256 * 7 * 7):
        super().__init__()
        self.fc1 = nn.Linear(in_features, 1024)
        self.fc2 = nn.Linear(1024, 1024)
        self.fc_cls = nn.Linear(1024, num_classes + 1)     # background last
        self.fc_reg = nn.Linear(1024, 4)                   # class-agnostic

    def forward(self, feats):                              # [N, 256, 7, 7]
        x = F.relu(self.fc2(F.relu(self.fc1(feats.flatten(1)))))
        return self.fc_cls(x), self.fc_reg(x)


class HTCMaskHead(nn.Module):
    def __init__(self, num_classes: int, with_conv_res: bool):
        super().__init__()
        if with_conv_res:
            self.conv_res = nn.Conv2d(256, 256, 1)
        for i in range(4):
            self.add_module(f"conv{i}", nn.Conv2d(256, 256, 3, 1, 1))
        self.upsample = nn.ConvTranspose2d(256, 256, 2, 2)
        self.conv_logits = nn.Conv2d(256, num_classes, 1)

    def forward(self, x, res_feat=None):
        if res_feat is not None:
            x = x + F.relu(self.conv_res(res_feat))
        for i in range(4):
            x = F.relu(getattr(self, f"conv{i}")(x))
        return self.conv_logits(F.relu(self.upsample(x))), x


def resize_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_out, n_in] weights of a half-pixel-centred linear resize with a
    triangle of half-width max(n_in / n_out, 1) input pixels, each row
    normalized over the taps inside the map (antialiased when shrinking)."""
    scale = n_in / n_out
    support = max(scale, 1.0)
    centre = (np.arange(n_out) + 0.5) * scale
    src = np.arange(n_in) + 0.5
    wts = np.clip(1.0 - np.abs(src[None, :] - centre[:, None]) / support, 0.0, None)
    wts = wts / wts.sum(1, keepdims=True)
    return torch.tensor(wts, dtype=torch.float32, device=device)


class FusedSemanticHead(nn.Module):
    """Every level resized to P3 and its 1 × 1 lateral summed, four 3 × 3
    convs → (logits, the 256-channel embedding that the RoI heads read)."""

    def __init__(self, num_ins: int = 5, fusion_level: int = 1, num_classes: int = 32):
        super().__init__()
        self.num_ins, self.fusion_level = num_ins, fusion_level
        for i in range(num_ins):
            self.add_module(f"lateral{i}", nn.Conv2d(256, 256, 1))
        for i in range(4):
            self.add_module(f"conv{i}", nn.Conv2d(256, 256, 3, 1, 1))
        self.conv_logits = nn.Conv2d(256, num_classes, 1)
        self.conv_embedding = nn.Conv2d(256, 256, 1)

    def forward(self, feats):
        fl = self.fusion_level
        x = getattr(self, f"lateral{fl}")(feats[fl])
        h, w = x.shape[2:]
        for i in range(self.num_ins):
            if i == fl:
                continue
            f = feats[i]
            ry = resize_matrix(f.shape[2], h, f.device)
            rx = resize_matrix(f.shape[3], w, f.device)
            f = torch.einsum("yi,ncij,xj->ncyx", ry, f, rx)
            x = x + getattr(self, f"lateral{i}")(f)
        for i in range(4):
            x = F.relu(getattr(self, f"conv{i}")(x))
        return self.conv_logits(x), self.conv_embedding(x)


class Detections(NamedTuple):
    boxes: torch.Tensor    # [D, 4] xyxy, padded-image pixels
    scores: torch.Tensor   # [D]
    labels: torch.Tensor   # [D] nuImages class
    masks: torch.Tensor    # [D, 28, 28] probabilities inside the box
    valid: torch.Tensor    # [D] bool


def anchors(stride: int, h: int, w: int, device) -> torch.Tensor:
    """mmdet's anchors of one level (scale 8, ratios 0.5, 1, 2, centre
    offset 0), ordered (row, column, anchor) → [H·W·3, 4]."""
    base = []
    for r in (0.5, 1.0, 2.0):
        hr = math.sqrt(r)
        ws, hs = stride * 8.0 / hr, stride * 8.0 * hr
        base.append([-0.5 * ws, -0.5 * hs, 0.5 * ws, 0.5 * hs])
    base = torch.tensor(base, dtype=torch.float32, device=device)
    sy, sx = torch.meshgrid(torch.arange(h, device=device, dtype=torch.float32) * stride,
                            torch.arange(w, device=device, dtype=torch.float32) * stride,
                            indexing="ij")
    shifts = torch.stack([sx, sy, sx, sy], -1).reshape(-1, 1, 4)
    return (shifts + base[None]).reshape(-1, 4)


def decode(rois: torch.Tensor, deltas: torch.Tensor, stds, hw: Tuple[int, int]) -> torch.Tensor:
    """mmdet's ``delta2bbox`` (means 0), clipped to the padded image."""
    d = deltas * torch.tensor(stds, dtype=deltas.dtype, device=deltas.device)
    px, py = (rois[:, 0] + rois[:, 2]) * 0.5, (rois[:, 1] + rois[:, 3]) * 0.5
    pw, ph = rois[:, 2] - rois[:, 0], rois[:, 3] - rois[:, 1]
    dw, dh = d[:, 2].clamp(-MAX_RATIO, MAX_RATIO), d[:, 3].clamp(-MAX_RATIO, MAX_RATIO)
    gx, gy = px + pw * d[:, 0], py + ph * d[:, 1]
    gw, gh = pw * dw.exp(), ph * dh.exp()
    h, w = hw
    return torch.stack([(gx - 0.5 * gw).clamp(0, w - 1), (gy - 0.5 * gh).clamp(0, h - 1),
                        (gx + 0.5 * gw).clamp(0, w - 1), (gy + 0.5 * gh).clamp(0, h - 1)], -1)


def _top(values: torch.Tensor, k: int):
    """The ``k`` largest, the lower index first among ties."""
    order = torch.sort(values, descending=True, stable=True).indices[:k]
    return values[order], order


class HTC(nn.Module):
    """One image at a time: ``forward(images [N, H, W, 3])`` (RGB 0–255, H
    and W multiples of 32) → one :class:`Detections` per image."""

    def __init__(self, num_classes: int = 10, num_proposals: int = 1000, rpn_pre_nms: int = 1000,
                 max_dets: int = 100, depth_blocks: Tuple[int, ...] = (3, 4, 23, 3)):
        super().__init__()
        self.num_classes, self.num_proposals = num_classes, num_proposals
        self.rpn_pre_nms, self.max_dets = rpn_pre_nms, max_dets
        self.backbone = ResNeXt(depth_blocks)
        self.neck = FPN()
        self.rpn_head = RPNHead()
        for i in range(3):
            self.add_module(f"bbox_head{i}", Shared2FCBBoxHead(num_classes))
            self.add_module(f"mask_head{i}", HTCMaskHead(num_classes, i > 0))
        self.semantic_head = FusedSemanticHead()

    def proposals(self, pyramid, hw):
        """RPN proposals of one image → (boxes [P, 4], valid [P])."""
        boxes, scores = [], []
        for stride, p in zip(STRIDES, pyramid):
            cls, reg = self.rpn_head(p)
            score = torch.sigmoid(cls[0].permute(1, 2, 0).reshape(-1))
            delta = reg[0].permute(1, 2, 0).reshape(-1, 4)
            top, idx = _top(score, self.rpn_pre_nms)
            b = decode(anchors(stride, *p.shape[2:], p.device)[idx], delta[idx],
                       (1.0, 1.0, 1.0, 1.0), hw)
            keep = nms_2d.greedy_keep(nms_2d.iou_2d(b, b).cpu().numpy(), top.cpu().numpy(),
                                      np.ones(len(top), bool), 0.7)
            boxes.append(b)
            scores.append(torch.where(torch.as_tensor(keep, device=b.device), top,
                                      torch.full_like(top, -1.0)))
        top, idx = _top(torch.cat(scores), self.num_proposals)
        return torch.cat(boxes)[idx], top > 0.0

    def roi_feats(self, pyramid, sem, rois, valid, out_size: int):
        """FPN RoIAlign (P2–P5, each RoI from its level) plus the semantic
        embedding's at 14 × 14, averaged down to ``out_size`` → [N, C, out, out]."""
        maps = [p[0].permute(1, 2, 0) for p in pyramid[:4]]
        f = roi_align.multilevel_roi_align(maps, STRIDES[:4], rois, valid, out_size)
        s = roi_align.roi_align(sem[0].permute(1, 2, 0), rois, valid, 14, 1.0 / 8.0)
        if out_size != 14:
            s = F.adaptive_avg_pool2d(s.permute(0, 3, 1, 2), out_size).permute(0, 2, 3, 1)
        return (f + s).permute(0, 3, 1, 2)

    def class_nms(self, rois, scores, valid) -> Detections:
        """Greedy NMS per class at IoU 0.5 over the scores above 0.001, then
        the top ``max_dets`` of the kept (class, box) scores, class-major
        order among ties."""
        p, c = rois.shape[0], self.num_classes
        iou = nms_2d.iou_2d(rois, rois).cpu().numpy()
        sc = scores[:, :c].T.contiguous()                   # [C, P]
        sc_h, ok = sc.cpu().numpy(), (valid[None] & (sc > 0.001)).cpu().numpy()
        keep = np.stack([nms_2d.greedy_keep(iou, sc_h[k], ok[k], 0.5) for k in range(c)])
        kept = torch.where(torch.as_tensor(keep, device=sc.device), sc, torch.full_like(sc, -1.0))
        top, idx = _top(kept.reshape(-1), self.max_dets)
        return Detections(rois[idx % p], top, (idx // p).to(torch.int32),
                          rois.new_zeros(len(idx), 28, 28), top > 0.0)

    def image(self, img: torch.Tensor) -> Detections:
        """One padded image [1, 3, H, W] (normalized) → its detections."""
        hw = tuple(img.shape[2:])
        pyramid = self.neck(self.backbone(img))
        rois, valid = self.proposals(pyramid, hw)
        _, sem = self.semantic_head(pyramid)
        probs = []
        for i in range(3):
            cls, reg = getattr(self, f"bbox_head{i}")(self.roi_feats(pyramid, sem, rois, valid, 7))
            probs.append(torch.softmax(cls, -1))
            rois = decode(rois, reg, STAGE_STDS[i], hw)
        det = self.class_nms(rois, (probs[0] + probs[1] + probs[2]) / 3.0, valid)
        x = self.roi_feats(pyramid, sem, det.boxes, det.valid, 14)
        logits, feat = [], None
        for i in range(3):
            lg, feat = getattr(self, f"mask_head{i}")(x, feat)
            logits.append(lg)
        mask = torch.sigmoid((logits[0] + logits[1] + logits[2]) / 3.0)
        return det._replace(masks=mask[torch.arange(len(mask), device=mask.device),
                                       det.labels.long()])

    def forward(self, images: torch.Tensor) -> List[Detections]:
        mean = torch.tensor(IMG_MEAN, device=images.device)
        std = torch.tensor(IMG_STD, device=images.device)
        out = []
        for img in images:
            x = ((img.float() - mean) / std).permute(2, 0, 1)[None].contiguous()
            out.append(self.image(x))
        return out
