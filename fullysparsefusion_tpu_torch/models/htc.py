"""Hybrid Task Cascade (HTC) 2D instance segmentation, inference only (port
of ``models/htc.py``).

The offline 2D model whose masks FSF's camera branch reads: ResNeXt-101
64×4d with DCN at c3–c5, FPN (P2–P6), RPN (per-level top-k, decode, greedy
NMS within each level, top ``num_proposals``), three cascade bbox stages on
RoI features plus the fused semantic embedding (scores = mean of the three
stages' softmax), per-class NMS to ``max_dets`` detections, and three mask
heads with mask-info flow (logits averaged, then sigmoid; 28 × 28 per
detection, for its class). BN is frozen; there are no losses.

Tensors are NCHW inside (the input image, NHWC, gives every conv a
channels-last memory format); the public layouts are the JAX package's:
images ``[N, H, W, 3]`` RGB 0–255, ``Detections`` as there. Both NMS calls
of an image go through ``ops/nms.nms_keep`` (kernel K3 on the card): the
RPN's over its ≤ 5 · ``rpn_pre_nms`` proposals with one class, and the
detections' with one class per object class over the shared box IoU.
Every top-k is a stable descending sort: ``lax.top_k`` keeps the lower
index first among ties, and ties are certain (suppressed rows score −1).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dcn import deform_conv2d
from ..ops.geometry import axis_aligned_iou_2d
from ..ops import nms
from ..ops.roi_align import multilevel_roi_align, roi_align

# ImageNet / mmdet normalization (RGB)
IMG_MEAN = (123.675, 116.28, 103.53)
IMG_STD = (58.395, 57.12, 57.375)

NUIM_CLASSES = (
    "car", "truck", "trailer", "bus", "construction_vehicle", "bicycle",
    "motorcycle", "pedestrian", "traffic_cone", "barrier",
)

RPN_STRIDES = (4, 8, 16, 32, 64)
STAGE_STDS = ((0.1, 0.1, 0.2, 0.2), (0.05, 0.05, 0.1, 0.1), (0.033, 0.033, 0.067, 0.067))


class BN(nn.Module):
    """Frozen BatchNorm on stored statistics (ε 1e-5)."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        inv = torch.rsqrt(self.running_var + 1e-5) * self.weight
        return x * inv.view(1, -1, 1, 1) + (self.bias - self.running_mean * inv).view(1, -1, 1, 1)


class DeformConvBlock(nn.Module):
    """DCNv1 3 × 3 (no mask, one deformable group) with conv groups: the
    offset branch is a plain 3 × 3 conv to the 18 (dy, dx) channels."""

    def __init__(self, cin: int, features: int, stride: int = 1, groups: int = 1):
        super().__init__()
        self.stride, self.groups = stride, groups
        self.conv_offset = nn.Conv2d(cin, 18, 3, stride, 1)
        self.weight = nn.Parameter(torch.empty(features, cin // groups, 3, 3))

    def forward(self, x):
        return deform_conv2d(x, self.conv_offset(x), self.weight, None, self.stride, 1,
                             groups=self.groups)


class Bottleneck(nn.Module):
    """ResNeXt bottleneck, PyTorch style (the stride on the 3 × 3)."""

    def __init__(self, cin: int, mid: int, out: int, stride: int = 1, groups: int = 64,
                 dcn: bool = False, downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, mid, 1, bias=False)
        self.bn1 = BN(mid)
        self.conv2 = (DeformConvBlock(mid, mid, stride, groups) if dcn else
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
        idn = self.ds_bn(self.ds_conv(x)) if hasattr(self, "ds_conv") else x
        return F.relu(y + idn)


class ResNeXt(nn.Module):
    """ResNeXt-101 64 × 4d, DCN at stages 2–4 → [C2, C3, C4, C5]."""

    def __init__(self, depth_blocks: Sequence[int] = (3, 4, 23, 3), groups: int = 64,
                 base_width: int = 4, stage_with_dcn: Sequence[bool] = (False, True, True, True)):
        super().__init__()
        self.depth_blocks = tuple(depth_blocks)
        self.stem_conv = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.stem_bn = BN(64)
        cin, planes = 64, 64
        for si, nblocks in enumerate(self.depth_blocks):
            out_ch = planes * 4
            mid = int(planes * base_width / 64) * groups
            for bi in range(nblocks):
                self.add_module(f"layer{si + 1}_{bi}", Bottleneck(
                    cin, mid, out_ch, stride=2 if (bi == 0 and si > 0) else 1, groups=groups,
                    dcn=stage_with_dcn[si], downsample=bi == 0))
                cin = out_ch
            planes *= 2

    def forward(self, x) -> List[torch.Tensor]:
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        outs = []
        for si, nblocks in enumerate(self.depth_blocks):
            for bi in range(nblocks):
                x = getattr(self, f"layer{si + 1}_{bi}")(x)
            outs.append(x)
        return outs


class FPN(nn.Module):
    """mmdet FPN with five outputs: 1 × 1 laterals, top-down nearest × 2
    (cropped), 3 × 3 outputs, P6 = P5 at stride 2."""

    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256):
        super().__init__()
        for i, c in enumerate(in_channels):
            self.add_module(f"lateral{i}", nn.Conv2d(c, out_channels, 1))
            self.add_module(f"fpn{i}", nn.Conv2d(out_channels, out_channels, 3, 1, 1))

    def forward(self, inputs: List[torch.Tensor]) -> List[torch.Tensor]:
        lats = [getattr(self, f"lateral{i}")(c) for i, c in enumerate(inputs)]
        for i in range(len(lats) - 1, 0, -1):
            h, w = lats[i - 1].shape[2:]
            up = F.interpolate(lats[i], scale_factor=2.0, mode="nearest")
            lats[i - 1] = lats[i - 1] + up[:, :, :h, :w]
        outs = [getattr(self, f"fpn{i}")(lat) for i, lat in enumerate(lats)]
        outs.append(outs[-1][:, :, ::2, ::2])
        return outs


class RPNHead(nn.Module):
    def __init__(self, num_anchors: int = 3, channels: int = 256):
        super().__init__()
        self.rpn_conv = nn.Conv2d(channels, 256, 3, 1, 1)
        self.rpn_cls = nn.Conv2d(256, num_anchors, 1)
        self.rpn_reg = nn.Conv2d(256, num_anchors * 4, 1)

    def forward(self, feats: List[torch.Tensor]):
        cls_all, reg_all = [], []
        for f in feats:
            h = F.relu(self.rpn_conv(f))
            cls_all.append(self.rpn_cls(h))
            reg_all.append(self.rpn_reg(h))
        return cls_all, reg_all


class Shared2FCBBoxHead(nn.Module):
    def __init__(self, num_classes: int = 10, in_features: int = 256 * 7 * 7):
        super().__init__()
        self.fc1 = nn.Linear(in_features, 1024)
        self.fc2 = nn.Linear(1024, 1024)
        self.fc_cls = nn.Linear(1024, num_classes + 1)
        self.fc_reg = nn.Linear(1024, 4)  # class-agnostic

    def forward(self, roi_feats):  # [N, 7, 7, C]; flattened C, H, W as mmdet's
        x = roi_feats.permute(0, 3, 1, 2).reshape(roi_feats.shape[0], -1)
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))
        return self.fc_cls(x), self.fc_reg(x)


class HTCMaskHead(nn.Module):
    """Four 3 × 3 convs, a 2 × 2 stride-2 transposed conv, 1 × 1 logits;
    with ``with_conv_res`` the previous stage's features join through a
    1 × 1 conv (mask-info flow)."""

    def __init__(self, num_classes: int = 10, with_conv_res: bool = True):
        super().__init__()
        if with_conv_res:
            self.conv_res = nn.Conv2d(256, 256, 1)
        for i in range(4):
            self.add_module(f"conv{i}", nn.Conv2d(256, 256, 3, 1, 1))
        self.upsample = nn.ConvTranspose2d(256, 256, 2, 2)
        self.conv_logits = nn.Conv2d(256, num_classes, 1)

    def forward(self, x, res_feat: Optional[torch.Tensor] = None):
        if res_feat is not None:
            x = x + F.relu(self.conv_res(res_feat))
        for i in range(4):
            x = F.relu(getattr(self, f"conv{i}")(x))
        feat = x
        x = F.relu(self.upsample(x))
        return self.conv_logits(x), feat


class FusedSemanticHead(nn.Module):
    """Stride-8 fused semantic branch: every level resized to P3 (bilinear,
    antialiased when shrinking, as ``jax.image.resize``), 1 × 1 laterals
    summed, four 3 × 3 convs → (logits, the 256-channel embedding the RoI
    heads read)."""

    def __init__(self, num_ins: int = 5, fusion_level: int = 1, num_classes: int = 32):
        super().__init__()
        self.num_ins, self.fusion_level = num_ins, fusion_level
        for i in range(num_ins):
            self.add_module(f"lateral{i}", nn.Conv2d(256, 256, 1))
        for i in range(4):
            self.add_module(f"conv{i}", nn.Conv2d(256, 256, 3, 1, 1))
        self.conv_logits = nn.Conv2d(256, num_classes, 1)
        self.conv_embedding = nn.Conv2d(256, 256, 1)

    def forward(self, feats: List[torch.Tensor]):
        fl = self.fusion_level
        base = getattr(self, f"lateral{fl}")(feats[fl])
        hb, wb = base.shape[2:]
        for i, f in enumerate(feats[: self.num_ins]):
            if i == fl:
                continue
            f = F.interpolate(f, size=(hb, wb), mode="bilinear", align_corners=False,
                              antialias=True)
            base = base + getattr(self, f"lateral{i}")(f)
        x = base
        for i in range(4):
            x = F.relu(getattr(self, f"conv{i}")(x))
        return self.conv_logits(x), self.conv_embedding(x)


# ---------------------------------------------------------------- box code

def base_anchors(stride: int, scale: float = 8.0, ratios=(0.5, 1.0, 2.0)) -> torch.Tensor:
    """mmdet ``AnchorGenerator`` base anchors (center offset 0) → [A, 4]."""
    out = []
    for r in ratios:
        w = stride * scale / (r ** 0.5)
        h = stride * scale * (r ** 0.5)
        out.append([-w / 2, -h / 2, w / 2, h / 2])
    return torch.tensor(out, dtype=torch.float32)


def level_anchors(stride: int, h: int, w: int, device=None) -> torch.Tensor:
    """Every anchor of one level, (row, column, anchor) order → [H·W·A, 4].
    The base anchors are added as Python scalars: a host-to-device copy of
    them would wait for the stream."""
    base = base_anchors(stride).tolist()
    ys = torch.arange(h, dtype=torch.float32, device=device) * stride
    xs = torch.arange(w, dtype=torch.float32, device=device) * stride
    cy, cx = torch.meshgrid(ys, xs, indexing="ij")
    shift = (cx.reshape(-1), cy.reshape(-1), cx.reshape(-1), cy.reshape(-1))
    return torch.stack([torch.stack([shift[j] + a[j] for j in range(4)], -1) for a in base],
                       1).reshape(-1, 4)


# |log(16 / 1000)| in f32, the decode's bound on |dw| and |dh|
_MAX_RATIO = float(torch.log(torch.tensor(16.0 / 1000.0, dtype=torch.float32)).abs())


def delta_decode(rois: torch.Tensor, deltas: torch.Tensor, stds: Tuple[float, ...],
                 img_hw: Tuple[int, int]) -> torch.Tensor:
    """mmdet ``DeltaXYWHBBoxCoder.decode`` (means 0, |dw|, |dh| at most
    |log(16 / 1000)|), clipped to the (padded) image."""
    sx, sy, sw, sh = stds
    w = rois[:, 2] - rois[:, 0]
    h = rois[:, 3] - rois[:, 1]
    cx = rois[:, 0] + w * 0.5
    cy = rois[:, 1] + h * 0.5
    dw = (deltas[:, 2] * sw).clamp(-_MAX_RATIO, _MAX_RATIO)
    dh = (deltas[:, 3] * sh).clamp(-_MAX_RATIO, _MAX_RATIO)
    ncx = cx + deltas[:, 0] * sx * w
    ncy = cy + deltas[:, 1] * sy * h
    nw = w * torch.exp(dw)
    nh = h * torch.exp(dh)
    hh, ww = img_hw
    return torch.stack([(ncx - nw / 2).clamp(0.0, ww - 1.0), (ncy - nh / 2).clamp(0.0, hh - 1.0),
                        (ncx + nw / 2).clamp(0.0, ww - 1.0), (ncy + nh / 2).clamp(0.0, hh - 1.0)],
                       -1)


def stable_topk(x: torch.Tensor, k: int):
    """``lax.top_k`` of a 1-D tensor: the k largest, the lower index first
    among ties → (values, indices)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


class Detections(NamedTuple):
    boxes: torch.Tensor    # [D, 4] xyxy image px
    scores: torch.Tensor   # [D]
    labels: torch.Tensor   # [D] i32 (nuImages class ids)
    masks: torch.Tensor    # [D, 28, 28] probabilities within the box
    valid: torch.Tensor    # [D] bool


class HTC(nn.Module):
    """The HTC inference graph for an image batch ``[N, H, W, 3]`` (RGB
    0–255, H and W multiples of 32) → one ``Detections`` per image. Static
    capacities: ``num_proposals`` RPN outputs and ``max_dets`` detections
    per image."""

    def __init__(self, num_classes: int = 10, num_proposals: int = 1000, rpn_pre_nms: int = 1000,
                 max_dets: int = 100, depth_blocks: Tuple[int, ...] = (3, 4, 23, 3),
                 stage_stds: Tuple = STAGE_STDS):
        super().__init__()
        self.num_classes, self.num_proposals = num_classes, num_proposals
        self.rpn_pre_nms, self.max_dets, self.stage_stds = rpn_pre_nms, max_dets, stage_stds
        self.backbone = ResNeXt(depth_blocks=depth_blocks)
        self.neck = FPN()
        self.rpn_head = RPNHead()
        for i in range(3):
            self.add_module(f"bbox_head{i}", Shared2FCBBoxHead(num_classes))
            self.add_module(f"mask_head{i}", HTCMaskHead(num_classes, with_conv_res=i > 0))
        self.semantic_head = FusedSemanticHead()
        self.register_buffer("img_mean", torch.tensor(IMG_MEAN), persistent=False)
        self.register_buffer("img_std", torch.tensor(IMG_STD), persistent=False)

    def bbox_head(self, i: int) -> Shared2FCBBoxHead:
        return getattr(self, f"bbox_head{i}")

    def mask_head(self, i: int) -> HTCMaskHead:
        return getattr(self, f"mask_head{i}")

    def normalize(self, images: torch.Tensor) -> torch.Tensor:
        """[N, H, W, 3] RGB 0–255 → normalized [N, 3, H, W] (channels last)."""
        return ((images.float() - self.img_mean) / self.img_std).permute(0, 3, 1, 2)

    def _proposals(self, cls_lvls, reg_lvls, anchors, img_hw):
        """RPN proposals of one image from its [A, H, W] / [4A, H, W] level
        outputs and each level's anchors → (boxes [P, 4], valid [P])."""
        boxes_all, scores_all, lvl_all = [], [], []
        for li, (cls, reg, anc) in enumerate(zip(cls_lvls, reg_lvls, anchors)):
            scores = torch.sigmoid(cls.permute(1, 2, 0).reshape(-1))
            deltas = reg.permute(1, 2, 0).reshape(-1, 4)
            k = min(self.rpn_pre_nms, scores.shape[0])
            top, idx = stable_topk(scores, k)
            boxes_all.append(delta_decode(anc[idx], deltas[idx], (1.0, 1.0, 1.0, 1.0), img_hw))
            scores_all.append(top)
            lvl_all.append(torch.full((k,), li, dtype=torch.float32, device=cls.device))
        boxes = torch.cat(boxes_all)
        scores = torch.cat(scores_all)
        lvls = torch.cat(lvl_all)
        # suppression only within a level: each level in a coordinate range of its own
        off = boxes + lvls[:, None] * float(max(img_hw) + 2)
        iou = axis_aligned_iou_2d(off, off)
        keep = nms.nms_mask_from_iou(iou, scores, torch.ones_like(scores, dtype=torch.bool), 0.7)
        top, idx = stable_topk(torch.where(keep, scores, torch.full_like(scores, -1.0)),
                               self.num_proposals)
        return boxes[idx], top > 0.0

    def roi_feats(self, pyramid, sem_feat, rois, valid, out_size: int):
        """FPN RoIAlign (P2–P5) plus the semantic embedding's, at ``out_size``;
        ``pyramid`` and ``sem_feat`` are one image's [H, W, C] maps."""
        rf = multilevel_roi_align(pyramid[:4], RPN_STRIDES[:4], rois, valid, out_size)
        sf = roi_align(sem_feat, rois, valid, 14, 1.0 / 8.0)
        if out_size != 14:
            f = 14 // out_size
            sf = sf.reshape(sf.shape[0], out_size, f, out_size, f, -1).mean((2, 4))
        return rf + sf

    def _multiclass_nms(self, rois, scores, valid, score_thr: float = 0.001,
                        iou_thr: float = 0.5) -> Detections:
        """Per-class greedy NMS (one K3 launch for every class over the
        shared box IoU), then the top ``max_dets`` of every class's kept
        scores (−1 elsewhere) in class-major order."""
        p = rois.shape[0]
        iou = axis_aligned_iou_2d(rois, rois)
        sc = scores[:, : self.num_classes].T.contiguous()           # [C, P]
        order, v = nms.class_orders(sc, valid[None] & (sc > score_thr))
        keep_sorted = nms.nms_keep(iou.contiguous(), order, v.contiguous(), iou_thr)
        keeps = torch.zeros_like(keep_sorted).scatter_(1, order.long(), keep_sorted)
        flat = torch.where(keeps, sc, torch.full_like(sc, -1.0)).reshape(-1)
        top, idx = stable_topk(flat, self.max_dets)
        return Detections(boxes=rois[idx % p], scores=top,
                          labels=torch.div(idx, p, rounding_mode="floor").to(torch.int32),
                          masks=rois.new_zeros(self.max_dets, 28, 28), valid=top > 0.0)

    def mask_logits(self, mfeats):
        """The three mask heads with info flow on [D, 14, 14, C] RoI
        features → each head's logits [D, C, 28, 28]."""
        x = mfeats.permute(0, 3, 1, 2)
        last, logits = None, []
        for si in range(3):
            lg, last = self.mask_head(si)(x, last)
            logits.append(lg)
        return logits

    def image_features(self, images):
        """(C2–C5, P2–P6, RPN class and box outputs per level, semantic
        logits and embedding), all NCHW."""
        cs = self.backbone(self.normalize(images))
        pyramid = self.neck(cs)
        cls_lvls, reg_lvls = self.rpn_head(pyramid)
        sem_logits, sem_embed = self.semantic_head(pyramid)
        return cs, pyramid, cls_lvls, reg_lvls, sem_logits, sem_embed

    def forward(self, images: torch.Tensor) -> List[Detections]:
        """images [N, H, W, 3] uint8 / float RGB → per-image ``Detections``."""
        n, ih, iw = images.shape[:3]
        _, pyramid, cls_lvls, reg_lvls, _, sem_embed = self.image_features(images)
        anchors = [level_anchors(s, *c.shape[2:], device=c.device)
                   for s, c in zip(RPN_STRIDES, cls_lvls)]
        out = []
        for b in range(n):
            pyr_b = [p[b].permute(1, 2, 0) for p in pyramid]
            sem_b = sem_embed[b].permute(1, 2, 0)
            rois, rvalid = self._proposals([c[b] for c in cls_lvls], [r[b] for r in reg_lvls],
                                           anchors, (ih, iw))
            ms_scores = []
            for si in range(3):
                cls, reg = self.bbox_head(si)(self.roi_feats(pyr_b, sem_b, rois, rvalid, 7))
                ms_scores.append(torch.softmax(cls, -1))
                rois = delta_decode(rois, reg, self.stage_stds[si], (ih, iw))
            scores = (ms_scores[0] + ms_scores[1] + ms_scores[2]) / 3.0
            dets = self._multiclass_nms(rois, scores, rvalid)
            lg = self.mask_logits(self.roi_feats(pyr_b, sem_b, dets.boxes, dets.valid, 14))
            probs = torch.sigmoid((lg[0] + lg[1] + lg[2]) / 3.0)        # [D, C, 28, 28]
            masks = probs[torch.arange(probs.shape[0], device=probs.device), dets.labels.long()]
            out.append(dets._replace(masks=masks))
        return out
