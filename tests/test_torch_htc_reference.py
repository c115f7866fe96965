"""The port's HTC against the benchmark's plain reference on the CPU
(``benchmark/reference/``: DCN by its definition, mmcv's RoIAlign, greedy
NMS on the host, Pillow's resample in NumPy), on one seeded ``state_dict``
at the tiny shape of ``chip_smoke.py``'s HTC checks: one bottleneck a
stage, 16 proposals, 4 detections, two cameras at 96 × 160, every DCN
offset branch non-zero. No JAX. Tolerances (f32 on both sides, sums in
another order): the ops 1e-5 of the output's magnitude; the forward's
labels, validity and order exact, boxes within 1e-4 of the image size,
scores and mask probabilities within 1e-4 (an f32 chain of ~20 layers);
the mask tool's host work bitwise on the same detections."""
import math

import numpy as np
import pytest
import torch

from benchmark.reference import masks as ref_masks
from benchmark.reference.models import htc as ref_htc
from benchmark.reference.ops import dcn as ref_dcn, roi_align as ref_roi
from fullysparsefusion_tpu_torch import generate_masks as gm
from fullysparsefusion_tpu_torch.models.htc import DeformConvBlock
from fullysparsefusion_tpu_torch.ops import dcn, roi_align
from fullysparsefusion_tpu_torch.weights import build_htc
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)

TINY = dict(depth_blocks=(1, 1, 1, 1), num_proposals=16, rpn_pre_nms=16, max_dets=4)
HW = (96, 160)
OP_TOL = 1e-5
FORWARD_TOL = 1e-4


def tiny_htc(seed: int = 0):
    """The port's tiny HTC from ``build_htc(seed)`` with every DCN offset
    branch drawn N(0, 1.5² / fan_in), and the reference's HTC with its
    ``state_dict`` loaded strictly."""
    model = build_htc(seed=seed, device="cpu", **TINY)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, DeformConvBlock):
                w = m.conv_offset.weight
                w.normal_(0.0, 1.5 / math.sqrt(w[0].numel()), generator=gen)
    ref = ref_htc.HTC(**TINY)
    ref.load_state_dict(model.state_dict(), strict=True)
    return model, ref.eval()


def tiny_images(seed: int = 5) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (2, *HW, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def models():
    return tiny_htc()


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def test_deform_conv_matches_the_definition():
    """Grouped DCN at strides 1 and 2, offsets of a few pixels that reach
    past the map's edges."""
    gen = torch.Generator().manual_seed(0)
    for n, cin, h, w, cout, groups, stride in ((2, 16, 11, 13, 16, 4, 1), (1, 32, 12, 9, 32, 8, 2)):
        x = torch.randn(n, cin, h, w, generator=gen)
        weight = torch.randn(cout, cin // groups, 3, 3, generator=gen)
        ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
        off = torch.randn(n, 18, ho, wo, generator=gen) * 2.0
        got = dcn.deform_conv2d(x, off, weight, None, stride, 1, groups=groups)
        want = ref_dcn.deform_conv2d(x, off, weight, stride, 1, groups)
        assert _rel(got, want) < OP_TOL


def test_multilevel_roi_align_matches_mmcv():
    """P2–P5 of a 64 × 96 image, RoIs of every level (some on the border
    and in the padding), invalid rows zero; and the semantic map's pooling."""
    gen = torch.Generator().manual_seed(1)
    feats = [torch.randn(64 // s, 96 // s, 8, generator=gen) for s in (4, 8, 16, 32)]
    xy = torch.rand(40, 2, generator=gen) * torch.tensor([90.0, 60.0])
    size = torch.rand(40, 2, generator=gen) ** 2 * 400 + 1
    rois = torch.cat([xy, (xy + size).minimum(torch.tensor([95.0, 63.0]))], 1)
    rois[0] = torch.tensor([0.0, 0.0, 95.0, 63.0])
    valid = torch.rand(40, generator=gen) > 0.2
    for out_size in (7, 14):
        got = roi_align.multilevel_roi_align(feats, (4, 8, 16, 32), rois, valid, out_size)
        want = ref_roi.multilevel_roi_align(feats, (4, 8, 16, 32), rois, valid, out_size)
        assert _rel(got, want) < OP_TOL
        assert not got[~valid].any()
    got = roi_align.roi_align(feats[1], rois, valid, 14, 1.0 / 8.0)
    want = ref_roi.roi_align(feats[1], rois, valid, 14, 1.0 / 8.0)
    assert _rel(got, want) < OP_TOL


def test_forward_matches_the_reference(models):
    model, ref = models
    images = torch.from_numpy(gm.pad_images(tiny_images()))
    with torch.inference_mode():
        got, want = model(images), ref(images)
    for g, w in zip(got, want):
        assert torch.equal(g.valid, w.valid) and torch.equal(g.labels, w.labels)
        assert g.valid.any()
        v = w.valid
        assert float((g.boxes[v] - w.boxes[v]).abs().max()) < FORWARD_TOL * max(HW)
        assert float((g.scores[v] - w.scores[v]).abs().max()) < FORWARD_TOL
        assert float((g.masks[v] - w.masks[v]).abs().max()) < FORWARD_TOL


def test_sample_masks_planes_and_anno_are_the_reference_tools(models):
    """``sample_masks`` at the tool's paste and paint, bitwise the
    reference's paste and paint of the same detections (kept from the
    forward by a hook), at ``score_thr`` 0 so that every detection is
    pasted."""
    model = models[0]
    kept = []
    handle = model.register_forward_hook(lambda m, a, out: kept.append(out))
    try:
        planes, anno = gm.sample_masks(model, tiny_images(), score_thr=0.0, num_classes=10)
    finally:
        handle.remove()
    host = [{k: getattr(d, k).numpy() for k in d._fields} for d in kept[0]]
    pasted = ref_masks.paste(host, HW, 0.0)
    want_planes, want_anno = ref_masks.paint(pasted, 2, 10, HW, 250)
    assert len(pasted) == 8 and planes.any()
    np.testing.assert_array_equal(planes, want_planes)
    np.testing.assert_array_equal(anno, want_anno)


def test_run_htc_is_f32_inside_and_leaves_the_flags_as_found(models):
    model = models[0]
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    seen = []
    handle = model.register_forward_pre_hook(
        lambda m, a: seen.append((cudnn.allow_tf32, matmul.allow_tf32)))
    saved = cudnn.allow_tf32, matmul.allow_tf32, cudnn.enabled, cudnn.benchmark, \
        cudnn.deterministic
    try:
        for flags in ((True, True), (True, False), (False, True)):
            cudnn.allow_tf32, matmul.allow_tf32 = flags
            others = cudnn.enabled, cudnn.benchmark, cudnn.deterministic
            gm.run_htc(model, tiny_images()[:1])
            assert (cudnn.allow_tf32, matmul.allow_tf32) == flags
            assert (cudnn.enabled, cudnn.benchmark, cudnn.deterministic) == others
        assert seen == [(False, False)] * 3
    finally:
        handle.remove()
        (cudnn.allow_tf32, matmul.allow_tf32, cudnn.enabled, cudnn.benchmark,
         cudnn.deterministic) = saved
