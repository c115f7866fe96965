#!/usr/bin/env python3
"""Where one request's time goes in the PyTorch port, on one NVIDIA GPU.

    python3 tools/profile_torch_request.py [--requests 3] \
        [--model fsf|av2|fsd|two_stage|htc|nusc_entry]

Builds the kernels and the full-width FSF of ``chip_smoke.py`` (``--model
av2``: its FSF at AV2's shape on the AV2 scene and seven cameras; ``--model
fsd``: its six-task single-stage FSD; ``--model two_stage``: its two-stage
FSD) with random weights (seed 0) on its bench-scale scene (seed 0); or
(``--model htc``) its default HTC (random weights from seed 0, DCN offsets
non-zero) on one sample's six 900 x 1,600 cameras (seed 0), with the paste
and paint on the host; or (``--model nusc_entry``) the full-width FSF served
from a nuScenes info tree on disk (``chip_smoke.nusc_entry_tree``: the bench
scene of seed 0 as a key frame, 9 sweeps and 900 x 1,600 mask PNGs), as
``cli.test`` serves a sample; warms up, then:

1. spans, averaged over ``--requests`` requests. FSF (``fsf``, ``av2``,
   ``nusc_entry``): the program's own spans (``utils.profiling.span``:
   ``seg_core`` with ``vfe`` and ``sparse_unet``, ``seg_head``,
   ``camera_queries``, ``lidar_queries`` with ``foreground`` and within it
   ``clustering``, ``fusion``, ``refine`` with ``roi_points``, ``decode``),
   read from ``utils.profiling.tracing``: their CUDA events' ms and, as
   ``host_self_ms``, the host's time in each less its child spans'. AV2
   prints an ``input`` line first with the host conversion and copy of the
   request's inputs, which the spans leave out; nusc_entry adds the host's
   ``read`` (the reader: ``.bin`` files, sweep chain, transforms),
   ``collate``, ``masks`` (PNG decode and pack) and ``input`` (conversion
   and copy to the card), during which the card idles. The others: CUDA
   events around every top-level submodule and around the functions the
   forward calls outside them (FSD: foreground extraction, ``get_bboxes``,
   and per task its decode + NMS and, inside it, the rotated IoU matrix;
   two-stage: the first stage's parts, the RCNN's RoI pooling, SIR and
   MLPs, ``get_bboxes`` and its IoU matrix; HTC: the backbone and each of
   its stages C2-C5, FPN, the RPN head, the proposals (their NMS nested),
   the semantic head, each cascade stage's RoI features and bbox head, the
   class NMS, the mask RoI features and mask heads, the box IoU matrices,
   and on the host the paste and the paint). Spans are stream time between
   the two events, idle gaps included; nested spans are listed with their
   parent.
2. kernels: ``torch.profiler`` over one request; device time by kernel name
   (top 15) and the device's busy share (the sum of kernel times over the
   request's stream time).
3. k1_plan (not for HTC, which runs no sparse conv): the per-rulebook glue of the gather-conv kernel
   (``plan_rulebook``): its calls per request, and the device launches and
   stream time of each call, from ``torch.profiler`` around the call alone.

Prints one JSON object per line; exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from collections import defaultdict

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class Spans:
    """Stream time of named spans, from CUDA events recorded at their ends;
    a name that recurs adds up."""

    def __init__(self):
        self.open = {}
        self.done = []
        self.ms = defaultdict(float)

    def start(self, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.open[name] = ev

    def stop(self, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.done.append((name, self.open.pop(name), ev))

    def collect(self):
        torch.cuda.synchronize()
        for name, a, b in self.done:
            self.ms[name] += a.elapsed_time(b)
        self.done = []


class ProgramSpans:
    """The program's own spans over the requests that :meth:`traced` wraps:
    device ms (CUDA events) and the host's self ms per span name; a name
    that recurs adds up."""

    def __init__(self):
        self.tracers = []
        self.ms = defaultdict(float)
        self.host_self_ms = defaultdict(float)

    def traced(self, request):
        from fullysparsefusion_tpu_torch.utils import profiling

        def run():
            with profiling.tracing() as tr:
                out = request()
            self.tracers.append(tr)
            return out

        return run

    def collect(self):
        for tr in self.tracers:
            for name, s in tr.summary().items():
                self.ms[name] += sum(s["device_ms"])
                self.host_self_ms[name] += sum(s["self_ms"])
        self.tracers = []


def hook_module(mod, name, spans):
    mod.register_forward_pre_hook(lambda *_: spans.start(name))
    mod.register_forward_hook(lambda *_: spans.stop(name))


def wrap(owner, attr, name, spans):
    fn = getattr(owner, attr)

    def timed(*a, **k):
        spans.start(name)
        out = fn(*a, **k)
        spans.stop(name)
        return out

    setattr(owner, attr, timed)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--model", choices=("fsf", "av2", "fsd", "two_stage", "htc", "nusc_entry"),
                    default="fsf")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_request: no CUDA device", file=sys.stderr)
        return 1
    from fullysparsefusion_tpu_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.build_all()
    if args.model == "fsd":
        request, spans = fsd_request_spans()
    elif args.model == "two_stage":
        request, spans = two_stage_request_spans()
    elif args.model == "htc":
        request, spans = htc_request_spans()
    elif args.model == "nusc_entry":
        request, spans = nusc_entry_request_spans()
    else:
        request, spans = fsf_request_spans(av2=args.model == "av2")
    total = 0.0
    for _ in range(args.requests):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        request()
        end.record()
        spans.collect()
        total += start.elapsed_time(end)
    n = args.requests
    line = {"phase": "spans", "model": args.model, "requests": n,
            "request_ms": round(total / n, 3),
            "ms": {k: round(v / n, 3) for k, v in sorted(spans.ms.items(), key=lambda kv: -kv[1])}}
    if isinstance(spans, ProgramSpans):
        line["host_self_ms"] = {k: round(v / n, 3) for k, v in spans.host_self_ms.items()}
    print(json.dumps(line), flush=True)

    from torch.profiler import ProfilerActivity, profile

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        request()
        end.record()
        torch.cuda.synchronize()
    spans.collect()
    wall_ms = start.elapsed_time(end)
    by_kernel = defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        # the program's spans appear on the device's timeline too; they are no kernels
        if ev.device_type == torch.autograd.DeviceType.CUDA and not ev.is_user_annotation:
            by_kernel[ev.name][0] += ev.time_range.elapsed_us() / 1e3
            by_kernel[ev.name][1] += 1
    busy = sum(v[0] for v in by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:15]
    print(json.dumps({"phase": "kernels", "model": args.model, "request_ms": round(wall_ms, 3),
                      "device_busy_ms": round(busy, 3),
                      "device_busy_share": round(busy / wall_ms, 4) if wall_ms else None,
                      "kernel_launches": sum(v[1] for v in by_kernel.values()),
                      "top": [{"name": k[:90], "ms": round(v[0], 3), "calls": v[1]}
                              for k, v in top]}), flush=True)
    if args.model != "htc":
        print(json.dumps(plan_glue(request)), flush=True)
    return 0


def warm(request):
    for _ in range(2):
        request()
    torch.cuda.synchronize()


def fsd_request_spans():
    """The six-task FSD's request and its spans: the segmentor's parts, the
    LiDAR branch's, and the decode per task with its IoU matrix."""
    import chip_smoke
    from fullysparsefusion_tpu_torch.models import heads
    from fullysparsefusion_tpu_torch.ops import nms
    from fullysparsefusion_tpu_torch.weights import build_fsd

    cfg = chip_smoke.fsd_config()
    model = build_fsd(cfg, seed=0, device="cuda")
    pb, _ = chip_smoke.fsd_scene(0, cfg)

    def request():
        with torch.inference_mode():
            return model.get_bboxes(model(pb, 1), 1)

    warm(request)
    spans = Spans()
    seg, branch = model.segmentor, model.query_branch
    hook_module(seg.SegmentorCore_0, "segmentor.core", spans)
    for sub in ("DynamicScatterVFE_0", "SparseUNet_0"):
        hook_module(getattr(seg.SegmentorCore_0, sub), f"segmentor.core.{sub}", spans)
    hook_module(seg.VoteSegHead_0, "segmentor.head", spans)
    hook_module(branch, "query_branch", spans)
    for sub in ("backbone", "bbox_head"):
        hook_module(getattr(branch, sub), f"query_branch.{sub}", spans)
    wrap(branch, "extract_foreground", "query_branch.extract_foreground", spans)
    wrap(model, "get_bboxes", "get_bboxes", spans)
    wrap(model, "forward", "forward", spans)
    tasks = len(cfg.task_tuple())
    for owner, attr, name in ((heads, "cluster_head_get_bboxes", "get_bboxes.task"),
                              (nms, "boxes_iou_bev", "get_bboxes.iou_task")):
        fn, calls = getattr(owner, attr), [0]

        def per_task(*a, _fn=fn, _calls=calls, _name=name, **k):
            label = f"{_name}{_calls[0] % tasks}"
            _calls[0] += 1
            spans.start(label)
            out = _fn(*a, **k)
            spans.stop(label)
            return out

        setattr(owner, attr, per_task)
    return request, spans


def two_stage_request_spans():
    """The two-stage FSD's request and its spans: the first stage's
    segmentor and LiDAR branch, the RCNN's pooling, SIR and MLPs, and the
    decode with its IoU matrix."""
    import chip_smoke
    from fullysparsefusion_tpu_torch.models import rcnn
    from fullysparsefusion_tpu_torch.ops import nms
    from fullysparsefusion_tpu_torch.weights import build_two_stage_fsd

    model = build_two_stage_fsd(chip_smoke.two_stage_config(), seed=0, device="cuda")
    pb, _ = chip_smoke.fsd_scene(0, model.cfg)

    def request():
        with torch.inference_mode():
            return model.get_bboxes(model(pb, 1), 1)

    warm(request)
    spans = Spans()
    rpn, head = model.rpn, model.roi_head
    hook_module(rpn.segmentor, "rpn.segmentor", spans)
    hook_module(rpn.segmentor.SegmentorCore_0.SparseUNet_0, "rpn.segmentor.SparseUNet_0", spans)
    hook_module(rpn.query_branch, "rpn.query_branch", spans)
    wrap(rpn.query_branch, "extract_foreground", "rpn.query_branch.extract_foreground", spans)
    hook_module(head, "roi_head", spans)
    for sub in ("FullySparseBboxHead_0", "MLP_0", "MLP_1"):
        hook_module(getattr(head, sub), f"roi_head.{sub}", spans)
    wrap(rcnn, "extract_roi_points", "roi_head.extract_roi_points", spans)
    wrap(nms, "boxes_iou_bev", "get_bboxes.iou", spans)
    wrap(model, "get_bboxes", "get_bboxes", spans)
    wrap(model, "forward", "forward", spans)
    return request, spans


def counted_wrap(owner, attr, names, spans):
    """Like :func:`wrap`, the i-th call of a cycle of ``len(names)`` calls
    named ``names[i]``."""
    fn, calls = getattr(owner, attr), [0]

    def timed(*a, **k):
        name = names[calls[0] % len(names)]
        calls[0] += 1
        spans.start(name)
        out = fn(*a, **k)
        spans.stop(name)
        return out

    setattr(owner, attr, timed)


def htc_request_spans():
    """HTC's request (one sample's six cameras through the model, then the
    paste and the paint on the host) and its spans. cuDNN deterministic, as
    in ``chip_smoke.py``."""
    import chip_smoke
    from fullysparsefusion_tpu_torch import generate_masks as gm
    from fullysparsefusion_tpu_torch.models import htc
    from fullysparsefusion_tpu_torch.ops import nms

    torch.backends.cudnn.deterministic = True
    model = chip_smoke.htc_model(0).cuda()
    images = chip_smoke.htc_images(0, chip_smoke.HTC_CAMS, chip_smoke.HTC_IMG_HW)
    x = torch.from_numpy(gm.pad_images(images)).cuda()

    def request():
        with torch.inference_mode():
            dets = model(x)
        pasted = gm.paste_detections(dets, chip_smoke.HTC_IMG_HW, chip_smoke.HTC_SCORE_THR)
        return gm.paint_sample(pasted, chip_smoke.HTC_CAMS, model.num_classes,
                               chip_smoke.HTC_IMG_HW)

    warm(request)
    spans = Spans()
    bb = model.backbone
    hook_module(bb, "backbone", spans)
    for si, nblocks in enumerate(bb.depth_blocks):
        name = f"backbone.c{si + 2}"
        getattr(bb, f"layer{si + 1}_0").register_forward_pre_hook(
            lambda *_, _n=name: spans.start(_n))
        getattr(bb, f"layer{si + 1}_{nblocks - 1}").register_forward_hook(
            lambda *_, _n=name: spans.stop(_n))
    for sub in ("neck", "rpn_head", "semantic_head"):
        hook_module(getattr(model, sub), sub, spans)
    for i in range(3):
        hook_module(model.bbox_head(i), f"cascade{i}.bbox_head", spans)
    wrap(model, "_proposals", "rpn.proposals", spans)
    wrap(nms, "nms_mask_from_iou", "rpn.proposals.nms", spans)
    counted_wrap(model, "roi_feats", [f"cascade{i}.roi_feats" for i in range(3)]
                 + ["mask.roi_feats"], spans)
    wrap(model, "_multiclass_nms", "class_nms", spans)
    wrap(model, "mask_logits", "mask.heads", spans)
    wrap(htc, "axis_aligned_iou_2d", "box_iou", spans)
    wrap(model, "forward", "forward", spans)
    wrap(gm, "paste_detections", "host.paste", spans)
    wrap(gm, "paint_sample", "host.paint", spans)
    return request, spans


def fsf_request_spans(av2: bool = False):
    """FSF's request and its spans (``av2``: at AV2's shape, on the AV2
    scene, with the inputs' conversion and copy as the span ``input``)."""
    import time

    import chip_smoke
    from fullysparsefusion_tpu_torch import synthetic as S
    from fullysparsefusion_tpu_torch.weights import build_fsf

    cfg = chip_smoke.av2_config() if av2 else chip_smoke.bench_config()
    model = build_fsf(cfg, seed=0, device="cuda")
    if av2:
        scene = chip_smoke.av2_scene(0, cfg)
        t0 = time.perf_counter()
        pb, cam = S.fsf_inputs(*scene, device="cuda")
        torch.cuda.synchronize()
        print(json.dumps({"phase": "input", "model": "av2",
                          "host_ms": round((time.perf_counter() - t0) * 1e3, 3)}), flush=True)
    else:
        pb, cam = chip_smoke.bench_request(0, cfg)

    def request():
        return model.get_bboxes(model(pb, cam, 1), 1)

    warm(request)
    spans = ProgramSpans()
    return spans.traced(request), spans


def nusc_entry_request_spans():
    """FSF served from a nuScenes info tree on disk, as ``cli.test`` serves
    a sample: the host's read, collate, masks and input, then FSF's spans."""
    import tempfile

    import chip_smoke
    from fullysparsefusion_tpu_torch.cli import common
    from fullysparsefusion_tpu_torch.data.nuscenes import NuScenesReader
    from fullysparsefusion_tpu_torch.data.pipelines import collate_scene
    from fullysparsefusion_tpu_torch.models.camera import CameraData
    from fullysparsefusion_tpu_torch.utils.profiling import span
    from fullysparsefusion_tpu_torch.weights import build_fsf

    cfg = common.model_config(chip_smoke.bench_config(), "fsf", common.READER_POINT_WIDTH)
    root = tempfile.TemporaryDirectory()
    tree = chip_smoke.nusc_entry_tree(root.name, cfg)
    tree["dir"] = root  # removed with the last reference to the request
    reader = NuScenesReader(tree["info"], root.name, cfg.fsd.class_names, training=False,
                            with_cbgs=False)
    model = build_fsf(cfg, seed=0, device="cuda")

    def request():
        with span("read"):
            s = reader.sample(0, augment=False)
        with span("collate"):
            batch = collate_scene([s], cfg.caps.points, cfg.caps.max_gt)
        with span("masks"):
            planes = common.load_masks([s], tree["masks"], cfg.num_classes, (900, 1600),
                                       chip_smoke.NUSC_ENTRY_SCALE)
        with span("input"):
            pb = common.point_batch(batch, "cuda")
            cam = CameraData.build(*planes, device="cuda")
        with torch.inference_mode():
            out = model.get_bboxes(model(pb, cam, 1), 1)
        return out

    warm(request)
    spans = ProgramSpans()
    return spans.traced(request), spans


def plan_glue(request):
    """Launches and time that K1's per-rulebook plans add to one request."""
    from torch.profiler import ProfilerActivity, profile

    from fullysparsefusion_tpu_torch.models import sparse_unet
    from fullysparsefusion_tpu_torch.ops import sparse_conv

    orig = sparse_conv.plan_rulebook
    calls = []

    def recorder(rows, n_src):
        calls.append((rows.clone(), n_src))
        return orig(rows, n_src)

    # plan_rulebook counts its calls on the module attribute of its name
    recorder.calls = 0
    sparse_conv.plan_rulebook = sparse_unet.plan_rulebook = recorder
    try:
        request()
    finally:
        sparse_conv.plan_rulebook = sparse_unet.plan_rulebook = orig
    per_call = []
    for rows, n_src in calls:
        orig(rows, n_src)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            start.record()
            orig(rows, n_src)
            end.record()
            torch.cuda.synchronize()
        launches = sum(1 for ev in prof.events()
                       if ev.device_type == torch.autograd.DeviceType.CUDA)
        per_call.append({"n_out": rows.shape[1], "launches": launches,
                         "ms": round(start.elapsed_time(end), 4)})
    return {"phase": "k1_plan", "calls": len(per_call),
            "launches": sum(c["launches"] for c in per_call),
            "ms": round(sum(c["ms"] for c in per_call), 4), "per_call": per_call}


if __name__ == "__main__":
    sys.exit(main())
