#!/usr/bin/env python3
"""Drive the PyTorch port (``fullysparsefusion_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, on a machine with a CUDA GPU

Phases, each of which ends the script with a non-zero exit on failure:

1. build the CUDA kernels from ``fullysparsefusion_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together); then ``fsf::segment_sum`` at
   Argoverse 2's shapes (``SEGMENT_PREVOX``: 131,072 rows, 67,000 invalid,
   into 98,304 segments at widths 4, 27, 81 and 128; ``SEGMENT_CLUSTERS``:
   24,576 rows into 1,024 skewed segments, past the capacity, at widths 1
   and 3, the latter a strided view), ids from ``unique_segments`` on the
   card: each call twice bitwise equal, bitwise the plain version on the
   CPU and the bare-id form, one launch and no host sync each, graph-timed
   beside its byte bound and ``index_put_(accumulate=True)`` (``library_ms``);
2. small-input reference: the tiny FSF config on the GPU (kernels) against
   the same model on the CPU (plain PyTorch versions), same weights and scene;
3. serve: full-width nuScenes FSF (random weights from seed 0) answers four
   requests, forward + ``get_bboxes`` on bench-scale synthetic scenes (seeds
   0, 1, 2, then 0 again, which must reproduce its detections bitwise); the
   kernels' launch counters are zeroed just before and read just after;
4. kernels: every kernel call of one request is captured and replayed
   against its plain version on the GPU (K1 within a stated tolerance, K2 and
   K3 bitwise), each kernel timed on the device by replaying a CUDA graph of
   its calls (the eager loop beside it as ``eager_ms``), the plain versions
   eagerly, and set beside the least time the card could take (``bound_ms``);
   K1 also runs adversarial rulebooks made on the card (an all-miss tile,
   every slot a miss, exactly one hit per row, ``n_out`` off the tile, Cin 16
   / Cout 48), K2 the problems of ``synthetic.ccl_problem_arrays`` (the
   reversed chain, one component of all N nodes, N = 1,000, 8,192 and
   12,000, coincident points, mixed batch ids, all invalid) and 50,000 nodes
   of ``synthetic.ccl_known_components`` against their known components,
   K3 N = 15,360 (a batch of 12 x 1,280 queries, past the scan's shared
   memory), each timed; the request's 16 ``fsf::segment_sum`` calls are
   replayed as in phase 1;
5. train: full-width FSF training at batch 1 on the seed-0 bench scene with
   its own GT, through ``parallel.train.train_step`` (AdamW, lr 1e-4 over
   100 steps, the segmentor core at 0.2): two warm-up steps, then five
   timed steps (forward + losses, backward, optimizer by CUDA events; peak
   memory; every loss; the kernels' launches per step), with the counters
   zeroed just before the five and read just after. The summed loss must be
   finite and fall, and every major submodule must get a gradient. One more
   step's backward calls of K1 (input gradients) and of ``dw_per_tap``
   (weight gradients) are captured and held to their plain versions on the
   card (its forward's 16 ``fsf::segment_sum`` calls replayed as in phase 1), each timed by CUDA-graph replay (``dw_per_tap``'s work list also
   held to its plain version, with each call's ``tile_fill`` and a
   ``torch.bmm`` yardstick, ``bmm_ms``), then ``dw_per_tap`` runs
   adversarial rulebooks (every hit in one row tile among them). Before all
   of it a tiny-config forward + backward runs on the GPU and on the CPU
   from the same weights: with eval-form BN the losses and the gradient tree
   must agree, with train-form BN the losses (``small_train_reference_check``
   says why).
6. ddp_world1: at full width, from the train phase's state, ``train_step``
   twice (whether the card's step reproduces) and ``sharded_train_step``
   under an NCCL group of world size 1 (``file://`` rendezvous), its losses
   held to ``train_step``'s; then timed sharded steps (the gradient
   all-reduce of the 303.8 MB of f32 gradients by CUDA events) with the
   kernels' launches counted (zeroed just before, read just after);
7. ddp_two_ranks: the tiny config on two processes on the one card, joined
   by gloo on CUDA tensors (NCCL takes one rank per card), against one
   process at batch 2 with doubled capacities, for eval-form BN, the
   segmentor-pretrain phase and train-form BN (what each holds:
   ``ddp_two_ranks``); both ranks' gradients and BN buffers bitwise equal,
   K1, K2 and ``dw_per_tap`` launched on each rank; then sharded eval
   (``get_bboxes`` on each rank's shard of six scenes, the records
   all-gathered) whose mAP must equal one process's;
8. train_to_map: the tiny config overfits one scene in 60 AdamW steps and
   its mAP through ``get_bboxes`` (K3) and ``evaluate_detections`` must
   rise past ``tests/test_train_to_map.py``'s thresholds;
9. fsd: the LiDAR-only single-stage FSD at full nuScenes width with the six
   class-group tasks (random weights from seed 0, the bench capacities and
   scenes): four requests (the repeat bitwise equal, K3 launched once per
   task), every K1, K2 and K3 call of one held to its plain version and
   timed (K3 per task); two warm-up and five timed train steps (AdamW, the
   segmentor core at 0.2; every loss finite, the segmentor's terms falling,
   every task head and the segmentor getting a gradient) with the backward
   kernels held to their plain versions; NCCL at world size 1 as in 6; and
   the tiny six-task FSD on two gloo ranks against one process (eval-form
   BN, every task's ``num_pos`` equal). At the start, beside the two small
   checks, the tiny six-task FSD with the IoU branch on runs forward,
   losses and decode on the GPU and on the CPU from the same weights.
10. two_stage: the two-stage FSD (``TwoStageFSD``: the one-task FSD's
   decoded boxes as RoIs, RCNN pooling + refinement, the RCNN decode) at
   full nuScenes width (random weights from seed 0, the bench capacities
   and scenes): four requests (the repeat bitwise equal, K2 and K3 once
   per request; RoIs, pooled pairs and ``dropped`` logged), every K1, K2
   and K3 call of one held to its plain version and timed; two warm-up and
   five timed train steps (every loss finite, the segmentor's terms
   falling, the first stage's head, the segmentor and the ``roi_head``
   getting a gradient) with the backward kernels held to their plain
   versions; NCCL at world size 1 bitwise equal to ``train_step``; the
   tiny two-stage FSD on two gloo ranks against one process (eval-form
   BN). At the start, the tiny two-stage FSD runs forward, losses and
   decode on the GPU and on the CPU from the same weights;
11. sst: the SST backbone at its defaults on the seed-0 bench scene's
   pillars, forward and backward timed, its windows and dropped tokens
   logged, the padding rows 0, the card's output against the CPU's.
12. htc: the HTC 2D instance-mask model at its defaults (ResNeXt-101 64x4d
   with DCN at c3-c5, random weights from seed 0, the DCN offset branches
   drawn non-zero), cuDNN deterministic: the default model on one 256 x
   448 camera against the CPU on every image-level and fixed-RoI tap; four
   requests (seeds 0, 1, 2, 0), each one nuScenes sample's six 900 x 1,600
   cameras through the forward (``gpu_ms``) and the host's paste and
   paint (``host_ms``), K3 launched twice per camera, the repeat's
   detections and mask planes bitwise equal; every K3 call of one request
   held to its plain version and timed per shape, and the mean DCN offset
   per stage. At the start, the tiny HTC's taps and detections on the GPU
   against the CPU.
13. av2: full-width FSF at Argoverse 2's shape (``av2_fsf_config``: 26
   classes in six groups, 7 ring cameras at 1,024 x 775, code size 8, 4-dim
   points, the 2,048 x 2,048 x 32 grid) at the JAX package's AV2 bench
   capacities, random weights from seed 0, on that bench's synthetic scene:
   the seed-0 scene's active voxels per UNet stage beside the caps; four
   requests (seeds 0, 1, 2, 0; the repeat bitwise equal; K1, K2 and K3
   launched in each; ``input_ms`` the host's conversion and copy of the
   points and the packed mask planes; ``FSF_SEGMENT_SUMS`` segment sums
   each); every K1, K2 and K3 call of one held to its plain version and
   graph-timed, none below its bound (K3 at C = 26), and every segment sum
   of one as in phase 1; two warm-up and three timed train steps on the
   seed-0 scene and its 48 GT boxes, the backward's K1 and ``dw_per_tap``
   calls held; then the
   normal entry point: the scene written as an AV2 info pickle and
   ``.bin``, read by ``data.av2.AV2Reader``, collated by
   ``data.pipelines.collate_scene``, served, turned into AV2 rows
   (``boxes_to_av2_rows``) and scored by ``eval.av2_detection.evaluate_av2``.
14. nusc_entry_point: full-width nuScenes FSF at the bench capacities
   (random weights from seed 0) from a dataset on disk: the bench scenes of
   seeds 0, 1, 2 written as an mmdet3d nuScenes info tree
   (``cli.make_fake_nuscenes.write_scene``: the key frame and 9 sweeps as
   ``.bin`` files in their sensor frames, six cameras at 900 x 1,600 in the
   ``cams`` dict, the mask PNGs), every PNG decoded by ``data/png.py`` and
   held bitwise to its painted plane, the GT database built by
   ``cli.create_gt_database``; ``cli.test.run --eval`` over the three
   samples (per sample the host's read, collate, mask and input ms,
   ``gpu_ms``, detections and launches; sample 0's masks, anno and camera
   matrices bitwise the bench scene's, its detections bitwise the model's
   called directly on the collated sample; the JSON and the metrics
   finite); ``--tta`` on sample 0 (the four-variant flip grid), the
   fusion's K3 call (C = 10 over the union) held bitwise to its plain
   version and timed beside its bound; ``cli.train.run`` (CBGS, GT paste)
   for 2 warm-up and 3 timed steps (host ms per step: read, paste,
   collate, masks, input; forward / backward / optimizer ms; peak MiB;
   launches), its checkpoint, ``--resume`` for one more step with the
   restored parameters and optimizer state held bitwise to the saved ones,
   and ``cli.test.run --checkpoint`` on sample 0 held bitwise to the
   trained model's own detections.
15. reference_interop: reference config files and mmdet3d-layout
   checkpoints. ``config_compat.load_fsf_config`` on the reconstructed
   nuScenes config file (``tests/torch_reference_configs``) held field by
   field to ``nusc_fsf_config()``; the seeded full-width FSF's
   reference-layout state dict (``train.torch_map.synthesize_state_dict``
   of ``weights.to_jax_variables``) written as an mmcv ``.pth``, converted
   by ``cli.convert_checkpoint`` against the config file (every tensor
   filled, none missing, unmapped or mismatched), loaded into a fresh FSF
   by ``load_jax_variables``: the bench requests of seeds 0, 1, 2 bitwise
   the seeded model's detections with the main path's K1 / K2 / K3
   launches per request, and ``--export`` gives the state dict back
   bitwise; one request under ``utils.profiling.device_trace``, whose
   trace must name K1's, K2's and K3's kernels and every serving span of
   the program, with the spans' ms;
   the FSD-pretrain warm start: a seeded full-width FSD's ``.pth``
   converted into FSF (the shared leaves bitwise the FSD's), then
   ``cli.train.run --config --init-from`` for 2 steps on the nuScenes tree
   (the loaded state bitwise the conversion's, finite losses, the nuScenes
   entry point's launches per step); the seeded full HTC's ``.pth``
   converted and built strictly: one six-camera 900 x 1,600 sample's masks
   and anno table bitwise the seeded model's, K3 launched twice a camera.
16. export: whole-model export through the kernels' ``torch.library`` ops
   (``cli/export_model.py``). Full-width FSF at ``bench_config()`` and FSD
   at its ``fsd`` (random weights from seed 0) each exported at batch 1 on
   the card (``torch.export``, non-strict, eval-form BN) and saved as a
   ``.pt2`` (MiB, export and save seconds, graph nodes and ``fsf::`` op
   calls); each served by ``cli/serve_exported.py`` in a fresh process
   that imports the op registration and no model module (load seconds,
   the first call's ms, then the bench requests of seeds 0, 1, 2): every
   output held to the eager model's at ``EXPORT_RTOL`` / ``EXPORT_ATOL``
   (bitwise reported), each request's ``gpu_ms`` beside the eager one's,
   the launches counted inside the ops equal to the eager forward's and the
   main path's K1 and K2 (no K3: decode is not exported) and to the
   kernels of a profiler trace of one call; then ``cli/export_model.py
   --config`` (the reconstructed nuScenes file) ``--check`` as a
   subprocess on the card.
17. offline_tools: the offline tools with the port's own codecs (the card's
   machine has no PIL, pandas or pyarrow). Every committed fixture JPEG
   (``tests/torch_offline_fixtures``) decoded by ``data/jpeg.decode_jpeg``
   and held bitwise to PIL's decode in the manifest, the progressive one
   refused; the six 900 x 1,600 camera JPEGs copied into the nuScenes entry
   tree and ``cli/generate_masks.py --backend htc`` run over its three
   samples at full HTC width (``build_htc`` defaults, seed 0, cuDNN
   deterministic) at the first score threshold that paints a plane (K3 12
   times a sample; per sample the decode, ``gpu_ms``, paste-and-paint and
   write ms), the written tree bitwise ``sample_masks`` of the same model on
   the decoded images; FSF served from that tree by ``cli/test.py
   --mask-dir`` (the entry point's launches a request); one AV2-shaped log
   written by ``data/feather.write_feather`` (three sweeps of ~127 k rows,
   the annotations, the poses), prepared by ``cli/prepare_av2.py`` (the
   ``.bin`` files bitwise, read ms per sweep) and read by ``AV2Reader``;
   the committed fixture feathers decoded against the manifest (ZSTD
   refused); the ``av2`` phase's detections through ``format_results`` and
   back through ``read_feather``. The log also carries a seven-camera ring
   rig (``cli/make_fake_av2.RingRig``: AV2's layout, 2,048 x 1,550 ring
   cameras, the front one portrait), an ego at 10 m/s turning at 0.3
   rad/s and images at 20 Hz off the sweeps.
18. av2_disk: FSF at AV2's full width served from that log on disk, with
   the ``av2`` phase's model: single-channel masks painted from each GT
   box's interior points by the rig's own geometry (camera pose in the
   city at the image's timestamp; ``cli/make_fake_av2.paint_masks``);
   ``cli/prepare_av2.py --fusion`` (96 of 96 GT boxes read back per frame,
   against the plain preparation's title-cased count; the nearest images);
   ``cli/test.py --model fsf --eval-protocol av2 --eval`` over the three
   frames (per request the host's read, mask and input ms, ``gpu_ms``,
   detections and launches), the feather read back equal to its rows,
   the metrics finite, one request again bitwise, every K1, K2 and K3 call
   of one request held to its plain version; of the in-box points the rig
   sees, the share whose lookup (``points_in_mask_compact``, read from the
   model's camera module) holds their own class must reach 0.95 and beat
   the uncompensated chain's; the points in three or more cameras'
   images are counted (the lookup keeps two).
19. multihost: the ``--multihost`` entry points over the nuScenes entry
   tree at the CLIs' own full-width config (``nusc_fsf_config``): ``python
   -m torch.distributed.run --standalone --nproc-per-node 1 -m
   fullysparsefusion_tpu_torch.cli.train --multihost`` for 3 steps (NCCL
   through ``env://``), its checkpoint's parameters and optimizer state and
   its log (rank 0's launches of every step in it, the same on every step,
   K1, K2 and ``dw_per_tap`` each launched) bitwise those of
   ``cli.train.run`` in this process; then ``tools/launch_test_torch.sh``
   (``cli/test.py --multihost --tmpdir``, one rank a card) serving that
   checkpoint with ``--eval``: one shard file, the merged JSON byte for
   byte, the metrics and the launches of rank 0's summary line (summed
   over the ranks; K1, K2 and K3 each launched) those of ``cli.test.run``
   in this process. Both exit codes are checked. The kernels line's
   ``multihost_*`` launches are the launched jobs' own.
20. descent: ``cli/train_descent.py`` at full width, 120 AdamW steps (lr
   1e-4 over 120 steps, no lr multipliers) of FSF at
   ``config.bench_fsf_config(1)`` cycling the JAX tool's pool of four
   bench-scale scenes (seeds 101, 118, 135, 152), the counters zeroed just
   before and read just after: every loss finite, the last below the
   first and the mean of the last 20 below the first 20's, every step after
   the third within 2 % of the third's peak allocated MiB, the launches 26
   / 1 / 0 / 13 / 16 (K1, K2, K3, ``dw_per_tap``, ``segment_sum``) on
   every step; the slowest step and optimizer phase reported; then one more
   step's backward K1 and ``dw_per_tap`` calls held to their plain versions
   and timed. The
   artifact goes to ``--descent-out`` (default: a temporary directory).

    python3 chip_smoke.py --descent-out docs/h100_fsf_training_descent.json

The last lines are a ``{"kernels": [...]}`` JSON object, the card's name and
power limit from ``nvidia-smi``, and ``{"ok": true, "device": {...}}``.
Without a CUDA device the script exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 outside
# the tensor cores, HBM3 bandwidth. Used only for the bound column.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

REQUEST_SEEDS = (0, 1, 2, 0)

# K1 tolerance: bf16 products are exact in f32, so kernel and plain version
# differ only in the order of the f32 sums (27 taps x Cin terms)
K1_RTOL = 1e-4
# dw_per_tap tolerance, per tap relative to ||d_w[k]||: the same bf16
# products summed over up to n_out rows in f32, in another order
DW_RTOL = 1e-4
# tiny-config train step, GPU against CPU (tests/test_torch_train.py):
# losses of the bf16 chain, gradients per leaf (relative L2) and in total
TRAIN_LOSS_TOL = 4e-3
TRAIN_LEAF_TOL = 5e-2
TRAIN_TOTAL_TOL = 1e-2
TRAIN_LR_RULES = {"seg_core": 0.2}
# the submodules that must get a gradient (tests/test_train.py's list, and the segmentor core)
MUST_TRAIN = ("frustum_head", "fsd_branch", "combine_frustum_mlp", "combine_fsd_mlp",
              "refine_sir_0", "refined_head_0", "out_proj_0", "position_encoder_0",
              "lidar_img_mlp_0", "refine_img_mlp_0", "frustum", "seg_enhance_mlp", "seg_core")
# bf16 UNet chain on two devices (cuDNN vs CPU conv3d, kernel vs plain sums):
# a bf16 rounding step can land one ulp apart, 2^-8 relative
BF16_CHAIN_TOL = 4e-3


def log(obj) -> None:
    print(json.dumps(obj) if not isinstance(obj, str) else obj, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _event_ms(run, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_ms(fn, reps: int) -> float:
    """Mean device ms of a kernel call ``fn()``: after one warm-up call,
    ``reps`` calls are captured into one CUDA graph, whose replay is timed
    with CUDA events, so the host's launch work does not count (L2 stays
    warm between calls)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _event_ms(graph.replay, reps)


def eager_ms(fn, reps: int) -> float:
    """Mean ms of ``fn()`` over ``reps`` back-to-back eager calls (CUDA
    events, after one warm-up call): host-bound when a call is short."""
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()
    return _event_ms(run, reps)


@contextlib.contextmanager
def capture_calls(module, name: str, sink: list):
    """Record a copy of every call's arguments to ``module.name``."""
    orig = getattr(module, name)

    def recorder(*args):
        sink.append(tuple(a.clone() if torch.is_tensor(a) else a for a in args))
        return orig(*args)

    # the wrapper counts its launches on the module attribute of its name
    recorder.launches = 0
    setattr(module, name, recorder)
    try:
        yield
    finally:
        setattr(module, name, orig)


@contextlib.contextmanager
def capture_results(module, name: str, sink: list):
    """Record what every call of ``module.name`` returns."""
    orig = getattr(module, name)

    def recorder(*args):
        sink.append(orig(*args))
        return sink[-1]

    setattr(module, name, recorder)
    try:
        yield
    finally:
        setattr(module, name, orig)


def kernel_wrappers() -> dict:
    """Each kernel's wrapper, which counts its launches in ``.launches``."""
    from fullysparsefusion_tpu_torch.ops import ccl, nms, segment, sparse_conv

    return {"gather_conv": sparse_conv.gather_conv, "ccl_roots": ccl.ccl_roots,
            "nms_keep": nms.nms_keep, "dw_per_tap": sparse_conv.dw_per_tap,
            "segment_sum": segment.segment_sum}


def counts(wrappers) -> dict:
    return {name: fn.launches for name, fn in wrappers.items()}


def zero(wrappers) -> None:
    for fn in wrappers.values():
        fn.launches = 0


def build_kernels():
    """The CUDA kernels (one ``nvcc`` per source, all at once) and the host
    loader library (``g++``) into ``build/``."""
    from fullysparsefusion_tpu_torch import kernels
    from fullysparsefusion_tpu_torch.data import native

    t0 = time.perf_counter()
    per = kernels.build_all()
    t1 = time.perf_counter()
    native.build()
    log({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
         "per_source_seconds": {k: round(v, 3) for k, v in per.items()},
         "host_library_seconds": round(time.perf_counter() - t1, 3)})


def small_reference_check(device="cuda"):
    """Tiny FSF: GPU (kernels) against CPU (plain versions), same weights."""
    from fullysparsefusion_tpu_torch import synthetic as S
    from fullysparsefusion_tpu_torch.config import tiny_fsf_config
    from fullysparsefusion_tpu_torch.weights import build_fsf

    cfg = tiny_fsf_config()
    sc = S.make_scene_arrays(seed=0, n_cap=cfg.caps.points, max_gt=cfg.caps.max_gt)
    cam = S.make_camera_arrays(sc["gt_boxes"], sc["gt_labels"], sc["gt_valid"],
                               num_classes=cfg.num_classes)
    ref_model = build_fsf(cfg, seed=0, device="cpu")
    gpu_model = copy.deepcopy(ref_model).to(device)
    outs = {}
    for dev, model in (("cpu", ref_model), (device, gpu_model)):
        pb, cd = S.fsf_inputs(sc, cam, device=dev)
        with torch.inference_mode():
            res = model(pb, cd, 2)
            det = model.get_bboxes(res, 2)
        outs[dev] = (res, det)
    (r_cpu, d_cpu), (r_gpu, d_gpu) = outs["cpu"], outs[device]

    def close(name, a, b, tol):
        a, b = a.float(), b.detach().float().cpu()
        err = (a - b).abs()
        bad = err > tol * (1 + a.abs())
        if bad.any():
            fail(f"small reference: {name} differs by up to {err.max().item():.3g}")
        return err.max().item() if err.numel() else 0.0

    report = {
        "seg_feats": close("seg_feats", r_cpu["seg_out"]["seg_feats"],
                           r_gpu["seg_out"]["seg_feats"], BF16_CHAIN_TOL),
        "final_cls_logits": close("final cls_logits", r_cpu["final"]["cls_logits"],
                                  r_gpu["final"]["cls_logits"], BF16_CHAIN_TOL),
    }
    if not torch.equal(d_cpu.valid, d_gpu.valid.cpu()) or \
            not torch.equal(d_cpu.labels, d_gpu.labels.cpu()):
        fail("small reference: detection validity or labels differ")
    report["det_boxes"] = close("det boxes", d_cpu.boxes, d_gpu.boxes, BF16_CHAIN_TOL)
    report["det_scores"] = close("det scores", d_cpu.scores, d_gpu.scores, BF16_CHAIN_TOL)
    n_det = int(d_cpu.valid.sum())
    n_cam = int(r_cpu["frustum"]["obj_valid"].sum())
    n_lidar = int(r_cpu["fsd"]["num_clusters"])
    if min(n_det, n_cam, n_lidar) <= 0:
        fail(f"small reference scene is vacuous: {n_det} det, {n_cam} cam, {n_lidar} lidar")
    log({"phase": "small_reference", "detections": n_det, "camera_queries": n_cam,
         "lidar_queries": n_lidar, "tolerance": BF16_CHAIN_TOL,
         "max_abs_err": {k: float(f"{v:.3g}") for k, v in report.items()}})


def bench_config():
    """Full-width nuScenes FSF at the JAX package bench's capacities, batch 1
    (``config.bench_fsf_config``)."""
    from fullysparsefusion_tpu_torch.config import bench_fsf_config

    return bench_fsf_config(1)


def bench_scene(seed: int, cfg):
    """The JAX package bench's scene and cameras (NumPy arrays), batch 1."""
    from fullysparsefusion_tpu_torch import synthetic as S

    sc = S.make_lidar_scene_arrays(seed=seed, n_cap=cfg.caps.points, max_gt=cfg.caps.max_gt,
                                   n_boxes=32, extent=48.0)
    cam = S.make_camera_arrays(sc["gt_boxes"], sc["gt_labels"], sc["gt_valid"], batch_size=1,
                               num_cams=cfg.num_cams, num_classes=cfg.num_classes,
                               img_h=450, img_w=800, max_anno=250, fx=400.0)
    return sc, cam


def bench_request(seed: int, cfg, device="cuda"):
    """One bench-scale request on ``device``: the JAX package bench's scene."""
    from fullysparsefusion_tpu_torch import synthetic as S

    return S.fsf_inputs(*bench_scene(seed, cfg), device=device)


def serve(model, requests):
    """Forward + get_bboxes per request; returns the detections per request."""
    dets = []
    for seed, (pb, cam) in requests:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        with torch.inference_mode():
            res = model(pb, cam, 1)
            det = model.get_bboxes(res, 1)
        end.record()
        det = type(det)(*[t.cpu() for t in det])  # the answer reaches the host
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        for name, t in zip(det._fields, det):
            if t.is_floating_point() and not torch.isfinite(t).all():
                fail(f"request seed {seed}: non-finite {name}")
        if det.valid.shape != (1, model.cfg.refined_head.max_num):
            fail(f"request seed {seed}: detections shape {tuple(det.valid.shape)}")
        log({"phase": "request", "seed": seed,
             "detections": int(det.valid.sum()),
             "camera_queries": int(res["frustum"]["obj_valid"].sum()),
             "lidar_queries": int(res["fsd"]["num_clusters"]),
             "gpu_ms": round(start.elapsed_time(end), 3), "host_ms": round(host_ms, 3),
             "peak_mem_mib": round(torch.cuda.max_memory_allocated() / 2**20, 1)})
        dets.append(det)
    return dets


def check_gather_conv(feats, rows, w, plan=None) -> float:
    """K1 against its plain version; fails beyond ``K1_RTOL`` of the output's
    magnitude or if two runs differ. Returns the largest absolute error."""
    from fullysparsefusion_tpu_torch.ops import sparse_conv

    got = sparse_conv.gather_conv(feats, rows, w, plan)
    again = sparse_conv.gather_conv(feats, rows, w, plan)
    ref = sparse_conv.gather_conv_plain(feats, rows, w)
    err = (got - ref).abs().max().item() if ref.numel() else 0.0
    scale = max(1.0, ref.abs().max().item() if ref.numel() else 0.0)
    if not err <= K1_RTOL * scale:
        fail(f"gather_conv {tuple(feats.shape)}->{tuple(ref.shape)} err {err:.3g}")
    if not torch.equal(got, again):
        fail(f"gather_conv {tuple(feats.shape)}->{tuple(ref.shape)} differs between two runs")
    return err


def tile_taps(plan, k3: int) -> torch.Tensor:
    """Taps each kernel tile walks: the OR of its rows' masks, counted."""
    from fullysparsefusion_tpu_torch.ops.sparse_conv import TILE_ROWS

    m = plan.masks[plan.order.long()]
    m = torch.nn.functional.pad(m, (0, -m.numel() % TILE_ROWS)).view(-1, TILE_ROWS)
    bits = (m[..., None] >> torch.arange(k3, device=m.device, dtype=m.dtype)) & 1
    return bits.amax(dim=1).sum(dim=1)


def adversarial_gather_conv(feats, rows, w):
    """K1 on rulebooks made on the card to hit its edges: a tile of rows with
    no hit, every slot a miss, exactly one hit per row, ``n_out`` off the
    tile, and Cin 16 / Cout 48."""
    from fullysparsefusion_tpu_torch.ops.sparse_conv import TILE_ROWS

    n_src, n_out = feats.shape[0], rows.shape[1]
    g = torch.Generator(device=feats.device).manual_seed(0)
    cases = {}
    r = rows.clone()
    r[:, 3 * TILE_ROWS:5 * TILE_ROWS] = n_src
    cases["all_miss_tile"] = (feats, r, w)
    cases["every_slot_misses"] = (feats, torch.full_like(rows, n_src), w)
    r = torch.full_like(rows, n_src)
    tap = torch.randint(0, rows.shape[0], (n_out,), generator=g, device=rows.device)
    r[tap, torch.arange(n_out, device=rows.device)] = torch.randint(
        0, n_src, (n_out,), generator=g, device=rows.device, dtype=torch.int32)
    cases["one_hit_per_row"] = (feats, r, w)
    cases["n_out_off_tile"] = (feats, rows[:, :n_out - 77].contiguous(), w)
    f16 = torch.randn(n_src, 16, generator=g, device=feats.device).to(torch.bfloat16)
    w48 = (torch.randn(rows.shape[0], 16, 48, generator=g, device=feats.device) / 20.0
           ).to(torch.bfloat16)
    cases["cin16_cout48"] = (f16, rows, w48)
    errs = {name: check_gather_conv(*args) for name, args in cases.items()}
    log({"phase": "kernel_adversarial", "kernel": "gather_conv", "tolerance": K1_RTOL,
         "max_abs_err": errs})


def components(roots) -> list:
    """Components per problem of a [G, N] roots tensor (-1 invalid)."""
    return [int(((r == torch.arange(r.numel(), device=r.device)) & (r >= 0)).sum())
            for r in roots]


def check_ccl_roots(xy, batch, valid, what: str):
    """K2 against its plain version, bitwise, and two runs against each
    other. Returns the roots and the plain version's sweeps."""
    from fullysparsefusion_tpu_torch.ops import ccl

    got = ccl.ccl_roots(xy, batch, valid)
    again = ccl.ccl_roots(xy, batch, valid)
    ref = ccl.ccl_roots_plain(xy, batch, valid)
    if not torch.equal(got, ref):
        fail(f"ccl_roots differs from its plain version on {what} at "
             f"{int((got != ref).sum())} nodes")
    if not torch.equal(got, again):
        fail(f"ccl_roots differs between two runs on {what}")
    return got, ccl.ccl_roots_plain.sweeps


# (case of synthetic.ccl_problem_arrays, G, N)
CCL_ADVERSARIAL = (("reversed_chain", 6, 1024), ("grid", 6, 1024), ("random", 6, 1000),
                   ("random", 1, 8192), ("random", 1, 12000), ("coincident", 6, 1024),
                   ("mixed_batch", 6, 1024), ("all_invalid", 6, 1024))
# N of synthetic.ccl_known_components: parent[] in device memory past ~46k
# nodes; each case (chain length, runs) is run that many times, since the
# union-find's hooks and path halving interleave differently each run
CCL_KNOWN_N = 50000
CCL_KNOWN_CASES = ((100, 10), (45000, 10))


def adversarial_ccl_roots():
    """K2 on the inputs that are hard for a sweep-based CCL (the reversed
    chain: one sweep per hop; one component of all N nodes), N off the word
    and past the old 8,192 cap (12,000: parent[] in opted-in shared memory),
    complete graphs, batch ids that split them and all-invalid nodes: bitwise
    against the plain version, each timed. Then 50,000 nodes (parent[] in
    device memory), too many for the plain version's [N, N] distances,
    against components known by construction, ten runs each of chains of
    100 with stacks of 50 and of one chain of 45,000 nodes."""
    from fullysparsefusion_tpu_torch import synthetic as S
    from fullysparsefusion_tpu_torch.ops import ccl

    cases = {}
    for case, g, n in CCL_ADVERSARIAL:
        xy, batch, valid = (torch.as_tensor(a, device="cuda")
                            for a in S.ccl_problem_arrays(case, g, n))
        got, sweeps = check_ccl_roots(xy, batch, valid, f"{case} G={g} N={n}")
        cases[f"{case}_g{g}_n{n}"] = {
            "components": components(got), "plain_sweeps": sweeps,
            "ms": round(time_ms(functools.partial(ccl.ccl_roots, xy, batch, valid), 20), 5)}
        del xy, batch, valid, got
        torch.cuda.empty_cache()
    for chain, runs in CCL_KNOWN_CASES:
        xy, batch, valid, roots = (torch.as_tensor(a, device="cuda")
                                   for a in S.ccl_known_components(CCL_KNOWN_N, chain=chain))
        call = functools.partial(ccl.ccl_roots, xy, batch, valid)
        for run in range(runs):
            got = call()
            if not torch.equal(got, roots):
                fail(f"ccl_roots misses the known components at N={CCL_KNOWN_N}, chains of "
                     f"{chain}, run {run}, at {int((got != roots).sum())} nodes")
        cases[f"known_components_chain{chain}_g1_n{CCL_KNOWN_N}"] = {
            "components": components(got), "runs": runs, "ms": round(time_ms(call, 5), 5)}
    log({"phase": "kernel_adversarial", "kernel": "ccl_roots", "tolerance": 0,
         "cases": cases})


# K3 past the scan's shared-memory staging: a batch of 12 x 1,280 queries, C = 3
NMS_LARGE_N, NMS_LARGE_C, NMS_SAMPLE = 15360, 3, 1280


def large_nms_keep():
    """K3 at N = 15,360: the scan reads its 64-row mask blocks from device
    memory. A random symmetric IoU with ties (multiples of 1/8) inside each
    sample's 1,280 rows and zero across samples, as the batched NMS gives
    it; bitwise against the plain version, and timed."""
    from fullysparsefusion_tpu_torch.ops import nms

    n, c = NMS_LARGE_N, NMS_LARGE_C
    gen = torch.Generator(device="cuda").manual_seed(0)
    m = torch.rand(n, n, generator=gen, device="cuda")
    sample = torch.arange(n, device="cuda") // NMS_SAMPLE
    iou = torch.where(sample[:, None] == sample[None, :], torch.round((m + m.T) * 4) / 8, 0.0)
    iou.fill_diagonal_(1.0)
    del m
    order, vs = nms.class_orders(torch.rand(c, n, generator=gen, device="cuda"),
                                 torch.rand(c, n, generator=gen, device="cuda") > 0.3)
    vs = vs.contiguous()
    got = nms.nms_keep(iou, order, vs, 0.5)
    ref = nms.nms_keep_plain(iou, order, vs, 0.5)
    if not torch.equal(got, ref):
        fail(f"nms_keep differs from its plain version at N={n} at {int((got != ref).sum())} rows")
    del ref
    torch.cuda.empty_cache()
    log({"phase": "kernel_adversarial", "kernel": "nms_keep", "tolerance": 0, "C": c, "N": n,
         "kept": int(got.sum()), "valid": int(vs.sum()),
         "ms": round(time_ms(functools.partial(nms.nms_keep, iou, order, vs, 0.5), 5), 5)})


# fsf::segment_sum at Argoverse 2's shapes. The foreground's pre-voxelisation:
# 131,072 rows, ~67,000 of them invalid (the trash run), the rest over 60,000
# keys into 98,304 segments, at the widths of its five means. The clusters:
# 24,576 rows into 1,024 segments, sizes skewed to ~2,000 rows in the largest
# and ~1,400 keys (overflow past the capacity), at the widths of the cluster
# means, width 3 as a strided view of 4-wide rows (as the VFE's xyz is).
SEGMENT_PREVOX = dict(rows=131072, capacity=98304, invalid=67000, keys=60000,
                      widths=(4, 27, 81, 128))
SEGMENT_CLUSTERS = dict(rows=24576, capacity=1024, invalid=2458, keys=1400, widths=(1, 3))
# segment_sum launches in one FSF request and in one train step (both
# configurations): the VFE's mean, the camera queries' weighted centres, five
# pre-voxel means, one cluster-voxel mean per class group (six), three cluster means
FSF_SEGMENT_SUMS = 16


def segment_sum_bytes(width: int, offsets) -> float:
    """fsf::segment_sum's least bytes: each valid row's ``width`` f32 read
    and its ``order`` entry, each segment's row written and its offset."""
    capacity, valid = offsets.shape[0] - 1, int(offsets[-1])
    return 4.0 * (valid * (width + 1) + capacity * width + capacity + 1)


def index_put_sum(feat, seg_id, capacity):
    """The library call that fsf::segment_sum replaced on the main path:
    ``index_put_(accumulate=True)`` into ``capacity + 1`` rows."""
    out = feat.new_zeros((capacity + 1,) + feat.shape[1:])
    out.index_put_((seg_id.long(),), feat, accumulate=True)
    return out[:capacity]


def replay_segment_sum(seg, feat, what: str, **tags) -> dict:
    """One segment sum through ``seg`` (a ``SegmentInfo`` with its CSR) on
    the card: twice bitwise equal, bitwise the plain version on the CPU, one
    launch and no host sync (``torch.cuda.set_sync_debug_mode``), the bare-id
    form bitwise the same; graph-timed beside its byte bound and
    ``index_put_sum`` (``library_ms``); the plain version's host ms."""
    from fullysparsefusion_tpu_torch.ops import segment

    cap = seg.capacity
    before = segment.segment_sum.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = seg.sum(feat)
        again = seg.sum(feat)
        bare = segment.segment_sum(feat, seg.seg_id, cap)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if segment.segment_sum.launches - before != 3:
        fail(f"segment_sum {what}: {segment.segment_sum.launches - before} launches for 3 calls")
    t0 = time.perf_counter()
    ref = segment.segment_sum_plain(feat.cpu(), seg.seg_id.cpu(), cap)
    plain_ms = (time.perf_counter() - t0) * 1e3
    for name, x in (("a repeat", again), ("the bare-id form", bare), ("the plain version", ref)):
        if not torch.equal(got.cpu(), x.cpu()):
            fail(f"segment_sum {what}: differs from {name} at "
                 f"{int((got.cpu() != x.cpu()).sum())} entries")
    width = feat[0].numel()
    bound_ms = segment_sum_bytes(width, seg.offsets) / PEAK_BYTES * 1e3
    ms = time_ms(lambda: seg.sum(feat), 20)
    hold_bound(f"segment_sum {what}", ms, bound_ms)
    res = dict(ms=ms, bound_ms=bound_ms, plain_ms=plain_ms,
               library_ms=time_ms(lambda: index_put_sum(feat, seg.seg_id, cap), 5))
    log({"phase": "segment_sum_call", "what": what, **tags, "rows": feat.shape[0],
         "width": width, "row_stride": feat.stride(0), "capacity": cap,
         "valid_rows": int(seg.offsets[-1]), "segments": int(seg.num_segments),
         "largest": int(seg.counts.max()),
         **{k: round(v, 5) for k, v in res.items()},
         "share_of_bound": round(bound_ms / ms, 4), "bitwise": True})
    return res


def replay_request_sums(sums, what: str, shape: str, phase: str) -> dict:
    """The ``FSF_SEGMENT_SUMS`` ``SegmentInfo.sum`` calls of one FSF request
    or train step's forward, as ``capture_calls`` recorded them, each through
    ``replay_segment_sum``; logs their totals as ``phase``, returns them."""
    if len(sums) != FSF_SEGMENT_SUMS:
        fail(f"one {what} made {len(sums)} segment sums, not {FSF_SEGMENT_SUMS}")
    with torch.inference_mode():
        per_call = [replay_segment_sum(seg, feat.detach(), f"{what} call {i}", shape=shape)
                    for i, (seg, feat) in enumerate(sums)]
    tot = {k: sum(r[k] for r in per_call) for k in per_call[0]}
    log({"phase": phase, "calls": len(per_call), **{k: round(v, 5) for k, v in tot.items()}})
    return tot


def segment_sum_phase() -> dict:
    """fsf::segment_sum at ``SEGMENT_PREVOX``'s and ``SEGMENT_CLUSTERS``'
    shapes, ids from ``unique_segments`` on the card (``replay_segment_sum``
    for each width). Returns the totals of each shape."""
    from fullysparsefusion_tpu_torch.ops import segment

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    totals = {}
    for name, case in (("prevox", SEGMENT_PREVOX), ("clusters", SEGMENT_CLUSTERS)):
        n = case["rows"]
        valid = torch.randperm(n, generator=gen, device="cuda") >= case["invalid"]
        u = torch.rand(n, generator=gen, device="cuda")
        if name == "clusters":
            u = u ** 3                  # skewed: the first keys hold the largest clusters
        keys = (u * case["keys"]).to(torch.int32)
        seg = segment.unique_segments(keys, valid, case["capacity"])
        tot = dict(ms=0.0, bound_ms=0.0, plain_ms=0.0, library_ms=0.0)
        for w in case["widths"]:
            if name == "clusters" and w == 3:
                feat = torch.randn(n, 4, generator=gen, device="cuda")[:, :3]
            else:
                feat = torch.randn((n, w) if w > 1 else (n,), generator=gen, device="cuda")
            res = replay_segment_sum(seg, feat, f"{name} width {w}", shape=name)
            for k in tot:
                tot[k] += res[k]
        totals[name] = tot
    log({"phase": "segment_sum", "totals": {k: {m: round(v, 5) for m, v in t.items()}
                                            for k, t in totals.items()},
         "seconds": round(time.perf_counter() - t0, 3)})
    return totals


def gather_conv_cost(feats, rows, w):
    """K1's rulebook hits, FLOPs and bytes (each input read once, the output
    written once)."""
    n_src, cin = feats.shape
    k3, n_out = rows.shape
    cout = w.shape[2]
    hits = int((rows < n_src).sum())
    flop = 2.0 * hits * cin * cout
    byte = 2.0 * n_src * cin + 4.0 * k3 * n_out + 2.0 * k3 * cin * cout + 4.0 * n_out * cout
    return hits, flop, byte


def ccl_cost(xy, batch, valid):
    """K2's FLOPs (one distance test per valid same-batch pair) and bytes."""
    g, n = valid.shape
    same = (batch[:, :, None] == batch[:, None, :]) & valid[:, :, None] & valid[:, None, :]
    return 5.0 * float(same.sum()), g * n * (8 + 4 + 1 + 4)


def nms_cost(iou, order, valid_sorted, keep, thr):
    """K3's least work on this call's data: the IoU entries (earlier row,
    later row) that a greedy scan must read, one compare each. Per class
    those are every pair of kept rows and, for each suppressed valid row, its
    first suppressor; an entry that several classes need counts once. Bytes:
    those entries, ``order`` and ``valid_sorted`` read, ``keep`` written.
    (The whole ``4 · N²`` matrix overstates it wherever the classes' valid
    sets are small or disjoint, as in the TTA union, where each box is valid
    in its own label's class only.)"""
    c, n = order.shape
    need = torch.zeros(n, n, dtype=torch.bool, device=iou.device)
    later = torch.ones(n, n, dtype=torch.bool, device=iou.device).triu(1)
    for k in range(c):
        o = order[k].long()
        kept = keep[k]
        i, j = (later & kept[:, None] & kept[None, :]).nonzero().unbind(1)
        need[o[i], o[j]] = True
        over = (iou[o[:, None], o[None, :]] > thr) & later & kept[:, None]
        j = (valid_sorted[k] & ~kept).nonzero().squeeze(1)
        need[o[over[:, j].int().argmax(0)], o[j]] = True
    entries = float(need.sum())
    return entries, 4.0 * entries + c * n * (4 + 1 + 1)


def bound(flop, byte, peak_flops):
    """(bound ms, what bounds it) of work of ``flop`` operations at
    ``peak_flops`` moving ``byte`` bytes."""
    return (max(flop / peak_flops, byte / PEAK_BYTES) * 1e3,
            "operations" if flop / peak_flops > byte / PEAK_BYTES else "bytes")


def capture_request(run):
    """Every K1, K2 and K3 call of ``run()`` (one request), by kernel."""
    from fullysparsefusion_tpu_torch.ops import ccl, nms, sparse_conv

    calls = {"gather_conv": [], "ccl_roots": [], "nms_keep": []}
    with capture_calls(sparse_conv, "gather_conv", calls["gather_conv"]), \
            capture_calls(ccl, "ccl_roots", calls["ccl_roots"]), \
            capture_calls(nms, "nms_keep", calls["nms_keep"]), torch.inference_mode():
        run()
    torch.cuda.synchronize()
    return calls


def replay_gather_conv(calls, phase: str) -> dict:
    """K1: each captured call (with its plan) held to its plain version and
    timed; logs one ``phase`` line with every call. Returns the totals."""
    from fullysparsefusion_tpu_torch.ops import sparse_conv

    rows_out, tot = [], dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, err=0.0, flop=0.0, byte=0.0)
    for feats, rows, w, plan in calls:
        err = check_gather_conv(feats, rows, w, plan)
        n_src, cin = feats.shape
        k3, n_out = rows.shape
        cout = w.shape[2]
        hits, flop, byte = gather_conv_cost(feats, rows, w)
        ms = time_ms(lambda: sparse_conv.gather_conv(feats, rows, w, plan), 20)
        eager = eager_ms(lambda: sparse_conv.gather_conv(feats, rows, w, plan), 20)
        plain_ms = eager_ms(lambda: sparse_conv.gather_conv_plain(feats, rows, w), 5)
        bound_ms = bound(flop, byte, PEAK_BF16_FLOPS)[0]
        taps = tile_taps(plan, k3)
        rows_out.append({"n_src": n_src, "n_out": n_out, "cin": cin, "cout": cout, "hits": hits,
                         "hit_share": round(hits / (k3 * n_out), 4),
                         "taps_per_tile": round(float(taps.float().mean()), 3),
                         "all_miss_tiles": int((taps == 0).sum()), "tiles": int(taps.numel()),
                         "ms": round(ms, 4), "eager_ms": round(eager, 4),
                         "plain_ms": round(plain_ms, 4),
                         "bound_ms": round(bound_ms, 5), "max_abs_err": err})
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound_ms), ("flop", flop),
                     ("byte", byte)):
            tot[k] += v
        tot["err"] = max(tot["err"], err)
    log({"phase": phase, "kernel": "gather_conv", "calls": rows_out})
    return dict(max_abs_err=tot["err"], ms=tot["ms"], plain_ms=tot["plain_ms"],
                bound_ms=tot["bound_ms"], bound_by=bound(tot["flop"], tot["byte"],
                                                         PEAK_BF16_FLOPS)[1], calls=rows_out)


def replay_ccl_roots(call, phase: str) -> dict:
    """K2: the captured call held bitwise to its plain version and timed;
    logs one ``phase`` line. Returns its numbers."""
    from fullysparsefusion_tpu_torch.ops import ccl

    xy, batch, valid = call
    got, sweeps = check_ccl_roots(xy, batch, valid, "the request's call")
    g, n = valid.shape
    bound_ms, bound_by = bound(*ccl_cost(xy, batch, valid), PEAK_F32_FLOPS)
    run = functools.partial(ccl.ccl_roots, xy, batch, valid)
    res = dict(max_abs_err=0.0, ms=time_ms(run, 20),
               plain_ms=eager_ms(lambda: ccl.ccl_roots_plain(xy, batch, valid), 3),
               bound_ms=bound_ms, bound_by=bound_by)
    log({"phase": phase, "kernel": "ccl_roots", "G": g, "N": n,
         "valid_per_problem": valid.sum(1).tolist(), "components": components(got),
         "plain_sweeps": sweeps, "ms": round(res["ms"], 5),
         "eager_ms": round(eager_ms(run, 20), 5)})
    return res


def replay_nms_keep(call, phase: str, **tags) -> dict:
    """K3: the captured call held bitwise to its plain version and timed;
    logs one ``phase`` line (with ``tags``). Returns its numbers, the FLOPs
    and bytes included."""
    from fullysparsefusion_tpu_torch.ops import nms

    iou, order, vs, thr = call
    got = nms.nms_keep(iou, order, vs, thr)
    ref = nms.nms_keep_plain(iou, order, vs, thr)
    if not torch.equal(got, ref):
        fail(f"nms_keep differs from its plain version at {int((got != ref).sum())} rows")
    c, n = order.shape
    flop, byte = nms_cost(iou, order, vs, got, thr)
    bound_ms, bound_by = bound(flop, byte, PEAK_F32_FLOPS)
    run = functools.partial(nms.nms_keep, iou, order, vs, thr)
    res = dict(max_abs_err=0.0, ms=time_ms(run, 20),
               plain_ms=eager_ms(lambda: nms.nms_keep_plain(iou, order, vs, thr), 3),
               bound_ms=bound_ms, bound_by=bound_by, flop=flop, byte=byte)
    log({"phase": phase, "kernel": "nms_keep", **tags, "C": c, "N": n,
         "kept": int(got.sum()), "valid": int(vs.sum()),
         "ms": round(res["ms"], 5), "eager_ms": round(eager_ms(run, 20), 5)})
    return res


def check_kernels(model, request):
    """Replay every kernel call of one request against its plain version
    (``segment_sum``'s calls through ``replay_request_sums``)."""
    from fullysparsefusion_tpu_torch.ops import segment

    sums = []
    with capture_calls(segment.SegmentInfo, "sum", sums):
        calls = capture_request(lambda: model.get_bboxes(model(*request, 1), 1))
    results = {"segment_sum": replay_request_sums(sums, "nuScenes request", "nusc_request",
                                                  "nusc_segment_sum")}
    results["gather_conv"] = replay_gather_conv(calls["gather_conv"], "kernel_calls")
    adversarial_gather_conv(*calls["gather_conv"][0][:3])
    (call,) = calls["ccl_roots"]
    results["ccl_roots"] = replay_ccl_roots(call, "kernel_calls")
    adversarial_ccl_roots()
    (call,) = calls["nms_keep"]
    results["nms_keep"] = replay_nms_keep(call, "kernel_calls")
    del results["nms_keep"]["flop"], results["nms_keep"]["byte"]
    large_nms_keep()
    return results


def gather_only(cfg):
    """``cfg`` with every UNet conv on the gather path (K1 and dw_per_tap)."""
    seg = dataclasses.replace(cfg.fsd.segmentor, unet_dense_min_occupancy=2.0)
    return dataclasses.replace(cfg, fsd=dataclasses.replace(cfg.fsd, segmentor=seg))


def small_train_reference_check(device="cuda"):
    """Tiny FSF forward + losses + backward: GPU (kernels) against CPU (plain
    versions), same weights and scene, every UNet conv on the gather path as
    the CPU parity test runs it against the JAX package.

    Both BN forms run, and each is held on its losses (the integer
    diagnostics exactly). With eval-form BN both devices take the same
    discrete decisions and the whole gradient tree is held to the CPU
    tests' total tolerance. Single leaves are reported, not held: the
    deepest UNet stage's weight gradients are near-cancelling sums, which a
    perturbation of K1's output at f32 rounding level moves by percents
    (``tools/grad_noise_floor.py`` measures it on the CPU), and K1 sums in
    another order than its plain version. With train-form BN a bf16 rounding
    step one ulp apart moves a decoded box far enough to flip a point's RoI
    membership, which changes the refinement stage's gradients outright."""
    from fullysparsefusion_tpu_torch import synthetic as S
    from fullysparsefusion_tpu_torch.config import tiny_fsf_config
    from fullysparsefusion_tpu_torch.parallel.train import total_loss
    from fullysparsefusion_tpu_torch.weights import build_fsf

    cfg = gather_only(tiny_fsf_config())
    sc = S.make_scene_arrays(seed=0, n_cap=cfg.caps.points, max_gt=cfg.caps.max_gt)
    cam = S.make_camera_arrays(sc["gt_boxes"], sc["gt_labels"], sc["gt_valid"],
                               num_classes=cfg.num_classes)
    ref_model = build_fsf(cfg, seed=0, device="cpu")
    report = {}
    for form, train in (("eval_bn", False), ("train_bn", True)):
        res = {}
        for dev in ("cpu", device):
            model = copy.deepcopy(ref_model).to(dev)
            pb, cd = S.fsf_inputs(sc, cam, device=dev)
            gt = S.to_ground_truth(sc, device=dev)
            losses = model(pb, cd, 2, gt, gt, train=train)["losses"]
            total_loss(losses).backward()
            res[dev] = ({k: float(v.detach()) for k, v in losses.items()},
                        {n: p.grad.detach().float().cpu() for n, p in model.named_parameters()})
        (l_cpu, g_cpu), (l_gpu, g_gpu) = res["cpu"], res[device]
        if set(l_cpu) != set(l_gpu):
            fail(f"small train reference ({form}): loss keys differ")
        worst_loss = 0.0
        for k, a in l_cpu.items():
            b = l_gpu[k]
            if not (math.isfinite(a) and math.isfinite(b)):
                fail(f"small train reference ({form}): non-finite {k}")
            exact = "num_pos" in k or "recall" in k
            err = abs(a - b) / max(1.0, abs(a))
            if (exact and a != b) or err > TRAIN_LOSS_TOL:
                fail(f"small train reference ({form}): {k} {a} on the CPU, {b} on the GPU")
            worst_loss = max(worst_loss, err)
        num = den = 0.0
        leaves = []
        for n, a in g_cpu.items():
            d, m = float((g_gpu[n] - a).norm()), float(a.norm())
            leaves.append((d / max(m, 1e-12), n))
            num, den = num + d * d, den + m * m
        total = (num / den) ** 0.5
        if not train and total > TRAIN_TOTAL_TOL:
            fail(f"small train reference ({form}): gradient tree differs by {total:.3g}")
        leaves.sort(reverse=True)
        report[form] = {"loss_rel_err": float(f"{worst_loss:.3g}"),
                        "grad_total_rel_err": float(f"{total:.3g}"),
                        "gradients_held": not train,
                        "leaves_over_leaf_tol": sum(e > TRAIN_LEAF_TOL for e, _ in leaves),
                        "leaves": len(leaves),
                        "worst_leaves": [[n, float(f"{e:.3g}")] for e, n in leaves[:4]]}
    log({"phase": "small_train_reference", "losses": len(l_cpu), **report,
         "tolerance": {"loss": TRAIN_LOSS_TOL, "total": TRAIN_TOTAL_TOL,
                       "leaf_reported": TRAIN_LEAF_TOL}})


def train_setup(cfg, device="cuda"):
    """The full-width model, its optimizer and the seed-0 bench batch with
    its own GT as both the augmented and the no-aug GT."""
    from fullysparsefusion_tpu_torch import synthetic as S
    from fullysparsefusion_tpu_torch.parallel.train import Batch, make_optimizer
    from fullysparsefusion_tpu_torch.weights import build_fsf

    sc, cam = bench_scene(0, cfg)
    pb, cd = S.fsf_inputs(sc, cam, device=device)
    gt = S.to_ground_truth(sc, device=device)
    model = build_fsf(cfg, seed=0, device=device)
    opt = make_optimizer(model, base_lr=1e-4, total_steps=100, lr_mult_rules=TRAIN_LR_RULES)
    return model, opt, Batch(pb, cd, gt, gt)


TRAIN_WARMUP, TRAIN_STEPS = 2, 5


def train(model, opt, batch, wrappers, must_train=MUST_TRAIN, phase="train", held=None,
          steps=TRAIN_STEPS):
    """Two warm-up steps, then ``steps`` timed ones with the launch counters
    zeroed just before and read just after; every loss must be finite, the
    sum of the ``held`` loss terms (None: the summed loss) must fall from
    the first timed step to the last, and each submodule of ``must_train``
    must get a gradient. Logs ``{phase}_step`` lines and a ``phase`` line.
    Returns the launches and K1's per pass per step."""
    from fullysparsefusion_tpu_torch.ops import sparse_conv
    from fullysparsefusion_tpu_torch.parallel.train import train_step
    from fullysparsefusion_tpu_torch.train.hooks import RuntimeSchedule

    sched = RuntimeSchedule()
    for step in range(TRAIN_WARMUP):
        train_step(model, opt, sched, batch, step)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero(wrappers)
    plans0 = sparse_conv.plan_rulebook.calls
    totals, watched, split = [], [], {"forward_ms": [], "backward_ms": [], "optimizer_ms": []}
    k1 = {"forward": [], "backward": []}
    for step in range(TRAIN_WARMUP, TRAIN_WARMUP + steps):
        events = {ph: torch.cuda.Event(enable_timing=True)
                  for ph in ("start", "forward", "backward", "optimizer")}
        k1_at = {}

        def mark(phase):
            events[phase].record()
            k1_at[phase] = sparse_conv.gather_conv.launches

        t0 = time.perf_counter()
        mark("start")
        loss, losses, gnorm = train_step(model, opt, sched, batch, step, mark)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        losses = {k: float(v) for k, v in losses.items()}
        for k, v in losses.items():
            if not math.isfinite(v):
                fail(f"train step {step}: non-finite {k}")
        totals.append(float(loss))
        watched.append(totals[-1] if held is None else sum(losses[k] for k in held))
        phases = {}
        for a, b in (("start", "forward"), ("forward", "backward"), ("backward", "optimizer")):
            phases[f"{b}_ms"] = events[a].elapsed_time(events[b])
            split[f"{b}_ms"].append(phases[f"{b}_ms"])
        k1["forward"].append(k1_at["forward"] - k1_at["start"])
        k1["backward"].append(k1_at["backward"] - k1_at["forward"])
        log({"phase": f"{phase}_step", "step": step, "loss": totals[-1], "grad_norm": float(gnorm),
             "gpu_ms": round(events["start"].elapsed_time(events["optimizer"]), 3),
             "host_ms": round(host_ms, 3), **{k: round(v, 3) for k, v in phases.items()},
             "losses": losses})
    launches = counts(wrappers)
    if not watched[-1] < watched[0]:
        fail(f"the {'summed loss' if held is None else ' + '.join(held)} did not fall over "
             f"the timed steps: {watched}")
    for name in must_train:
        norm = sum(float(p.grad.float().norm()) ** 2
                   for p in model.get_submodule(name).parameters() if p.grad is not None)
        if not norm > 0.0:
            fail(f"zero gradient reaching {name}")
    for name in ("gather_conv", "dw_per_tap", "ccl_roots"):
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the train path")
    per_step = {name: n / steps for name, n in launches.items()}
    log({"phase": phase, "steps": steps, "loss_first": totals[0], "loss_last": totals[-1],
         **({} if held is None else {"held": held, "held_first": watched[0],
                                     "held_last": watched[-1]}),
         "mean_ms": {k: round(sum(v) / len(v), 3) for k, v in split.items()},
         "peak_mem_mib": round(torch.cuda.max_memory_allocated() / 2**20, 1),
         "launches_per_step": per_step,
         "gather_conv_per_step": {k: sum(v) / len(v) for k, v in k1.items()},
         "plan_rulebook_per_step": (sparse_conv.plan_rulebook.calls - plans0) / steps,
         "parameters": sum(p.numel() for p in model.parameters())})
    return launches, {k: sum(v) / len(v) for k, v in k1.items()}


def check_dw_per_tap(feats, rows, g, plan=None) -> float:
    """dw_per_tap against its plain version; fails beyond ``DW_RTOL`` of each
    tap's ``||d_w[k]||`` or if two runs differ. Returns the largest absolute
    error."""
    from fullysparsefusion_tpu_torch.ops import sparse_conv

    got = sparse_conv.dw_per_tap(feats, rows, g, plan)
    again = sparse_conv.dw_per_tap(feats, rows, g, plan)
    ref = sparse_conv.dw_per_tap_plain(feats, rows, g)
    diff = (got - ref).flatten(1).norm(dim=1)
    if not bool((diff <= DW_RTOL * ref.flatten(1).norm(dim=1)).all()):
        fail(f"dw_per_tap {tuple(feats.shape)} x {tuple(g.shape)}: per-tap relative error "
             f"{float((diff / ref.flatten(1).norm(dim=1).clamp(min=1e-30)).max()):.3g}")
    if not torch.equal(got, again):
        fail(f"dw_per_tap {tuple(feats.shape)} x {tuple(g.shape)} differs between two runs")
    return float((got - ref).abs().max())


def check_train_kernels(model, opt, batch, step: int, phase="train_kernel_calls"):
    """One more train step with K1's and dw_per_tap's calls captured; each
    backward call is held to its plain version on the card and timed
    (logged as ``phase`` lines)."""
    from fullysparsefusion_tpu_torch.ops import sparse_conv
    from fullysparsefusion_tpu_torch.parallel.train import train_step
    from fullysparsefusion_tpu_torch.train.hooks import RuntimeSchedule

    k1_calls, dw_calls, n_fwd = [], [], {}
    with capture_calls(sparse_conv, "gather_conv", k1_calls), \
            capture_calls(sparse_conv, "dw_per_tap", dw_calls):
        train_step(model, opt, RuntimeSchedule(), batch, step,
                   lambda phase: n_fwd.setdefault(phase, len(k1_calls)))
    torch.cuda.synchronize()
    results = {}
    rows_out, tot = [], dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, err=0.0)
    for feats, rows, w, plan in k1_calls[n_fwd["forward"]:]:
        err = check_gather_conv(feats, rows, w, plan)
        n_src, cin = feats.shape
        k3, n_out = rows.shape
        cout = w.shape[2]
        hits, flop, byte = gather_conv_cost(feats, rows, w)
        ms = time_ms(lambda: sparse_conv.gather_conv(feats, rows, w, plan), 20)
        plain_ms = eager_ms(lambda: sparse_conv.gather_conv_plain(feats, rows, w), 3)
        bound_ms = bound(flop, byte, PEAK_BF16_FLOPS)[0]
        rows_out.append({"n_src": n_src, "n_out": n_out, "cin": cin, "cout": cout, "hits": hits,
                         "taps_per_tile": round(float(tile_taps(plan, k3).float().mean()), 3),
                         "ms": round(ms, 4), "plain_ms": round(plain_ms, 4),
                         "bound_ms": round(bound_ms, 5), "max_abs_err": err})
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound_ms)):
            tot[k] += v
        tot["err"] = max(tot["err"], err)
    if not rows_out or not any(r["cout"] > 256 for r in rows_out):
        fail("the backward ran no K1 call with more than 256 output channels")
    log({"phase": phase, "kernel": "gather_conv", "role": "d_feats",
         "calls": rows_out, "ms": round(tot["ms"], 4), "bound_ms": round(tot["bound_ms"], 5)})
    results["gather_conv_bwd"] = dict(tot, calls=rows_out)

    rows_out = []
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bmm_ms=0.0, err=0.0, flop=0.0, byte=0.0,
               hits=0, hit_tiles=0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for feats, rows, g, plan in dw_calls:
        err = check_dw_per_tap(feats, rows, g, plan)
        n_src, cin = feats.shape
        k3, n_out = rows.shape
        cout = g.shape[1]
        hits = int((rows < n_src).sum())
        flop = 2.0 * hits * cin * cout
        byte = (2.0 * n_src * cin + 4.0 * k3 * n_out + 2.0 * n_out * cout + 8.0 * n_out
                + 4.0 * k3 * cin * cout)
        ms = time_ms(lambda: sparse_conv.dw_per_tap(feats, rows, g, plan), 20)
        plain_ms = eager_ms(lambda: sparse_conv.dw_per_tap_plain(feats, rows, g), 3)
        bound_ms = bound(flop, byte, PEAK_BF16_FLOPS)[0]
        n_chunks = sparse_conv.dw_chunk_slots(cin, cout, sms, k3)
        lists = []                                # the work list that the product consumed
        with capture_results(sparse_conv, "dw_work_list", lists):
            sparse_conv.dw_per_tap(feats, rows, g, plan)
        work = lists[0]
        ref = sparse_conv.dw_work_list(sparse_conv.ConvPlan(*(a.cpu() for a in plan)), k3, n_chunks)
        if not all(torch.equal(a.cpu(), b) for a, b in zip(work, ref)):
            fail(f"dw_per_tap's work list differs from its plain version ({n_out} rows)")
        hit_tiles = int(work.tap_tiles.sum())
        rows_out.append({"n_src": n_src, "n_out": n_out, "cin": cin, "cout": cout, "hits": hits,
                         "hit_tiles": hit_tiles, "chunks": int((work.chunks[:, 2] > 0).sum()),
                         "tile_fill": round(hits / max(1, sparse_conv.TILE_ROWS * hit_tiles), 4),
                         "ms": round(ms, 4), "plain_ms": round(plain_ms, 4),
                         "bmm_ms": round(bmm_ms(feats, rows, g), 4),
                         "bound_ms": round(bound_ms, 5), "max_abs_err": err})
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound_ms), ("flop", flop),
                     ("byte", byte), ("bmm_ms", rows_out[-1]["bmm_ms"]), ("hits", hits),
                     ("hit_tiles", hit_tiles)):
            tot[k] += v
        tot["err"] = max(tot["err"], err)
    tile_fill = tot["hits"] / max(1, sparse_conv.TILE_ROWS * tot["hit_tiles"])
    log({"phase": phase, "kernel": "dw_per_tap", "tolerance": DW_RTOL,
         "calls": rows_out, "ms": round(tot["ms"], 4), "bound_ms": round(tot["bound_ms"], 5),
         "bmm_ms": round(tot["bmm_ms"], 4), "tile_fill": round(tile_fill, 4)})
    results["dw_per_tap"] = dict(
        max_abs_err=tot["err"], ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
        bound_by=bound(tot["flop"], tot["byte"], PEAK_BF16_FLOPS)[1], bmm_ms=tot["bmm_ms"],
        tile_fill=tile_fill, calls=rows_out)
    return results


def bmm_ms(feats, rows, g) -> float:
    """A yardstick for dw_per_tap, never called by the port: one
    ``torch.bmm`` of [K³, Cin, n_out] x [K³, n_out, Cout] bf16 over operands
    gathered before the timing. It leaves out the row gather, multiplies
    every row of every tap (misses included) and writes bf16."""
    f_z = torch.cat([feats, feats.new_zeros(1, feats.shape[1])])
    a = f_z[rows.long()].transpose(1, 2)               # [K³, Cin, n_out]
    b = g.expand(rows.shape[0], *g.shape)              # [K³, n_out, Cout]
    ms = time_ms(lambda: torch.bmm(a, b), 5)
    del a, f_z
    return ms


def adversarial_dw_per_tap(shapes=((16, 16), (64, 48), (128, 256), (512, 512))):
    """dw_per_tap on rulebooks made on the card to hit its edges: every slot a
    miss, exactly one hit per row, a run of padding tiles, every hit in one
    row tile of the sorted order (each tap's list is one tile), ``n_out`` off
    the tile and Cin / Cout from 16 to 512."""
    from fullysparsefusion_tpu_torch.ops import sparse_conv

    g = torch.Generator(device="cuda").manual_seed(1)
    n_src, n_out = 3000, 9000 - 77
    errs = {}
    for cin, cout in shapes:
        feats = torch.randn(n_src, cin, generator=g, device="cuda").to(torch.bfloat16)
        gr = torch.randn(n_out, cout, generator=g, device="cuda").to(torch.bfloat16)
        rows = torch.randint(0, 2 * n_src, (27, n_out), generator=g, device="cuda",
                             dtype=torch.int32)
        rows = torch.where(rows < n_src, rows, torch.full_like(rows, n_src))
        one = torch.full_like(rows, n_src)
        tap = torch.randint(0, 27, (n_out,), generator=g, device="cuda")
        one[tap, torch.arange(n_out, device="cuda")] = rows[0]
        pad = rows.clone()
        pad[:, 1000:3000] = n_src
        one_tile = torch.full_like(rows, n_src)
        one_tile[:, 4000:4100] = rows[:, 4000:4100]
        for name, r in (("random", rows), ("every_slot_misses", torch.full_like(rows, n_src)),
                        ("one_hit_per_row", one), ("padding_tiles", pad),
                        ("hits_in_one_tile", one_tile)):
            errs[f"{name}_{cin}x{cout}"] = check_dw_per_tap(feats, r.contiguous(), gr)
    log({"phase": "kernel_adversarial", "kernel": "dw_per_tap", "tolerance": DW_RTOL,
         "max_abs_err": errs})


# -- data parallel, sharded eval, train to mAP ---------------------------------

# the train-form tolerance of small_train_reference_check: sharded_train_step
# at world size 1 against train_step, per loss relative to max(1, |loss|)
DDP_WORLD1_TOL = TRAIN_LOSS_TOL
DDP_WORLD1_STEPS = 3
# two ranks x batch 1 against one process at batch 2: tests/test_train.py's
# DDP-equivalence tolerances (total loss, segmentor terms, gradient norm per
# leaf and in total, counts times 2 and loss terms)
DDP_TOTAL_RTOL, DDP_TIGHT_RTOL, DDP_LEAF_RTOL, DDP_NORM_RTOL = 5e-3, 1e-3, 1.5e-1, 2e-2
DDP_COUNT_RTOL, DDP_TERM_RTOL = 5e-2, 1e-2
# eval-form BN: the forward is the one process's row for row, so only the
# order of f32 sums (atomics on the card) separates the two: losses and the
# gradient's norm within DDP_EXACT_RTOL, each gradient (relative L2) within
# DDP_EXACT_LEAF_RTOL (the VFE's first layer sums over every point: 2e-4
# apart on the card)
DDP_EXACT_RTOL = 1e-4
DDP_EXACT_LEAF_RTOL = 1e-3
DDP_SEEDS = (100, 101)
# (detection weight, train-form BN); what each case holds is in ddp_two_ranks
DDP_CASES = {"eval_bn": (1.0, False), "segmentor_pretrain": (0.0, True),
             "train_bn": (1.0, True)}
EVAL_SCENES, EVAL_SEED0 = 6, 300
# tests/test_train_to_map.py's recipe and thresholds
T2M_STEPS, T2M_LR, T2M_SEED, T2M_CLASSES, T2M_BATCH = 60, 1e-3, 7, 3, 2


def ddp_world1(model, opt, batch, wrappers, step: int, workdir: str,
               phase="ddp_world1", exact: bool = False) -> dict:
    """Full width: ``train_step`` twice from one state (the card's step
    reproduced or not), then ``sharded_train_step`` under an NCCL group of
    world size 1 from the same state, its losses held to ``train_step``'s
    (with ``exact``, its losses and parameters bitwise equal);
    then ``DDP_WORLD1_STEPS`` timed sharded steps (the gradient all-reduce
    by CUDA events) with the kernels' launches counted, and one bare NCCL
    all-reduce of the gradients' bytes. Returns the launches per step."""
    import torch.distributed as dist
    from fullysparsefusion_tpu_torch.parallel.launch import init_group
    from fullysparsefusion_tpu_torch.parallel.train import sharded_train_step, train_step
    from fullysparsefusion_tpu_torch.train.hooks import RuntimeSchedule

    t0 = time.perf_counter()
    sched = RuntimeSchedule()
    saved = copy.deepcopy(model.state_dict()), copy.deepcopy(opt.state_dict())

    def run(step_fn, *args):
        model.load_state_dict(saved[0])
        opt.load_state_dict(copy.deepcopy(saved[1]))     # it would alias the saved tensors
        _, losses, _ = step_fn(model, opt, sched, batch, step, *args)
        return ({k: float(v) for k, v in losses.items()},
                [p.detach().clone() for p in model.parameters()])

    def diff(a, b):
        return (max(abs(a[0][k] - b[0][k]) / max(1.0, abs(a[0][k])) for k in a[0]),
                max(float((x - y).abs().max()) for x, y in zip(a[1], b[1])))

    first, again = run(train_step), run(train_step)
    group = init_group(0, 1, os.path.join(workdir, f"nccl_{phase}"), backend="nccl",
                       device="cuda")
    sharded = run(sharded_train_step, group)
    loss_err, param_err = diff(first, sharded)
    if loss_err > DDP_WORLD1_TOL:
        fail(f"{phase}: sharded_train_step's losses differ from train_step's by "
             f"{loss_err:.3g} (tolerance {DDP_WORLD1_TOL})")
    if exact and (loss_err or param_err):
        fail(f"{phase}: sharded_train_step is not bitwise train_step's (losses {loss_err:.3g}, "
             f"parameters {param_err:.3g} apart)")
    spread = diff(first, again)
    del again, sharded

    zero(wrappers)
    split = {"forward_ms": [], "backward_ms": [], "allreduce_ms": [], "optimizer_ms": []}
    for s in range(step + 1, step + 1 + DDP_WORLD1_STEPS):
        events = {ph: torch.cuda.Event(enable_timing=True)
                  for ph in ("start", "forward", "backward", "allreduce", "optimizer")}
        events["start"].record()
        loss, _, _ = sharded_train_step(model, opt, sched, batch, s, group,
                                        lambda phase: events[phase].record())
        torch.cuda.synchronize()
        if not math.isfinite(float(loss)):
            fail(f"{phase}: non-finite loss at step {s}")
        names = list(events)
        for a, b in zip(names, names[1:]):
            split[f"{b}_ms"].append(events[a].elapsed_time(events[b]))
    launches = counts(wrappers)
    for name in ("gather_conv", "dw_per_tap", "ccl_roots"):
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the sharded train path")
    n = sum(p.numel() for p in model.parameters())
    flat = torch.zeros(n, device="cuda")
    bare_ms = eager_ms(lambda: dist.all_reduce(flat, group=group), 5)
    dist.destroy_process_group()
    per_step = {k: v / DDP_WORLD1_STEPS for k, v in launches.items()}
    log({"phase": phase, "backend": "nccl", "world_size": 1,
         "loss_rel_err_vs_train_step": float(f"{loss_err:.3g}"),
         "tolerance": DDP_WORLD1_TOL,
         "param_max_abs_diff_vs_train_step": param_err,
         "train_step_rerun_spread": {"loss_rel": spread[0], "param_max_abs": spread[1]},
         "steps": DDP_WORLD1_STEPS,
         "mean_ms": {k: round(sum(v) / len(v), 3) for k, v in split.items()},
         "allreduce_ms_per_step": [round(v, 3) for v in split["allreduce_ms"]],
         "grad_bytes": 4 * n, "bare_allreduce_ms": round(bare_ms, 4),
         "launches_per_step": per_step,
         "seconds": round(time.perf_counter() - t0, 3)})
    return per_step


def ddp_config(scale: int = 1):
    """The tiny FSF config with every UNet conv on the gather path and
    capacities ample for one scene, times ``scale`` (per global batch):
    tests/test_torch_ddp_port.py's ``rank_config``."""
    from fullysparsefusion_tpu_torch.config import tiny_fsf_config

    cfg = gather_only(tiny_fsf_config())
    return dataclasses.replace(cfg, fsd=dataclasses.replace(cfg.fsd,
                                                            caps=ample_caps(cfg.caps, scale)))


def ample_caps(c, scale: int = 1):
    """Tiny-config capacities ample for one scene, times ``scale``."""
    return dataclasses.replace(
        c, points=512 * scale, voxels=c.voxels * scale, prevox=c.prevox * scale,
        fg_per_group=1024 * scale, cluster_voxels_per_group=1024 * scale,
        clusters=512 * scale, frustum_points=1024 * scale, frustum_objects=64 * scale,
        roi_points=4096 * scale)


def ddp_scenes(cfg):
    """The (scene, camera) arrays of each rank: one sample each, the JAX
    package's sharded-step test recipe (2 boxes, 120 background points)."""
    from fullysparsefusion_tpu_torch import synthetic as S

    out = []
    for seed in DDP_SEEDS:
        sc = S.make_scene_arrays(seed=seed, batch_size=1, boxes_per_sample=2, bg_points=120,
                                 n_cap=cfg.caps.points, max_gt=cfg.caps.max_gt)
        out.append((sc, S.make_camera_arrays(sc["gt_boxes"], sc["gt_labels"], sc["gt_valid"],
                                             batch_size=1, num_classes=cfg.num_classes)))
    return out


def ddp_batch(sc, cam):
    from fullysparsefusion_tpu_torch import synthetic as S
    from fullysparsefusion_tpu_torch.parallel.train import Batch

    pb, cd = S.fsf_inputs(sc, cam, device="cuda")
    gt = S.to_ground_truth(sc, device="cuda")
    return Batch(pb, cd, gt, gt)


def eval_scene(i: int):
    from fullysparsefusion_tpu_torch import synthetic as S
    from fullysparsefusion_tpu_torch.config import tiny_fsf_config

    return S.train_scene(EVAL_SEED0 + i, tiny_fsf_config(), batch_size=1, device="cuda")


def ddp_rank(rank, world, group):
    """One rank of ``ddp_two_ranks`` (gloo on the card): each case of
    ``DDP_CASES`` from the seed-0 weights on this rank's scene (train-form
    BN through ``sharded_train_step``; eval-form BN as the same forward
    under ``bn_group``, backward and gradient mean), the gradients as the
    optimizer gets them, the BN buffers and the kernels' launches; then
    ``get_bboxes`` on this rank's shard of ``EVAL_SCENES`` scenes, the
    records gathered and evaluated on every rank."""
    from fullysparsefusion_tpu_torch.config import tiny_fsf_config
    from fullysparsefusion_tpu_torch.eval.detection import evaluate_detections
    from fullysparsefusion_tpu_torch.eval.records import scene_records
    from fullysparsefusion_tpu_torch.models.layers import bn_group
    from fullysparsefusion_tpu_torch.parallel import train as T
    from fullysparsefusion_tpu_torch.parallel.eval import allgather_results, shard_indices
    from fullysparsefusion_tpu_torch.train.hooks import RuntimeSchedule
    from fullysparsefusion_tpu_torch.weights import build_fsf

    cfg = ddp_config()
    batch = ddp_batch(*ddp_scenes(cfg)[rank])
    wrappers = kernel_wrappers()
    out = {}
    for name, (det_weight, train_bn) in DDP_CASES.items():
        model = build_fsf(cfg, seed=0, device="cuda")
        grads = {}

        def mark(phase):
            if phase == "allreduce":
                grads.update({n: p.grad.detach().clone() for n, p in model.named_parameters()})

        zero(wrappers)
        if train_bn:
            opt = T.make_optimizer(model, total_steps=10)
            sched = RuntimeSchedule(enable_detection_step=0 if det_weight else 1)
            _, losses, _ = T.sharded_train_step(model, opt, sched, batch, 0, group, mark)
        else:
            with bn_group(group):
                losses = model(batch.pb, batch.cam, 1, batch.gt, batch.no_aug_gt, train=False,
                               detection_weight=det_weight)["losses"]
            T.total_loss(losses).backward()
            T.allreduce_grads_mean_(model.parameters(), group)
            mark("allreduce")
            losses = T.allreduce_mean(losses, group)
        torch.cuda.synchronize()
        out[name] = dict(losses={k: float(v) for k, v in losses.items()}, grads=grads,
                         buffers=dict(model.named_buffers()), launches=counts(wrappers))
    model = build_fsf(tiny_fsf_config(), seed=0, device="cuda")
    zero(wrappers)
    mine = [(int(i), rec) for i in shard_indices(EVAL_SCENES, rank, world)
            for rec in scene_records(model, [eval_scene(int(i))], 1)]
    recs = sorted(allgather_results(mine, group), key=lambda t: t[0])
    metrics = evaluate_detections([r for _, r in recs], model.cfg.num_classes,
                                  model.cfg.fsd.class_names)
    return dict(cases=out, eval=dict(mAP=metrics["mAP"], indices=[i for i, _ in recs],
                                     own=len(mine), launches=counts(wrappers)))


def single_process_step(cfg, scenes, det_weight, train_bn):
    """One process at batch 2 (both ranks' scenes) with doubled capacities:
    losses and gradients on the card."""
    from fullysparsefusion_tpu_torch.parallel.train import total_loss
    from fullysparsefusion_tpu_torch.weights import build_fsf

    sc = {k: np.concatenate([s[k] for s, _ in scenes]) for k in scenes[0][0]}
    sc["batch_idx"] = np.concatenate([s["batch_idx"] + i for i, (s, _) in enumerate(scenes)])
    cam = {k: np.concatenate([c[k] for _, c in scenes]) for k in scenes[0][1]}
    batch = ddp_batch(sc, cam)
    model = build_fsf(ddp_config(scale=2), seed=0, device="cuda")
    losses = model(batch.pb, batch.cam, 2, batch.gt, batch.no_aug_gt, train=train_bn,
                   detection_weight=det_weight)["losses"]
    total_loss(losses).backward()
    return ({k: float(v.detach()) for k, v in losses.items()},
            {n: p.grad.detach().cpu().numpy() for n, p in model.named_parameters()})


def hold_two_ranks(what, r0, r1, ref_losses, ref_grads, exact, kernels, errors,
                   leaf_rtol=DDP_EXACT_LEAF_RTOL) -> dict:
    """Two ranks' results (losses averaged over the ranks, gradients as the
    optimizer gets them, BN buffers, launches) against one process's on
    both scenes: the ranks bitwise equal to each other and each of
    ``kernels`` launched on each; ``exact`` (eval-form BN) holds every
    loss, count (times 2) and gradient to ``DDP_EXACT_RTOL`` /
    ``leaf_rtol``, else tests/test_train.py's DDP-equivalence
    tolerances. Appends what misses to ``errors``; returns the report."""
    for part in ("grads", "buffers"):
        for k, v in r0[part].items():
            if not np.array_equal(v, r1[part][k]):
                errors.append(f"{what}: the ranks' {part[:-1]} {k} differ")
    for r in (r0, r1):
        for kern in kernels:
            if r["launches"][kern] <= 0:
                errors.append(f"{what}: a rank did not launch {kern}")
    worst = {}
    for k, v in ref_losses.items():
        count = not ("loss" in k or "recall" in k)
        got = r0["losses"][k] * (2 if count else 1)
        err = abs(got - v) / max(abs(v), 1e-5)
        worst[k] = err
        tol = (DDP_EXACT_RTOL if exact else DDP_TIGHT_RTOL
               if k in ("loss_sem_seg", "loss_vote")
               else DDP_COUNT_RTOL if count else DDP_TERM_RTOL)
        if abs(got - v) > 1e-5 + tol * abs(v):
            errors.append(f"{what}: {k} {got} on two ranks, {v} in one")
    total = sum(v for k, v in r0["losses"].items() if "loss" in k)
    total_ref = sum(v for k, v in ref_losses.items() if "loss" in k)
    if abs(total - total_ref) > (DDP_EXACT_RTOL if exact else DDP_TOTAL_RTOL) * abs(total_ref):
        errors.append(f"{what}: total loss {total} on two ranks, {total_ref} in one")
    leaf_worst, num, den = [], 0.0, 0.0
    for k, g in ref_grads.items():
        got = r0["grads"][k]
        n1, n2 = float(np.linalg.norm(g)), float(np.linalg.norm(got))
        d = float(np.linalg.norm(got - g))
        rel = d / max(n1, 1e-12) if exact else abs(n2 - n1) / max(n1, 1e-12)
        leaf_worst.append((rel, k))
        if exact and d > leaf_rtol * n1 + 1e-6:
            errors.append(f"{what}: gradient {k} differs by {rel:.3g}")
        if not exact and abs(n2 - n1) > DDP_LEAF_RTOL * n1 + 1e-6:
            errors.append(f"{what}: gradient norm {k} {n2} against {n1}")
        num, den = num + n2 * n2, den + n1 * n1
    norm_err = abs(num ** 0.5 / den ** 0.5 - 1)
    if norm_err > (DDP_EXACT_RTOL if exact else DDP_NORM_RTOL):
        errors.append(f"{what}: gradient norm differs by {norm_err:.3g}")
    leaf_worst.sort(reverse=True)
    return {"total_loss": [total, total_ref], "grad_norm_rel_err": float(f"{norm_err:.3g}"),
            "worst_terms": sorted(((float(f"{e:.3g}"), k) for k, e in worst.items()),
                                  reverse=True)[:4],
            "worst_leaves": [[k, float(f"{e:.3g}")] for e, k in leaf_worst[:3]],
            "num_pos_x2_vs_one": {k: [2 * r0["losses"][k], v] for k, v in ref_losses.items()
                                  if "num_pos" in k},
            "launches_rank0": r0["launches"], "launches_rank1": r1["launches"]}


def ddp_two_ranks(workdir: str) -> None:
    """Tiny config, two processes on the one card joined by gloo (NCCL takes
    one rank per card) on CUDA tensors: each case of ``DDP_CASES`` on two
    ranks x batch 1 against one process at batch 2 with doubled
    capacities. ``eval_bn`` (the ranks couple only through the loss
    normalizers and the gradient mean) holds every loss, count (times 2)
    and gradient to ``DDP_EXACT_RTOL``; the train-form cases (SyncBN;
    detection weight 0 and 1) hold tests/test_train.py's DDP-equivalence
    tolerances on the total loss, every term, the counts times 2, each
    gradient's norm and the whole gradient's. (On the CPU the same
    train-form step flips a few LiDAR-branch decisions between the two
    layouts, in both packages: tests/test_torch_ddp_port.py,
    tools/ddp_equivalence.py.) Both ranks' gradients and BN buffers must be
    bitwise equal and each rank must have launched K1, K2 and dw_per_tap.
    Then sharded eval: rank 0's mAP over the gathered records must equal
    one process's over all ``EVAL_SCENES`` scenes."""
    from fullysparsefusion_tpu_torch.config import tiny_fsf_config
    from fullysparsefusion_tpu_torch.eval.records import eval_map
    from fullysparsefusion_tpu_torch.parallel.launch import spawn_ranks
    from fullysparsefusion_tpu_torch.weights import build_fsf

    t0 = time.perf_counter()
    ranks = spawn_ranks(ddp_rank, 2, os.path.join(workdir, "gloo_two_ranks"), backend="gloo",
                        device="cuda", timeout=300)
    scenes = ddp_scenes(ddp_config())
    report, errors = {}, []
    for name, (det_weight, train_bn) in DDP_CASES.items():
        r0, r1 = (r["cases"][name] for r in ranks)
        ref_losses, ref_grads = single_process_step(ddp_config(), scenes, det_weight, train_bn)
        report[name] = dict(detection_weight=det_weight, train_bn=train_bn, **hold_two_ranks(
            f"ddp_two_ranks {name}", r0, r1, ref_losses, ref_grads, name == "eval_bn",
            ("gather_conv", "dw_per_tap", "ccl_roots"), errors))
    model = build_fsf(tiny_fsf_config(), seed=0, device="cuda")
    single = eval_map(model, [eval_scene(i) for i in range(EVAL_SCENES)], 1,
                      model.cfg.fsd.class_names)["mAP"]
    ev0, ev1 = ranks[0]["eval"], ranks[1]["eval"]
    if ev0["indices"] != list(range(EVAL_SCENES)) or ev0["mAP"] != ev1["mAP"]:
        errors.append(f"sharded eval: gathered indices {ev0['indices']}, mAP {ev0['mAP']} / "
                      f"{ev1['mAP']}")
    if ev0["mAP"] != single:
        errors.append(f"sharded eval: mAP {ev0['mAP']} on two ranks, {single} in one process")
    for ev in (ev0, ev1):
        if ev["launches"]["nms_keep"] <= 0:
            errors.append("sharded eval: a rank did not launch nms_keep")
    log({"phase": "ddp_two_ranks", "backend": "gloo", "device": "cuda", "world_size": 2,
         "cases": report,
         "sharded_eval": {"scenes": EVAL_SCENES, "mAP": ev0["mAP"], "single_mAP": single,
                          "per_rank": [ev0["own"], ev1["own"]],
                          "launches_rank0": ev0["launches"]},
         "seconds": round(time.perf_counter() - t0, 3)})
    if errors:
        fail("; ".join(errors))


def train_to_map(wrappers) -> None:
    """tests/test_train_to_map.py on the card: the tiny config overfits one
    batch-2 scene (seed 7, labels from 3 classes) in 60 AdamW steps (lr 1e-3,
    no multipliers); mAP through get_bboxes (K3) and the port's
    evaluate_detections must rise past the JAX test's thresholds."""
    from fullysparsefusion_tpu_torch import synthetic as S
    from fullysparsefusion_tpu_torch.config import tiny_fsf_config
    from fullysparsefusion_tpu_torch.eval.records import eval_map
    from fullysparsefusion_tpu_torch.parallel.train import Batch, make_optimizer, train_step
    from fullysparsefusion_tpu_torch.train.hooks import RuntimeSchedule
    from fullysparsefusion_tpu_torch.weights import build_fsf

    t0 = time.perf_counter()
    cfg = tiny_fsf_config()
    pb, cam, gt = S.train_scene(T2M_SEED, cfg, T2M_BATCH, T2M_CLASSES, device="cuda")
    model = build_fsf(cfg, seed=0, device="cuda")
    opt = make_optimizer(model, base_lr=T2M_LR, total_steps=T2M_STEPS)
    names, sched, batch = cfg.fsd.class_names, RuntimeSchedule(), Batch(pb, cam, gt, gt)
    zero(wrappers)
    map0 = eval_map(model, [(pb, cam, gt)], T2M_BATCH, names)["mAP"]
    losses, step_ms = [], []
    for step in range(T2M_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        loss, _, _ = train_step(model, opt, sched, batch, step)
        end.record()
        losses.append(float(loss))
        step_ms.append(start.elapsed_time(end))
    map1 = eval_map(model, [(pb, cam, gt)], T2M_BATCH, names)["mAP"]
    launches = counts(wrappers)
    log({"phase": "train_to_map", "steps": T2M_STEPS, "map0": map0, "map1": map1,
         "loss0": losses[0], "loss1": losses[-1], "loss_every_10": losses[::10],
         "mean_step_ms": round(sum(step_ms) / len(step_ms), 3), "launches": launches,
         "seconds": round(time.perf_counter() - t0, 3)})
    if not (math.isfinite(losses[-1]) and losses[-1] < 0.7 * losses[0]):
        fail(f"train_to_map: loss {losses[0]} -> {losses[-1]}, not below 0.7 of the first")
    if not (map1 > map0 + 0.08 and map1 > 0.12):
        fail(f"train_to_map: mAP {map0} -> {map1} (needs > map0 + 0.08 and > 0.12)")
    for name in ("gather_conv", "dw_per_tap", "ccl_roots", "nms_keep"):
        if launches[name] <= 0:
            fail(f"train_to_map: kernel {name} was not launched")


# -- LiDAR-only single-stage FSD, six class-group tasks -------------------------

# the segmentor core at 0.2, as TRAIN_LR_RULES does for FSF's
FSD_LR_RULES = {"segmentor.SegmentorCore_0": 0.2}
FSD_TASKS = 6
# the loss terms held to fall over the timed train steps: at random weights
# the six heads find 0 to 4 positives a step among ~800 clusters, so their
# per-positive terms jump by several units from step to step (as FSF's fsd_
# terms do); the segmentor's terms are over every point
FSD_HELD_LOSSES = ("loss_sem_seg", "loss_vote")
FSD_MUST_TRAIN = ("segmentor",) + tuple(f"query_branch.bbox_head.SeparateHead_{t}"
                                        for t in range(FSD_TASKS))


def fsd_config():
    """Full-width multi-task FSD: the ``FSDConfig`` defaults (the nuScenes
    widths) with one task per class group, at the bench capacities."""
    from fullysparsefusion_tpu_torch.config import NUSC_GROUPS, FSDConfig, VoteSegmentorConfig

    bench = bench_config().fsd
    seg = VoteSegmentorConfig(unet_stage_capacities=bench.segmentor.unet_stage_capacities)
    return FSDConfig(tasks=NUSC_GROUPS, caps=bench.caps, segmentor=seg)


def fsd_scene(seed: int, cfg, device="cuda"):
    """(PointBatch, GroundTruth) of the bench scene of ``seed`` (the scene
    ``bench_scene`` gives FSF, without cameras)."""
    from fullysparsefusion_tpu_torch import synthetic as S

    sc = S.make_lidar_scene_arrays(seed=seed, n_cap=cfg.caps.points, max_gt=cfg.caps.max_gt,
                                   n_boxes=32, extent=48.0)
    return S.to_point_batch(sc, device), S.to_ground_truth(sc, device)


def check_close(what: str, name: str, a, b, tol: float) -> float:
    """``b`` (either device) within ``tol`` · (1 + |a|) of ``a`` (the CPU's);
    returns the largest absolute difference."""
    a, b = a.float().cpu(), b.detach().float().cpu()
    err = (a - b).abs()
    if (err > tol * (1 + a.abs())).any():
        fail(f"{what}: {name} differs by up to {err.max().item():.3g}")
    return err.max().item() if err.numel() else 0.0


def hold_losses_and_detections(what, l_cpu, l_gpu, d_cpu, d_gpu, report) -> float:
    """A tiny detector's losses and detections, GPU against CPU: every loss
    finite and within ``TRAIN_LOSS_TOL`` relative (counts and recalls
    equal), the detections' validity and labels equal, boxes and scores
    within ``BF16_CHAIN_TOL`` (added to ``report``). Returns the worst loss
    error."""
    worst = 0.0
    for k, a in l_cpu.items():
        a, b = float(a), float(l_gpu[k])
        err = abs(a - b) / max(1.0, abs(a))
        if not (math.isfinite(a) and math.isfinite(b)) or err > TRAIN_LOSS_TOL or \
                (("num_pos" in k or "recall" in k) and a != b):
            fail(f"{what}: {k} {a} on the CPU, {b} on the GPU")
        worst = max(worst, err)
    if not torch.equal(d_cpu.valid, d_gpu.valid.cpu()) or \
            not torch.equal(d_cpu.labels, d_gpu.labels.cpu()):
        fail(f"{what}: detection validity or labels differ")
    report["det_boxes"] = check_close(what, "det boxes", d_cpu.boxes, d_gpu.boxes, BF16_CHAIN_TOL)
    report["det_scores"] = check_close(what, "det scores", d_cpu.scores, d_gpu.scores,
                                       BF16_CHAIN_TOL)
    return worst


def small_fsd_reference_check(device="cuda"):
    """Tiny six-task FSD with the IoU branch on, forward + losses +
    ``get_bboxes``: GPU (kernels) against CPU (plain versions), same
    weights and scene, ``small_reference_check``'s tolerances; the losses
    as ``small_train_reference_check`` holds them."""
    from fullysparsefusion_tpu_torch import synthetic as S
    from fullysparsefusion_tpu_torch.config import NUSC_GROUPS, tiny_fsd_config
    from fullysparsefusion_tpu_torch.weights import build_fsd

    t0 = time.perf_counter()
    cfg = tiny_fsd_config(tasks=NUSC_GROUPS)
    cfg = dataclasses.replace(cfg, head=dataclasses.replace(cfg.head, with_iou=True))
    sc = S.make_scene_arrays(seed=0, n_cap=cfg.caps.points, max_gt=cfg.caps.max_gt)
    ref_model = build_fsd(cfg, seed=0, device="cpu")
    outs = {}
    for dev, model in (("cpu", ref_model), (device, copy.deepcopy(ref_model).to(device))):
        pb, gt = S.to_point_batch(sc, dev), S.to_ground_truth(sc, dev)
        with torch.inference_mode():
            res = model(pb, 2, gt)
            det = model.get_bboxes(res, 2)
            iou = model.query_branch.bbox_head(res["obj_feat"], res["cluster_valid"])
        outs[dev] = (res, det, iou["iou_logits_tasks"])
    (r_cpu, d_cpu, i_cpu), (r_gpu, d_gpu, i_gpu) = outs["cpu"], outs[device]
    what = "small FSD reference"
    if not torch.equal(r_cpu["cluster_valid"], r_gpu["cluster_valid"].cpu()):
        fail(f"{what}: the clusters differ")
    report = {"seg_logits": check_close(what, "seg_logits", r_cpu["seg_out"]["seg_logits"],
                                        r_gpu["seg_out"]["seg_logits"], BF16_CHAIN_TOL)}
    pairs = {"cls_logits": (r_cpu["cls_logits_tasks"], r_gpu["cls_logits_tasks"]),
             "reg_preds": (r_cpu["reg_preds_tasks"], r_gpu["reg_preds_tasks"]),
             "iou_logits": (i_cpu, i_gpu)}
    for key, (a, b) in pairs.items():
        report[key] = max(check_close(what, f"task {t} {key}", a[t], b[t], BF16_CHAIN_TOL)
                          for t in range(FSD_TASKS))
    l_cpu, l_gpu = r_cpu["losses"], r_gpu["losses"]
    if set(l_cpu) != set(l_gpu) or len([k for k in l_cpu if k.startswith("task5_")]) < 5:
        fail(f"{what}: loss keys {sorted(l_gpu)}")
    worst = hold_losses_and_detections(what, l_cpu, l_gpu, d_cpu, d_gpu, report)
    n_det, n_clusters = int(d_cpu.valid.sum()), int(r_cpu["num_clusters"])
    if min(n_det, n_clusters) <= 0:
        fail(f"{what}: vacuous scene, {n_det} detections, {n_clusters} clusters")
    log({"phase": "small_fsd_reference", "tasks": FSD_TASKS, "with_iou": True,
         "detections": n_det, "clusters": n_clusters, "losses": len(l_cpu),
         "loss_rel_err": float(f"{worst:.3g}"), "tolerance": BF16_CHAIN_TOL,
         "max_abs_err": {k: float(f"{v:.3g}") for k, v in report.items()},
         "seconds": round(time.perf_counter() - t0, 3)})


def fsd_serve(model, requests, wrappers) -> dict:
    """Forward + get_bboxes per request under ``torch.inference_mode()``,
    each with the launch counters zeroed just before and read just after:
    K1, K2 and K3 must launch, K3 once per task. Returns the detections and
    the mean launches per request."""
    t0 = time.perf_counter()
    tasks, max_num = len(model.cfg.task_tuple()), model.cfg.head.max_num
    dets, launches = [], []
    for seed, pb in requests:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero(wrappers)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t_req = time.perf_counter()
        start.record()
        with torch.inference_mode():
            res = model(pb, 1)
            det = model.get_bboxes(res, 1)
        end.record()
        det = type(det)(*[t.cpu() for t in det])  # the answer reaches the host
        host_ms = (time.perf_counter() - t_req) * 1e3
        torch.cuda.synchronize()
        launches.append(counts(wrappers))
        for name, t in zip(det._fields, det):
            if t.is_floating_point() and not torch.isfinite(t).all():
                fail(f"FSD request seed {seed}: non-finite {name}")
        if det.valid.shape != (1, tasks * max_num):
            fail(f"FSD request seed {seed}: detections shape {tuple(det.valid.shape)}")
        if launches[-1]["nms_keep"] != tasks or min(launches[-1]["gather_conv"],
                                                   launches[-1]["ccl_roots"]) <= 0:
            fail(f"FSD request seed {seed}: launches {launches[-1]}")
        log({"phase": "fsd_request", "seed": seed, "detections": int(det.valid.sum()),
             "detections_per_task": det.valid.reshape(tasks, max_num).sum(1).tolist(),
             "clusters": int(res["num_clusters"]), "fg_points": int(res["num_fg_points"]),
             "gpu_ms": round(start.elapsed_time(end), 3), "host_ms": round(host_ms, 3),
             "peak_mem_mib": round(torch.cuda.max_memory_allocated() / 2**20, 1),
             "launches": launches[-1]})
        dets.append(det)
    first, again = dets[0], dets[-1]
    for name, a, b in zip(first._fields, first, again):
        if not torch.equal(a, b):
            fail(f"re-run of FSD request seed 0 changed {name}")
    per_request = {k: sum(n[k] for n in launches) / len(launches) for k in launches[0]}
    log({"phase": "fsd_serve", "requests": len(requests), "launches_per_request": per_request,
         "seconds": round(time.perf_counter() - t0, 3)})
    return per_request


def fsd_check_kernels(model, pb) -> dict:
    """Every K1, K2 and K3 call of one FSD request held to its plain version
    (K1 within ``K1_RTOL``, K2 and K3 bitwise) and timed; K3's six calls
    listed per task."""
    t0 = time.perf_counter()
    calls = capture_request(lambda: model.get_bboxes(model(pb, 1), 1))
    results = {"gather_conv": replay_gather_conv(calls["gather_conv"], "fsd_kernel_calls")}
    (call,) = calls["ccl_roots"]
    results["ccl_roots"] = replay_ccl_roots(call, "fsd_kernel_calls")
    if len(calls["nms_keep"]) != FSD_TASKS:
        fail(f"the FSD request made {len(calls['nms_keep'])} nms_keep calls, not {FSD_TASKS}")
    per_task = [replay_nms_keep(call, "fsd_kernel_calls", task=t)
                for t, call in enumerate(calls["nms_keep"])]
    flop, byte = sum(r["flop"] for r in per_task), sum(r["byte"] for r in per_task)
    results["nms_keep"] = dict(
        max_abs_err=0.0, **{k: sum(r[k] for r in per_task) for k in ("ms", "plain_ms", "bound_ms")},
        bound_by=bound(flop, byte, PEAK_F32_FLOPS)[1],
        per_task=[{"task": t, "C": int(c[1].shape[0]), "N": int(c[1].shape[1]),
                   **{k: r[k] for k in ("ms", "plain_ms", "bound_ms")}}
                  for t, (c, r) in enumerate(zip(calls["nms_keep"], per_task))])
    log({"phase": "fsd_kernels", "calls": {k: len(v) for k, v in calls.items()},
         "seconds": round(time.perf_counter() - t0, 3)})
    return results


# one group's foreground at the bench capacity, the SSG alternative's picks
SSG_POINTS, SSG_NUM_FPS, SSG_RADIUS = 4096, 256, 1.0


def fsd_clustering_alternatives(cfg) -> None:
    """One group's clustering of ``SSG_POINTS`` voted centers (blobs of
    objects, 85 % valid) on the card, by the two methods of
    ``hybrid_cluster_one_group``: "ssg" (furthest point sampling, a loop of
    ``SSG_NUM_FPS`` arg-max steps in plain PyTorch, then ball grouping) and
    "ccl" (K2, one problem); each timed eagerly by CUDA events, and the
    card's labels set beside the CPU's."""
    from fullysparsefusion_tpu_torch.models.fsd import hybrid_cluster_one_group

    t0 = time.perf_counter()
    g = torch.Generator().manual_seed(0)
    blobs = torch.rand(64, 3, generator=g) * torch.tensor([80.0, 80.0, 2.0]) - \
        torch.tensor([40.0, 40.0, 1.0])
    centers = blobs[torch.randint(0, 64, (SSG_POINTS,), generator=g)] + \
        0.4 * torch.randn(SSG_POINTS, 3, generator=g)
    valid = torch.rand(SSG_POINTS, generator=g) < 0.85
    batch = torch.zeros(SSG_POINTS, dtype=torch.int32)
    report = {}
    for method in ("ssg", "ccl"):
        def run(dev):
            return hybrid_cluster_one_group(
                centers.to(dev), batch.to(dev), valid.to(dev), 0, cfg, method=method,
                num_fps=SSG_NUM_FPS, radius=SSG_RADIUS, batch_size=1)

        lab, _ = run("cuda")
        ref, _ = run("cpu")
        report[method] = {"ms": round(eager_ms(lambda: run("cuda"), 5), 3),
                          "clusters": int(lab.max()) + 1,
                          "labels_equal_to_cpu": bool(torch.equal(lab.cpu(), ref))}
    log({"phase": "fsd_clustering_alternatives", "points": SSG_POINTS, "num_fps": SSG_NUM_FPS,
         "radius": SSG_RADIUS, **report, "seconds": round(time.perf_counter() - t0, 3)})


def fsd_config_two_ranks(scale: int = 1):
    """The tiny six-task FSD config, every UNet conv on the gather path,
    capacities ample for one scene times ``scale``."""
    from fullysparsefusion_tpu_torch.config import NUSC_GROUPS, tiny_fsd_config

    cfg = tiny_fsd_config(tasks=NUSC_GROUPS)
    seg = dataclasses.replace(cfg.segmentor, unet_dense_min_occupancy=2.0)
    return dataclasses.replace(cfg, segmentor=seg, caps=ample_caps(cfg.caps, scale))


def fsd_batch(sc):
    from fullysparsefusion_tpu_torch import synthetic as S
    from fullysparsefusion_tpu_torch.parallel.train import Batch

    return Batch(S.to_point_batch(sc, "cuda"), None, S.to_ground_truth(sc, "cuda"), None)


def fsd_eval_bn_step(model, batch, batch_size: int, group=None):
    """Eval-form BN forward with losses (under ``bn_group(group)``),
    backward, and with a group the gradients' and losses' means: losses and
    gradients as the optimizer would get them."""
    from fullysparsefusion_tpu_torch.models.layers import bn_group
    from fullysparsefusion_tpu_torch.parallel import train as T

    with bn_group(group):
        losses = model(batch.pb, batch_size, batch.gt, train=False)["losses"]
    T.total_loss(losses).backward()
    if group is not None:
        T.allreduce_grads_mean_(model.parameters(), group)
        losses = T.allreduce_mean(losses, group)
    torch.cuda.synchronize()
    return ({k: float(v.detach()) for k, v in losses.items()},
            {n: p.grad.detach().cpu().numpy() for n, p in model.named_parameters()})


def fsd_ddp_rank(rank, world, group):
    """One rank of ``fsd_two_ranks`` (gloo on the card): the tiny six-task
    FSD from the seed-0 weights on this rank's scene, eval-form BN."""
    from fullysparsefusion_tpu_torch.weights import build_fsd

    cfg = fsd_config_two_ranks()
    wrappers = kernel_wrappers()
    model = build_fsd(cfg, seed=0, device="cuda")
    zero(wrappers)
    losses, grads = fsd_eval_bn_step(model, fsd_batch(ddp_scenes(cfg)[rank][0]), 1, group)
    return dict(losses=losses, grads=grads, buffers=dict(model.named_buffers()),
                launches=counts(wrappers))


def fsd_two_ranks(workdir: str) -> None:
    """Tiny six-task FSD on two gloo processes on the one card (eval-form
    BN) against one process at batch 2 with doubled capacities:
    ``hold_two_ranks``' exact bounds, the ranks bitwise equal, K1, K2 and
    dw_per_tap launched on each, every task's ``num_pos`` (a mean over the
    ranks, times 2) equal to one process's."""
    from fullysparsefusion_tpu_torch.parallel.launch import spawn_ranks
    from fullysparsefusion_tpu_torch.weights import build_fsd

    t0 = time.perf_counter()
    r0, r1 = spawn_ranks(fsd_ddp_rank, 2, os.path.join(workdir, "gloo_fsd_two_ranks"),
                         backend="gloo", device="cuda", timeout=300)
    scenes = ddp_scenes(fsd_config_two_ranks())
    sc = {k: np.concatenate([s[k] for s, _ in scenes]) for k in scenes[0][0]}
    sc["batch_idx"] = np.concatenate([s["batch_idx"] + i for i, (s, _) in enumerate(scenes)])
    ref_losses, ref_grads = fsd_eval_bn_step(
        build_fsd(fsd_config_two_ranks(scale=2), seed=0, device="cuda"), fsd_batch(sc), 2)
    errors = []
    report = hold_two_ranks("fsd_two_ranks", r0, r1, ref_losses, ref_grads, True,
                            ("gather_conv", "dw_per_tap", "ccl_roots"), errors)
    for k, v in ref_losses.items():
        if "num_pos" in k and 2 * r0["losses"][k] != v:
            errors.append(f"fsd_two_ranks: {k} {2 * r0['losses'][k]} on two ranks, {v} in one")
    if sum(v > 0 for k, v in ref_losses.items() if "num_pos" in k) < 2:
        errors.append(f"fsd_two_ranks: vacuous scenes, num_pos {ref_losses}")
    log({"phase": "fsd_two_ranks", "backend": "gloo", "device": "cuda", "world_size": 2,
         "train_bn": False, **report, "seconds": round(time.perf_counter() - t0, 3)})
    if errors:
        fail("; ".join(errors))


def fsd_phase(wrappers) -> dict:
    """The full-width six-task FSD: serve four requests, replay the kernels
    of one, train (two warm-ups, five timed steps, the backward kernels held
    to their plain versions), NCCL at world size 1 from the trained state;
    then the tiny six-task FSD on two gloo ranks. Returns the kernel numbers
    and launches for the kernels line."""
    from fullysparsefusion_tpu_torch.parallel.train import Batch, make_optimizer
    from fullysparsefusion_tpu_torch.weights import build_fsd

    t0 = time.perf_counter()
    cfg = fsd_config()
    model = build_fsd(cfg, seed=0, device="cuda")
    requests = [(s, fsd_scene(s, cfg)[0]) for s in REQUEST_SEEDS]
    torch.cuda.synchronize()
    log({"phase": "fsd_setup", "tasks": [list(t) for t in cfg.task_tuple()],
         "parameters": sum(p.numel() for p in model.parameters()),
         "seconds": round(time.perf_counter() - t0, 3)})
    per_request = fsd_serve(model, requests, wrappers)
    stats = fsd_check_kernels(model, requests[0][1])
    fsd_clustering_alternatives(cfg)
    del model, requests
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    model = build_fsd(cfg, seed=0, device="cuda")
    opt = make_optimizer(model, base_lr=1e-4, total_steps=100, lr_mult_rules=FSD_LR_RULES)
    pb, gt = fsd_scene(0, cfg)
    batch = Batch(pb, None, gt, None)
    train_launches, _ = train(model, opt, batch, wrappers, FSD_MUST_TRAIN, "fsd_train",
                              FSD_HELD_LOSSES)
    train_stats = check_train_kernels(model, opt, batch, TRAIN_WARMUP + TRAIN_STEPS,
                                      "fsd_train_kernel_calls")
    stats["dw_per_tap"] = train_stats["dw_per_tap"]
    stats["gather_conv"]["train_backward"] = train_stats["gather_conv_bwd"]
    log({"phase": "fsd_train_seconds", "seconds": round(time.perf_counter() - t1, 3)})
    with tempfile.TemporaryDirectory() as workdir:
        sharded = ddp_world1(model, opt, batch, wrappers, TRAIN_WARMUP + TRAIN_STEPS + 1,
                             workdir, "fsd_ddp_world1")
        del model, opt, batch
        torch.cuda.empty_cache()
        fsd_two_ranks(workdir)
    log({"phase": "fsd", "seconds": round(time.perf_counter() - t0, 3)})
    return dict(stats=stats, per_request=per_request,
                train_per_step={k: v / TRAIN_STEPS for k, v in train_launches.items()},
                sharded_per_step=sharded)


# -- two-stage FSD (RCNN second stage) and the SST backbone ----------------------

TWO_STAGE_MUST_TRAIN = ("rpn.segmentor", "rpn.query_branch.bbox_head", "roi_head")
# per-leaf gradient bound of two ranks against one process in eval-form BN:
# one process at batch 2 sorts K1's rows otherwise, so an f32 sum an ulp
# apart can round a bf16 UNet activation to its neighbour (2^-8); the RCNN's
# gradient reaches the UNet through the point features, and three of its
# BN biases' near-cancelling sums moved 1.7e-3 to 2.3e-3 on the card
# (fsd_two_ranks' enc2_down.w 2.0e-3, under its 1e-6 absolute floor)
TWO_STAGE_LEAF_RTOL = BF16_CHAIN_TOL


def two_stage_config():
    """Full-width two-stage FSD: the ``FSDConfig`` defaults (the nuScenes
    widths, one task of all ten classes, which the RCNN's proposals need)
    at the bench capacities."""
    from fullysparsefusion_tpu_torch.config import FSDConfig, VoteSegmentorConfig

    bench = bench_config().fsd
    seg = VoteSegmentorConfig(unet_stage_capacities=bench.segmentor.unet_stage_capacities)
    return FSDConfig(tasks=None, caps=bench.caps, segmentor=seg)


def small_two_stage_reference_check(device="cuda"):
    """Tiny two-stage FSD, eval form, forward + losses + ``get_bboxes``: GPU
    (kernels) against CPU (plain versions), same weights and scene,
    ``small_fsd_reference_check``'s tolerances; the proposals' validity and
    the RCNN's non-empty RoIs equal."""
    from fullysparsefusion_tpu_torch import synthetic as S
    from fullysparsefusion_tpu_torch.config import tiny_fsd_config
    from fullysparsefusion_tpu_torch.weights import build_two_stage_fsd

    t0 = time.perf_counter()
    cfg = tiny_fsd_config()
    sc = S.make_scene_arrays(seed=0, n_cap=cfg.caps.points, max_gt=cfg.caps.max_gt)
    ref_model = build_two_stage_fsd(cfg, seed=0, device="cpu")
    outs = {}
    for dev, model in (("cpu", ref_model), (device, copy.deepcopy(ref_model).to(device))):
        pb, gt = S.to_point_batch(sc, dev), S.to_ground_truth(sc, dev)
        with torch.inference_mode():
            res = model(pb, 2, gt)
            outs[dev] = (res, model.get_bboxes(res, 2))
    (r_cpu, d_cpu), (r_gpu, d_gpu) = outs["cpu"], outs[device]
    what = "small two-stage reference"
    for key in ("roi_valid", "roi_batch"):
        if not torch.equal(r_cpu[key], r_gpu[key].cpu()):
            fail(f"{what}: {key} differs")
    if not torch.equal(r_cpu["rcnn"]["nonempty"], r_gpu["rcnn"]["nonempty"].cpu()):
        fail(f"{what}: the non-empty RoIs differ")
    report = {"seg_logits": check_close(what, "seg_logits", r_cpu["seg_out"]["seg_logits"],
                                        r_gpu["seg_out"]["seg_logits"], BF16_CHAIN_TOL)}
    for key in ("cls_logits", "reg_preds", "rois"):
        report[key] = check_close(what, key, r_cpu[key], r_gpu[key], BF16_CHAIN_TOL)
    for key in ("cls_logits", "reg_preds"):
        report[f"rcnn_{key}"] = check_close(what, f"rcnn {key}", r_cpu["rcnn"][key],
                                            r_gpu["rcnn"][key], BF16_CHAIN_TOL)
    l_cpu, l_gpu = r_cpu["losses"], r_gpu["losses"]
    if set(l_cpu) != set(l_gpu) or "rcnn_loss_cls" not in l_cpu:
        fail(f"{what}: loss keys {sorted(l_gpu)}")
    worst = hold_losses_and_detections(what, l_cpu, l_gpu, d_cpu, d_gpu, report)
    n_det, n_rois = int(d_cpu.valid.sum()), int(r_cpu["rcnn"]["nonempty"].sum())
    if min(n_det, n_rois) <= 0:
        fail(f"{what}: vacuous scene, {n_det} detections, {n_rois} non-empty RoIs")
    log({"phase": "small_two_stage_reference", "detections": n_det, "nonempty_rois": n_rois,
         "roi_points": int(r_cpu["rcnn"]["num_roi_points"]),
         "dropped": int(r_cpu["rcnn"]["dropped"]), "losses": len(l_cpu),
         "loss_rel_err": float(f"{worst:.3g}"), "tolerance": BF16_CHAIN_TOL,
         "max_abs_err": {k: float(f"{v:.3g}") for k, v in report.items()},
         "seconds": round(time.perf_counter() - t0, 3)})


def two_stage_serve(model, requests, wrappers) -> dict:
    """Forward + get_bboxes per request under ``torch.inference_mode()``,
    each with the launch counters zeroed just before and read just after:
    K1 and K2 must launch and K3 exactly once (the RCNN decode; the first
    stage runs no NMS). Returns the mean launches per request."""
    t0 = time.perf_counter()
    dets, launches = [], []
    for seed, pb in requests:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero(wrappers)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t_req = time.perf_counter()
        start.record()
        with torch.inference_mode():
            res = model(pb, 1)
            det = model.get_bboxes(res, 1)
        end.record()
        det = type(det)(*[t.cpu() for t in det])  # the answer reaches the host
        host_ms = (time.perf_counter() - t_req) * 1e3
        torch.cuda.synchronize()
        launches.append(counts(wrappers))
        for name, t in zip(det._fields, det):
            if t.is_floating_point() and not torch.isfinite(t).all():
                fail(f"two-stage request seed {seed}: non-finite {name}")
        if det.valid.shape != (1, model.rcnn_cfg.max_num):
            fail(f"two-stage request seed {seed}: detections shape {tuple(det.valid.shape)}")
        if launches[-1]["nms_keep"] != 1 or launches[-1]["ccl_roots"] != 1 or \
                launches[-1]["gather_conv"] <= 0:
            fail(f"two-stage request seed {seed}: launches {launches[-1]}")
        rcnn = res["rcnn"]
        log({"phase": "two_stage_request", "seed": seed, "detections": int(det.valid.sum()),
             "rois": int(res["roi_valid"].sum()), "nonempty_rois": int(rcnn["nonempty"].sum()),
             "roi_points": int(rcnn["num_roi_points"]), "dropped": int(rcnn["dropped"]),
             "fg_points": int(res["num_fg_points"]),
             "gpu_ms": round(start.elapsed_time(end), 3), "host_ms": round(host_ms, 3),
             "peak_mem_mib": round(torch.cuda.max_memory_allocated() / 2**20, 1),
             "launches": launches[-1]})
        dets.append(det)
    first, again = dets[0], dets[-1]
    for name, a, b in zip(first._fields, first, again):
        if not torch.equal(a, b):
            fail(f"re-run of two-stage request seed 0 changed {name}")
    per_request = {k: sum(n[k] for n in launches) / len(launches) for k in launches[0]}
    log({"phase": "two_stage_serve", "requests": len(requests),
         "launches_per_request": per_request, "seconds": round(time.perf_counter() - t0, 3)})
    return per_request


def two_stage_check_kernels(model, pb) -> dict:
    """Every K1, K2 and K3 call of one two-stage request held to its plain
    version (K1 within ``K1_RTOL``, K2 and K3 bitwise) and timed."""
    t0 = time.perf_counter()
    calls = capture_request(lambda: model.get_bboxes(model(pb, 1), 1))
    results = {"gather_conv": replay_gather_conv(calls["gather_conv"], "two_stage_kernel_calls")}
    (call,) = calls["ccl_roots"]
    results["ccl_roots"] = replay_ccl_roots(call, "two_stage_kernel_calls")
    (call,) = calls["nms_keep"]
    results["nms_keep"] = replay_nms_keep(call, "two_stage_kernel_calls", role="rcnn_decode")
    del results["nms_keep"]["flop"], results["nms_keep"]["byte"]
    log({"phase": "two_stage_kernels", "calls": {k: len(v) for k, v in calls.items()},
         "seconds": round(time.perf_counter() - t0, 3)})
    return results


def two_stage_config_two_ranks(scale: int = 1):
    """The tiny two-stage config, every UNet conv on the gather path,
    capacities ample for one scene times ``scale``."""
    from fullysparsefusion_tpu_torch.config import tiny_fsd_config

    cfg = tiny_fsd_config()
    seg = dataclasses.replace(cfg.segmentor, unet_dense_min_occupancy=2.0)
    return dataclasses.replace(cfg, segmentor=seg, caps=ample_caps(cfg.caps, scale))


def two_stage_ddp_rank(rank, world, group):
    """One rank of ``two_stage_two_ranks`` (gloo on the card): the tiny
    two-stage FSD from the seed-0 weights on this rank's scene, eval-form
    BN."""
    from fullysparsefusion_tpu_torch.weights import build_two_stage_fsd

    cfg = two_stage_config_two_ranks()
    wrappers = kernel_wrappers()
    model = build_two_stage_fsd(cfg, seed=0, device="cuda")
    zero(wrappers)
    losses, grads = fsd_eval_bn_step(model, fsd_batch(ddp_scenes(cfg)[rank][0]), 1, group)
    return dict(losses=losses, grads=grads, buffers=dict(model.named_buffers()),
                launches=counts(wrappers))


def two_stage_two_ranks(workdir: str) -> None:
    """Tiny two-stage FSD on two gloo processes on the one card (eval-form
    BN) against one process at batch 2 with doubled capacities:
    ``hold_two_ranks``' exact bounds (``rcnn_loss``'s two ``mesh_mean``'d
    normalizers among them), the ranks bitwise equal, K1, K2 and
    dw_per_tap launched on each."""
    from fullysparsefusion_tpu_torch.parallel.launch import spawn_ranks
    from fullysparsefusion_tpu_torch.weights import build_two_stage_fsd

    t0 = time.perf_counter()
    r0, r1 = spawn_ranks(two_stage_ddp_rank, 2,
                         os.path.join(workdir, "gloo_two_stage_two_ranks"), backend="gloo",
                         device="cuda", timeout=300)
    scenes = ddp_scenes(two_stage_config_two_ranks())
    sc = {k: np.concatenate([s[k] for s, _ in scenes]) for k in scenes[0][0]}
    sc["batch_idx"] = np.concatenate([s["batch_idx"] + i for i, (s, _) in enumerate(scenes)])
    ref_losses, ref_grads = fsd_eval_bn_step(
        build_two_stage_fsd(two_stage_config_two_ranks(scale=2), seed=0, device="cuda"),
        fsd_batch(sc), 2)
    errors = []
    report = hold_two_ranks("two_stage_two_ranks", r0, r1, ref_losses, ref_grads, True,
                            ("gather_conv", "dw_per_tap", "ccl_roots"), errors,
                            TWO_STAGE_LEAF_RTOL)
    if "rcnn_loss_cls" not in ref_losses or not ref_losses["rcnn_loss_cls"] > 0:
        errors.append(f"two_stage_two_ranks: no RCNN class loss, {ref_losses}")
    log({"phase": "two_stage_two_ranks", "backend": "gloo", "device": "cuda", "world_size": 2,
         "train_bn": False, **report, "seconds": round(time.perf_counter() - t0, 3)})
    if errors:
        fail("; ".join(errors))


def two_stage_phase(wrappers) -> dict:
    """The full-width two-stage FSD: serve four requests, replay the kernels
    of one, train (two warm-ups, five timed steps, the backward kernels held
    to their plain versions), NCCL at world size 1 from the trained state
    (bitwise equal to ``train_step``); then the tiny two-stage FSD on two
    gloo ranks. Returns the kernel numbers and launches for the kernels
    line."""
    from fullysparsefusion_tpu_torch.parallel.train import Batch, make_optimizer
    from fullysparsefusion_tpu_torch.weights import build_two_stage_fsd

    t0 = time.perf_counter()
    cfg = two_stage_config()
    model = build_two_stage_fsd(cfg, seed=0, device="cuda")
    requests = [(s, fsd_scene(s, cfg)[0]) for s in REQUEST_SEEDS]
    torch.cuda.synchronize()
    log({"phase": "two_stage_setup", "parameters": sum(p.numel() for p in model.parameters()),
         "roi_head_parameters": sum(p.numel() for p in model.roi_head.parameters()),
         "seconds": round(time.perf_counter() - t0, 3)})
    per_request = two_stage_serve(model, requests, wrappers)
    stats = two_stage_check_kernels(model, requests[0][1])
    del model, requests
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    model = build_two_stage_fsd(cfg, seed=0, device="cuda")
    opt = make_optimizer(model, base_lr=1e-4, total_steps=100,
                         lr_mult_rules={"rpn.segmentor.SegmentorCore_0": 0.2})
    pb, gt = fsd_scene(0, cfg)
    batch = Batch(pb, None, gt, None)
    train_launches, _ = train(model, opt, batch, wrappers, TWO_STAGE_MUST_TRAIN,
                              "two_stage_train", FSD_HELD_LOSSES)
    train_stats = check_train_kernels(model, opt, batch, TRAIN_WARMUP + TRAIN_STEPS,
                                      "two_stage_train_kernel_calls")
    stats["dw_per_tap"] = train_stats["dw_per_tap"]
    stats["gather_conv"]["train_backward"] = train_stats["gather_conv_bwd"]
    log({"phase": "two_stage_train_seconds", "seconds": round(time.perf_counter() - t1, 3)})
    with tempfile.TemporaryDirectory() as workdir:
        ddp_world1(model, opt, batch, wrappers, TRAIN_WARMUP + TRAIN_STEPS + 1, workdir,
                   "two_stage_ddp_world1", exact=True)
        del model, opt, batch
        torch.cuda.empty_cache()
        two_stage_two_ranks(workdir)
    log({"phase": "two_stage", "seconds": round(time.perf_counter() - t0, 3)})
    return dict(stats=stats, per_request=per_request,
                train_per_step={k: v / TRAIN_STEPS for k, v in train_launches.items()})


# the SST backbone's output on the card against the CPU, relative to its
# largest magnitude: f32 throughout (no TF32), sums in another order
SST_TOL = 1e-4
SST_REPS = 3


def sst_inputs(cfg, device="cuda"):
    """The seed-0 bench scene pillarised to the SST grid (512 x 512 x 1 over
    the FSD ``point_cloud_range``): each pillar's mean point channels, its
    (x, y, z) coords, batch ids and validity, capped at the bench's voxel
    capacity. Returns (feats, coords, batch, valid, points in range)."""
    from fullysparsefusion_tpu_torch.ops.voxelize import voxelize_points

    pb, _ = fsd_scene(0, cfg, device)
    r = cfg.segmentor.point_cloud_range
    size = ((r[3] - r[0]) / 512, (r[4] - r[1]) / 512, r[5] - r[2])
    cap = bench_config().fsd.caps.voxels
    seg, _, batch, coords = voxelize_points(pb.xyz, pb.batch_idx, pb.valid, size, r, cap)
    feats = seg.mean(pb.points)
    return feats, coords, batch, seg.seg_valid, int(seg.num_segments)


def sst_phase() -> None:
    """``SSTBackbone`` at its defaults (dim 128, 4 blocks, 8 heads, 512 x 512
    x 1, 16 x 16 x 1 windows, 128 tokens, 1,024 windows; random weights from
    seed 0) on the bench scene's pillars: forward and backward of Σ out²
    timed by CUDA events, the windows and dropped tokens of each partition,
    peak memory; the padding rows exactly 0, the same call on CPU tensors
    within ``SST_TOL`` of the output's magnitude."""
    from fullysparsefusion_tpu_torch.models.sst import SSTBackbone
    from fullysparsefusion_tpu_torch.weights import init_parameters

    t0 = time.perf_counter()
    feats, coords, batch, valid, pillars = sst_inputs(two_stage_config())
    cpu_model = init_parameters(SSTBackbone(feats.shape[1]), torch.Generator().manual_seed(0))
    model = copy.deepcopy(cpu_model).cuda()
    parts = []
    for name, part in zip(("regular", "shifted"), model.partitions(coords, batch, valid)):
        inside = valid & (part.seg.seg_id < model.windows_cap)
        parts.append({"partition": name, "windows": int(part.seg.num_segments),
                      "windows_cap": model.windows_cap,
                      "overflowed_voxels": int((valid & ~inside).sum()),
                      "dropped_tokens": int((valid & (part.inner_idx >= model.max_tokens)).sum()),
                      "max_tokens_in_a_window": int(part.tokens_per_win.max())})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fwd_ms, bwd_ms = [], []
    for _ in range(1 + SST_REPS):
        model.zero_grad(set_to_none=True)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        out = model(feats, coords, batch, valid)
        ev[1].record()
        (out ** 2).sum().backward()
        ev[2].record()
        torch.cuda.synchronize()
        fwd_ms.append(ev[0].elapsed_time(ev[1]))
        bwd_ms.append(ev[1].elapsed_time(ev[2]))
    peak = torch.cuda.max_memory_allocated() / 2**20
    out = out.detach()
    if not torch.isfinite(out).all():
        fail("sst: non-finite output")
    if out[~valid].any():
        fail("sst: a padding row is not 0")
    grads = [p.grad for p in model.parameters()]
    if any(g is None or not torch.isfinite(g).all() for g in grads):
        fail("sst: a parameter has no finite gradient")
    with torch.no_grad():
        ref = cpu_model(*(t.cpu() for t in (feats, coords, batch, valid)))
    err = float((out.cpu() - ref).abs().max())
    scale = float(ref.abs().max())
    if not err <= SST_TOL * scale:
        fail(f"sst: the card's output differs from the CPU's by {err:.3g} (scale {scale:.3g})")
    log({"phase": "sst", "pillars": pillars, "voxels": int(valid.sum()),
         "voxel_capacity": int(valid.shape[0]), "partitions": parts,
         "forward_ms": round(sum(fwd_ms[1:]) / SST_REPS, 3),
         "backward_ms": round(sum(bwd_ms[1:]) / SST_REPS, 3),
         "forward_ms_each": [round(v, 3) for v in fwd_ms],
         "backward_ms_each": [round(v, 3) for v in bwd_ms],
         "peak_mem_mib": round(peak, 1), "max_abs_err_vs_cpu": err, "output_scale": scale,
         "tolerance": SST_TOL, "parameters": sum(p.numel() for p in model.parameters()),
         "seconds": round(time.perf_counter() - t0, 3)})


# -- HTC, the 2D instance-mask model -----------------------------------------

HTC_TINY = dict(depth_blocks=(1, 1, 1, 1), num_proposals=16, rpn_pre_nms=16, max_dets=4)
HTC_TINY_HW = (96, 160)
HTC_DEPTH_HW = (256, 448)
# fixed RoIs (xyxy px) for the cascade and mask heads' taps, inside 96 x 160
HTC_FIXED_ROIS = ((4, 4, 40, 30), (10, 8, 60, 50), (0, 0, 150, 90), (30, 20, 50, 44),
                  (100, 50, 159, 95), (-8, 60, 30, 100))
# one request: one nuScenes sample's six cameras at 900 x 1,600 (padded to 928)
HTC_CAMS, HTC_IMG_HW = 6, (900, 1600)
# the painting's score threshold: at random weights every class scores ~1/11,
# so the tool's 0.3 would paint nothing
HTC_SCORE_THR = 0.0
# HTC taps on the card against the CPU, each relative to the tap's largest
# magnitude: f32 on both (no TF32), cuDNN's conv algorithms against
# oneDNN's, so sums in another order through the tiny model's ~20 layers
# and the default model's ~110 (its 33 bottlenecks, FPN, heads)
HTC_TINY_TOL = 1e-4
HTC_DEPTH_TOL = 1e-3
# the DCN offset branches' weights ~ N(0, HTC_OFFSET_STD^2 / fan_in): the
# seeded init leaves their inputs at an rms of ~0.4-1.3, so offsets of about
# a pixel (a released checkpoint's are not zero either)
HTC_OFFSET_STD = 1.5
# per camera: the RPN's NMS (one class over 5 levels x 1,000) and the
# detections' (ten classes over 1,000 proposals)
HTC_NMS_PER_CAMERA = 2


def htc_model(seed: int = 0, **kw):
    """``build_htc(seed)`` on the CPU with every DCN offset branch drawn
    non-zero from the seed."""
    from fullysparsefusion_tpu_torch.models.htc import DeformConvBlock
    from fullysparsefusion_tpu_torch.weights import build_htc

    model = build_htc(seed=seed, device="cpu", **kw)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, DeformConvBlock):
                w = m.conv_offset.weight
                w.normal_(0.0, HTC_OFFSET_STD / math.sqrt(w[0].numel()), generator=gen)
    return model


def htc_images(seed: int, n: int, hw) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, *hw, 3), dtype=np.uint8)


def htc_tap_errors(what: str, ref: dict, got: dict, tol: float) -> dict:
    """Each tap's largest difference over the tap's largest magnitude; fails
    past ``tol`` and names the earliest tap (``ACTIVATION_ORDER``) past it."""
    from fullysparsefusion_tpu_torch.utils.htc_parity import ACTIVATION_ORDER

    errs = {}
    for k in ACTIVATION_ORDER:
        if k not in ref:
            continue
        a, b = ref[k], got[k]
        if a.shape != b.shape or not np.isfinite(b).all():
            fail(f"{what}: tap {k} has shape {b.shape} or non-finite values")
        errs[k] = float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))
    worst = [k for k, v in errs.items() if v > tol]
    if worst:
        fail(f"{what}: tap {worst[0]} differs by {errs[worst[0]]:.3g} of its magnitude "
             f"(tolerance {tol})")
    return errs


def small_htc_reference_check(device="cuda"):
    """Tiny HTC (one bottleneck per stage, 16 proposals, 4 detections, 96 x
    160, DCN offsets non-zero): every ``ACTIVATION_ORDER`` tap (the image
    taps and the cascade and mask heads on fixed RoIs) GPU against CPU
    within ``HTC_TINY_TOL`` of its magnitude; the whole forward's
    detections: validity and labels equal, boxes, scores and mask
    probabilities within ``HTC_TINY_TOL`` (boxes of the image size)."""
    from fullysparsefusion_tpu_torch.utils.htc_parity import dump_torch_activations

    t0 = time.perf_counter()
    ref_model = htc_model(0, **HTC_TINY)
    gpu_model = copy.deepcopy(ref_model).to(device)
    img = torch.from_numpy(htc_images(0, 1, HTC_TINY_HW)).float()
    rois = torch.tensor(HTC_FIXED_ROIS, dtype=torch.float32)
    acts, dets = {}, {}
    for dev, model in (("cpu", ref_model), (device, gpu_model)):
        acts[dev] = dump_torch_activations(model, img.to(dev), rois.to(dev))
        with torch.inference_mode():
            (det,) = model(img.to(dev))
        dets[dev] = type(det)(*[t.cpu() for t in det])
    what = "small HTC reference"
    errs = htc_tap_errors(what, acts["cpu"], acts[device], HTC_TINY_TOL)
    d_cpu, d_gpu = dets["cpu"], dets[device]
    if not torch.equal(d_cpu.valid, d_gpu.valid) or not torch.equal(d_cpu.labels, d_gpu.labels):
        fail(f"{what}: detection validity or labels differ")
    report = {}
    for name, scale in (("boxes", max(HTC_TINY_HW)), ("scores", 1.0), ("masks", 1.0)):
        a, b = getattr(d_cpu, name), getattr(d_gpu, name)
        report[name] = float((a - b).abs().max())
        if report[name] > HTC_TINY_TOL * scale:
            fail(f"{what}: detection {name} differ by {report[name]:.3g}")
    if int(d_cpu.valid.sum()) <= 0:
        fail(f"{what}: no detection")
    log({"phase": "small_htc_reference", "tolerance": HTC_TINY_TOL,
         "tap_rel_err": {k: float(f"{v:.3g}") for k, v in errs.items()},
         "worst_tap": max(errs, key=errs.get), "detections": int(d_cpu.valid.sum()),
         "labels": d_cpu.labels.tolist(),
         "det_max_abs_err": {k: float(f"{v:.3g}") for k, v in report.items()},
         "seconds": round(time.perf_counter() - t0, 3)})


def htc_depth_check(model, cpu_model, device="cuda"):
    """The default HTC (``model`` on the card, ``cpu_model`` its copy on the
    CPU) on one camera at 256 x 448: the image-level taps and the cascade
    and mask heads on fixed RoIs, each within ``HTC_DEPTH_TOL`` of its
    magnitude. Not held on the proposals' and detections' discrete
    selection."""
    from fullysparsefusion_tpu_torch.utils.htc_parity import dump_torch_activations

    t0 = time.perf_counter()
    img = torch.from_numpy(htc_images(7, 1, HTC_DEPTH_HW)).float()
    rois = torch.tensor(HTC_FIXED_ROIS, dtype=torch.float32) * 2.5
    got = dump_torch_activations(model, img.to(device), rois.to(device))
    ref = dump_torch_activations(cpu_model, img, rois)
    errs = htc_tap_errors("full-depth HTC check", ref, got, HTC_DEPTH_TOL)
    log({"phase": "htc_depth_check", "image_hw": list(HTC_DEPTH_HW), "tolerance": HTC_DEPTH_TOL,
         "tap_rel_err": {k: float(f"{v:.3g}") for k, v in errs.items()},
         "worst_tap": max(errs, key=errs.get), "seconds": round(time.perf_counter() - t0, 3)})


def htc_serve(model, requests, wrappers) -> dict:
    """One request per seed: six 900 x 1,600 cameras (uint8 RGB from the
    seed), padded and copied to the card, then the HTC forward (``gpu_ms``,
    CUDA events) and on the host the paste and paint (``host_ms``), each
    with the launch counters zeroed just before the forward and read just
    after: K3 ``HTC_NMS_PER_CAMERA`` times a camera, nothing else. The
    repeat of seed 0 must give its detections and mask planes bitwise."""
    from fullysparsefusion_tpu_torch import generate_masks as gm

    t0 = time.perf_counter()
    results, launches = [], []
    for seed, images in requests:
        x = torch.from_numpy(gm.pad_images(images)).cuda()
        proposals = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero(wrappers)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with capture_results(model, "_proposals", proposals), torch.inference_mode():
            start.record()
            dets = model(x)
            end.record()
        torch.cuda.synchronize()
        launches.append(counts(wrappers))
        peak = torch.cuda.max_memory_allocated() / 2**20
        t_host = time.perf_counter()
        pasted = gm.paste_detections(dets, HTC_IMG_HW, HTC_SCORE_THR)
        planes, annos = gm.paint_sample(pasted, HTC_CAMS, model.num_classes, HTC_IMG_HW)
        anno = gm.reorg_anno(annos)
        host_ms = (time.perf_counter() - t_host) * 1e3
        dets = [type(d)(*[t.cpu() for t in d]) for d in dets]
        for d in dets:
            for name, t in zip(d._fields, d):
                if t.is_floating_point() and not torch.isfinite(t).all():
                    fail(f"HTC request seed {seed}: non-finite {name}")
        expect = {k: 0 for k in wrappers}
        expect["nms_keep"] = HTC_NMS_PER_CAMERA * HTC_CAMS
        if launches[-1] != expect:
            fail(f"HTC request seed {seed}: launches {launches[-1]}, expected {expect}")
        log({"phase": "htc_request", "seed": seed, "cameras": HTC_CAMS,
             "padded_hw": list(x.shape[1:3]),
             "valid_proposals_per_camera": [int(v.sum()) for _, v in proposals],
             "detections_per_camera": [int(d.valid.sum()) for d in dets],
             "painted_instances": int(anno[:, 8].sum()),
             "painted_pixels": int((planes > 0).sum()),
             "gpu_ms": round(start.elapsed_time(end), 3), "host_ms": round(host_ms, 3),
             "peak_mem_mib": round(peak, 1), "launches": launches[-1]})
        results.append((dets, planes, anno))
    (d0, p0, a0), (d1, p1, a1) = results[0], results[-1]
    for cam, (a, b) in enumerate(zip(d0, d1)):
        for name, u, v in zip(a._fields, a, b):
            if not torch.equal(u, v):
                fail(f"re-run of HTC request seed 0 changed camera {cam}'s {name}")
    if not (np.array_equal(p0, p1) and np.array_equal(a0, a1)):
        fail("re-run of HTC request seed 0 changed the mask planes or the anno table")
    per_request = {k: sum(n[k] for n in launches) / len(launches) for k in launches[0]}
    log({"phase": "htc_serve", "requests": len(requests), "launches_per_request": per_request,
         "seconds": round(time.perf_counter() - t0, 3)})
    return per_request


def htc_check_kernels(model, images) -> dict:
    """Every K3 call of one HTC request held bitwise to its plain version on
    the card and timed (CUDA-graph replay), by shape; the mean |offset| of
    each ResNeXt stage's DCN blocks in that request."""
    from fullysparsefusion_tpu_torch import generate_masks as gm
    from fullysparsefusion_tpu_torch.models.htc import DeformConvBlock

    t0 = time.perf_counter()
    x = torch.from_numpy(gm.pad_images(images)).cuda()
    offsets, hooks = {}, []
    for name, m in model.named_modules():
        if isinstance(m, DeformConvBlock):
            stage = name.split(".")[1].split("_")[0]
            hooks.append(m.conv_offset.register_forward_hook(
                lambda _m, _i, out, s=stage: offsets.setdefault(s, []).append(out.abs().mean())))
    try:
        calls = capture_request(lambda: model(x))
    finally:
        for h in hooks:
            h.remove()
    if len(calls["nms_keep"]) != HTC_NMS_PER_CAMERA * HTC_CAMS:
        fail(f"the HTC request made {len(calls['nms_keep'])} nms_keep calls")
    shapes = {}
    for i, call in enumerate(calls["nms_keep"]):
        c, n = call[1].shape
        # every camera's RPN call (one class) comes before the class NMS calls
        role, camera = ("rpn", i) if i < HTC_CAMS else ("classes", i - HTC_CAMS)
        res = replay_nms_keep(call, "htc_kernel_calls", camera=camera, role=role)
        shapes.setdefault(f"C{c}_N{n}", []).append(res)
    per_shape = {}
    for key, rs in shapes.items():
        flop, byte = sum(r["flop"] for r in rs), sum(r["byte"] for r in rs)
        per_shape[key] = dict(calls=len(rs), max_abs_err=0.0,
                              **{k: sum(r[k] for r in rs) / len(rs)
                                 for k in ("ms", "plain_ms", "bound_ms")},
                              bound_by=bound(flop, byte, PEAK_F32_FLOPS)[1])
    mean_offset = {s: float(torch.stack(v).mean()) for s, v in offsets.items()}
    log({"phase": "htc_kernels", "nms_keep_per_shape": per_shape,
         "mean_abs_offset_per_stage": {k: round(v, 4) for k, v in mean_offset.items()},
         "seconds": round(time.perf_counter() - t0, 3)})
    return per_shape


def htc_phase(wrappers) -> dict:
    """The default HTC (ResNeXt-101 64 x 4d with DCN at c3-c5, random
    weights from seed 0, offsets non-zero): the full-depth check at 256 x
    448, four full-width requests (seeds 0, 1, 2, 0) and every K3 call of
    one. cuDNN runs deterministic algorithms here (the repeat is held
    bitwise), f32 without TF32. Returns the K3 numbers per shape and the
    launches per request."""
    t0 = time.perf_counter()
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        cpu_model = htc_model(0)
        model = copy.deepcopy(cpu_model).cuda()
        log({"phase": "htc_setup", "parameters": sum(p.numel() for p in model.parameters()),
             "seconds": round(time.perf_counter() - t0, 3)})
        htc_depth_check(model, cpu_model)
        del cpu_model
        requests = [(s, htc_images(s, HTC_CAMS, HTC_IMG_HW)) for s in REQUEST_SEEDS]
        per_request = htc_serve(model, requests, wrappers)
        per_shape = htc_check_kernels(model, requests[0][1])
    del model
    torch.cuda.empty_cache()
    log({"phase": "htc", "seconds": round(time.perf_counter() - t0, 3)})
    return dict(per_shape=per_shape, per_request=per_request)


# -- Argoverse 2 -----------------------------------------------------------------

# the JAX package's AV2 bench capacities (tools/bench_av2.py, batch 1) and
# its per-stage active-set capacities
AV2_CAPS = dict(
    points=131072, voxels=57344, prevox=98304, fg_per_group=4096,
    cluster_voxels_per_group=1024, clusters=1024, max_gt=128,
    frustum_points=16384, frustum_objects=256, roi_points=32768, max_roi_points=512,
)
AV2_STAGE_CAPS = (57344, 122880, 143360, 88576, 32768)
# the true per-stage counts that tools/bench_av2.py's comment gives for the
# JAX package's scene (stages 0-3), printed beside the port's; the JAX
# package computes 101,421 at stage 1 on the CPU today, as the port does
# (tests/test_torch_av2.py)
AV2_BENCH_COUNTS = (47281, 101419, 119199, 73537)
# a generous cap per stage, so that no stage clips while counting
AV2_COUNT_CAPS = (98304, 163840, 163840, 131072, 65536)
AV2_TRAIN_STEPS = 3


def av2_config():
    """The in-repo ``av2_fsf_config`` at the AV2 bench's capacities."""
    from fullysparsefusion_tpu_torch.config import Capacities, av2_fsf_config

    cfg = av2_fsf_config(Capacities(**AV2_CAPS))
    seg = dataclasses.replace(cfg.fsd.segmentor, unet_stage_capacities=AV2_STAGE_CAPS)
    return dataclasses.replace(cfg, fsd=dataclasses.replace(cfg.fsd, segmentor=seg))


def av2_scene(seed: int, cfg):
    """The JAX package's AV2 bench scene and its seven cameras (NumPy)."""
    from fullysparsefusion_tpu_torch import synthetic as S

    return S.make_av2_scene_arrays(seed, n_cap=cfg.caps.points, max_gt=cfg.caps.max_gt,
                                   num_classes=cfg.num_classes)


def hold_bound(what: str, ms: float, bound_ms: float) -> None:
    """A measured time below the least time the card could take means the
    timing or the cost model is wrong."""
    if not ms >= bound_ms:
        fail(f"{what}: {ms:.6g} ms is below its bound of {bound_ms:.6g} ms")


def av2_stage_counts(cfg, pb) -> None:
    """Each UNet stage's true active voxels on the seed-0 scene (voxelize
    and the strided conv's output sets, at generous caps) beside its
    capacity, whether the capacity clips it, and the path its convs take
    (the occupancy rule of ``sparse_conv.use_dense_conv``)."""
    from fullysparsefusion_tpu_torch.ops.sparse_conv import (
        SparseTensor, downsample_coords, use_dense_conv)
    from fullysparsefusion_tpu_torch.ops.voxelize import grid_dims, voxelize_points

    seg_cfg = cfg.fsd.segmentor
    seg, _, vb, vc = voxelize_points(pb.xyz, pb.batch_idx, pb.valid, seg_cfg.voxel_size,
                                     seg_cfg.point_cloud_range, AV2_COUNT_CAPS[0])
    dims = grid_dims(seg_cfg.voxel_size, seg_cfg.point_cloud_range)
    st = SparseTensor(feats=torch.zeros(AV2_COUNT_CAPS[0], 1, device=pb.points.device),
                      coords=vc, batch=vb, valid=seg.seg_valid, dims=dims, batch_size=1)
    counts_, all_dims = [int(st.valid.sum())], [dims]
    for i, pad in enumerate(seg_cfg.unet_strided_paddings):
        oc, ob, ov, od = downsample_coords(st, (3, 3, 3), (2, 2, 2), pad, AV2_COUNT_CAPS[i + 1])
        st = SparseTensor(feats=torch.zeros(AV2_COUNT_CAPS[i + 1], 1, device=oc.device),
                          coords=oc, batch=ob, valid=ov, dims=od, batch_size=1)
        counts_.append(int(ov.sum()))
        all_dims.append(od)
    paths = []
    for i, (cap, d) in enumerate(zip(AV2_STAGE_CAPS, all_dims)):
        ch = seg_cfg.unet_encoder_channels[i][-1]
        stub = SparseTensor(feats=torch.empty(cap, ch, device="meta"), coords=None, batch=None,
                            valid=None, dims=d, batch_size=1)
        paths.append("dense" if use_dense_conv(stub, ch, seg_cfg.unet_dense_min_occupancy)
                     else "gather")
    if any(c >= cap for c, cap in zip(counts_, AV2_COUNT_CAPS)):
        fail(f"AV2 stage counts {counts_} reach the counting caps {AV2_COUNT_CAPS}")
    log({"phase": "av2_stages", "active_voxels": counts_, "caps": list(AV2_STAGE_CAPS),
         "clipped": [c >= cap for c, cap in zip(counts_, AV2_STAGE_CAPS)],
         "dims_xyz": [list(d) for d in all_dims], "conv_path": paths,
         "jax_bench_comment_counts": list(AV2_BENCH_COUNTS)})


def av2_serve(model, requests, wrappers) -> dict:
    """One request per seed: the scene's NumPy arrays converted and copied
    to the card (``input_ms``: the points and the seven cameras' packed
    planes, ``[7 · 1,024 · 775, 26]`` int32), then forward + get_bboxes
    (``gpu_ms`` by CUDA events, ``host_ms`` until the detections reach the
    host), each with the launch counters zeroed just before and read just
    after: K1, K2 and K3 must launch. The repeat of seed 0 must give its
    detections bitwise. Returns the mean launches per request."""
    from fullysparsefusion_tpu_torch import synthetic as S

    t0 = time.perf_counter()
    dets, launches = [], []
    groups = model.cfg.fsd.num_groups
    for seed, (sc, cam) in requests:
        torch.cuda.synchronize()
        t_in = time.perf_counter()
        pb, cd = S.fsf_inputs(sc, cam, device="cuda")
        torch.cuda.synchronize()
        input_ms = (time.perf_counter() - t_in) * 1e3
        torch.cuda.reset_peak_memory_stats()
        zero(wrappers)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t_req = time.perf_counter()
        start.record()
        with torch.inference_mode():
            res = model(pb, cd, 1)
            det = model.get_bboxes(res, 1)
        end.record()
        det = type(det)(*[t.cpu() for t in det])  # the answer reaches the host
        host_ms = (time.perf_counter() - t_req) * 1e3
        torch.cuda.synchronize()
        launches.append(counts(wrappers))
        for name, t in zip(det._fields, det):
            if t.is_floating_point() and not torch.isfinite(t).all():
                fail(f"AV2 request seed {seed}: non-finite {name}")
        if det.valid.shape != (1, model.cfg.refined_head.max_num) or det.boxes.shape[-1] != 7:
            fail(f"AV2 request seed {seed}: detections shape {tuple(det.boxes.shape)}")
        if min(launches[-1][k] for k in ("gather_conv", "ccl_roots", "nms_keep")) <= 0 \
                or launches[-1]["segment_sum"] != FSF_SEGMENT_SUMS:
            fail(f"AV2 request seed {seed}: launches {launches[-1]}")
        fsd = res["fsd"]
        per_group = torch.bincount(fsd["cluster_group"][fsd["cluster_valid"]].long(),
                                   minlength=groups).tolist()
        log({"phase": "av2_request", "seed": seed, "detections": int(det.valid.sum()),
             "camera_queries": int(res["frustum"]["obj_valid"].sum()),
             "lidar_queries": int(fsd["num_clusters"]), "clusters_per_group": per_group,
             "fg_points": int(fsd["num_fg_points"]),
             "input_ms": round(input_ms, 3), "gpu_ms": round(start.elapsed_time(end), 3),
             "host_ms": round(host_ms, 3),
             "peak_mem_mib": round(torch.cuda.max_memory_allocated() / 2**20, 1),
             "mask_planes_mib": round(cd.masks.numel() * 4 / 2**20, 1),
             "launches": launches[-1]})
        dets.append(det)
        del pb, cd, res
    first, again = dets[0], dets[-1]
    for name, a, b in zip(first._fields, first, again):
        if not torch.equal(a, b):
            fail(f"re-run of AV2 request seed 0 changed {name}")
    per_request = {k: sum(n[k] for n in launches) / len(launches) for k in launches[0]}
    log({"phase": "av2_serve", "requests": len(requests), "launches_per_request": per_request,
         "seconds": round(time.perf_counter() - t0, 3)})
    return per_request


def av2_check_kernels(model, request, phase: str = "av2_kernels") -> dict:
    """Every K1, K2 and K3 call of one AV2 request held to its plain version
    (K1 within ``K1_RTOL``, K2 and K3 bitwise) and graph-timed, each beside
    its bound (K3 at C = 26). ``phase`` names the summary line; the calls'
    lines take it with ``kernels`` read as ``kernel_calls``."""
    from fullysparsefusion_tpu_torch.ops import segment

    t0 = time.perf_counter()
    calls_phase = phase.replace("kernels", "kernel_calls")
    sums = []
    with capture_calls(segment.SegmentInfo, "sum", sums):
        calls = capture_request(lambda: model.get_bboxes(model(*request, 1), 1))
    results = {"segment_sum": replay_request_sums(sums, "AV2 request", "av2_request",
                                                  "av2_segment_sum")}
    results["gather_conv"] = replay_gather_conv(calls["gather_conv"], calls_phase)
    for c in results["gather_conv"]["calls"]:
        hold_bound(f"AV2 K1 [{c['n_out']} x {c['cin']} -> {c['cout']}]", c["ms"], c["bound_ms"])
    (call,) = calls["ccl_roots"]
    results["ccl_roots"] = replay_ccl_roots(call, calls_phase)
    (call,) = calls["nms_keep"]
    if call[1].shape[0] != model.cfg.num_classes:
        fail(f"the AV2 decode's K3 call has C = {call[1].shape[0]}")
    results["nms_keep"] = replay_nms_keep(call, calls_phase)
    del results["nms_keep"]["flop"], results["nms_keep"]["byte"]
    for name in ("ccl_roots", "nms_keep"):
        hold_bound(f"AV2 {name}", results[name]["ms"], results[name]["bound_ms"])
    log({"phase": phase, "calls": {k: len(v) for k, v in calls.items()},
         "seconds": round(time.perf_counter() - t0, 3)})
    return results


def av2_entry_point(model, cfg, sc, cam) -> tuple:
    """The normal entry point: the seed-0 scene written as an AV2 info
    pickle and a ``.bin`` of 4-dim points, read back by ``AV2Reader``
    (eval form), collated by ``collate_scene`` at the bench capacities,
    served, turned into AV2 detection rows and scored by ``evaluate_av2``
    against the reader's GT. Returns the served detections as
    ``format_results`` takes them: (boxes, scores, labels, log id,
    timestamp)."""
    import pickle

    from fullysparsefusion_tpu_torch import synthetic as S
    from fullysparsefusion_tpu_torch.config import AV2_CLASS_NAMES
    from fullysparsefusion_tpu_torch.data.av2 import AV2Reader, boxes_to_av2_rows
    from fullysparsefusion_tpu_torch.data.pipelines import collate_scene
    from fullysparsefusion_tpu_torch.eval.av2_detection import evaluate_av2
    from fullysparsefusion_tpu_torch.eval.detection import DetectionRecord

    t0 = time.perf_counter()
    n_gt = int(sc["gt_valid"][0].sum())
    with tempfile.TemporaryDirectory() as root:
        sc["points"][sc["valid"]].astype(np.float32).tofile(os.path.join(root, "lidar_0.bin"))
        info = dict(lidar_path="lidar_0.bin", gt_boxes=sc["gt_boxes"][0, :n_gt, :7],
                    gt_names=[AV2_CLASS_NAMES[int(c)] for c in sc["gt_labels"][0, :n_gt]],
                    log_id="synthetic_seed0", timestamp_ns=0)
        with open(os.path.join(root, "infos.pkl"), "wb") as f:
            pickle.dump({"infos": [info]}, f)
        reader = AV2Reader(os.path.join(root, "infos.pkl"), root, AV2_CLASS_NAMES, training=False,
                           point_cloud_range=cfg.fsd.segmentor.point_cloud_range)
        sample = reader.sample(0)
    batch = collate_scene([sample], cfg.caps.points, cfg.caps.max_gt)
    pb = S.to_point_batch(batch, device="cuda")
    cd = S.to_camera_data(cam, device="cuda")
    with torch.inference_mode():
        det = model.get_bboxes(model(pb, cd, 1), 1)
    det = type(det)(*[t[0].cpu().numpy() for t in det])
    v = det.valid
    rows = boxes_to_av2_rows(det.boxes[v], det.scores[v], det.labels[v], AV2_CLASS_NAMES,
                             sample["log_id"], sample["timestamp_ns"])
    if len(rows) != int(v.sum()) or not all(math.isfinite(r["qw"]) for r in rows):
        fail("boxes_to_av2_rows: wrong rows")
    metrics = evaluate_av2([DetectionRecord(det.boxes[v], det.scores[v], det.labels[v],
                                            sample["gt_boxes"], sample["gt_labels"])],
                           cfg.num_classes, AV2_CLASS_NAMES)
    if not (math.isfinite(metrics["mAP"]) and math.isfinite(metrics["CDS"])):
        fail(f"evaluate_av2 gave {metrics['mAP']}, {metrics['CDS']}")
    log({"phase": "av2_entry_point", "points_read": int(len(sample["points"])),
         "points_written": int(sc["valid"].sum()), "gt_boxes": int(len(sample["gt_labels"])),
         "rows": len(rows), "mAP": metrics["mAP"], "CDS": metrics["CDS"],
         "classes_scored": len(metrics["per_class"]),
         "seconds": round(time.perf_counter() - t0, 3)})
    return det.boxes[v], det.scores[v], det.labels[v], sample["log_id"], sample["timestamp_ns"]


def av2_phase(wrappers) -> dict:
    """Full-width FSF at AV2's shape (``av2_fsf_config``: 26 classes, 7 ring
    cameras, code size 8, the 2,048 x 2,048 x 32 grid) at the AV2 bench's
    capacities, random weights from seed 0: the seed-0 scene's per-stage
    active voxels; four requests (seeds 0, 1, 2, 0); every K1, K2 and K3
    call of one held to its plain version; two warm-up and three timed
    train steps with the backward kernels held; the reader -> collate ->
    serve -> rows -> metric path. Returns the kernel numbers and the
    launches for the kernels line, and for the offline tools each seed's
    valid points and GT (``sweeps``), the entry point's detections and the
    served model (eval form, for ``av2_disk``)."""
    from fullysparsefusion_tpu_torch import synthetic as S
    from fullysparsefusion_tpu_torch.parallel import train as ptrain
    from fullysparsefusion_tpu_torch.weights import build_fsf

    t0 = time.perf_counter()
    cfg = av2_config()
    model = build_fsf(cfg, seed=0, device="cuda")
    scenes = {s: av2_scene(s, cfg) for s in sorted(set(REQUEST_SEEDS))}
    torch.cuda.synchronize()
    log({"phase": "av2_setup", "parameters": sum(p.numel() for p in model.parameters()),
         "classes": cfg.num_classes, "cameras": cfg.num_cams,
         "code_size": cfg.refined_head.code_size, "points": int(scenes[0][0]["valid"].sum()),
         "gt_boxes": int(scenes[0][0]["gt_valid"].sum()),
         "seconds": round(time.perf_counter() - t0, 3)})
    pb0, cd0 = S.fsf_inputs(*scenes[0], device="cuda")
    av2_stage_counts(cfg, pb0)
    per_request = av2_serve(model, [(s, scenes[s]) for s in REQUEST_SEEDS], wrappers)
    stats = av2_check_kernels(model, (pb0, cd0))
    entry_dets = av2_entry_point(model, cfg, *scenes[0])
    serving = model          # served again from disk by av2_disk
    sweeps = {}
    for seed, (sc, _) in scenes.items():
        gv = sc["gt_valid"][0]
        sweeps[seed] = (sc["points"][sc["valid"]], sc["gt_boxes"][0][gv], sc["gt_labels"][0][gv])
    del model
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    model = build_fsf(cfg, seed=0, device="cuda")
    opt = ptrain.make_optimizer(model, base_lr=1e-4, total_steps=100,
                                lr_mult_rules=TRAIN_LR_RULES)
    gt = S.to_ground_truth(scenes[0][0])
    batch = ptrain.Batch(pb0, cd0, gt, gt)
    steps = []
    with capture_results(ptrain, "train_step", steps):
        train_launches, k1_per_step = train(model, opt, batch, wrappers, phase="av2_train",
                                            steps=AV2_TRAIN_STEPS)
    if any("vel" in k for _, losses, _ in steps for k in losses):
        fail(f"the AV2 train step has a velocity loss: {sorted(steps[-1][1])}")
    train_stats = check_train_kernels(model, opt, batch, TRAIN_WARMUP + AV2_TRAIN_STEPS,
                                      "av2_train_kernel_calls")
    for c in train_stats["dw_per_tap"]["calls"]:
        hold_bound(f"AV2 dw_per_tap [{c['n_out']}: {c['cin']} x {c['cout']}]", c["ms"],
                   c["bound_ms"])
    for c in train_stats["gather_conv_bwd"]["calls"]:
        hold_bound(f"AV2 K1 d_feats [{c['n_out']}: {c['cin']} -> {c['cout']}]", c["ms"],
                   c["bound_ms"])
    stats["dw_per_tap"] = train_stats["dw_per_tap"]
    stats["gather_conv"]["train_backward"] = train_stats["gather_conv_bwd"]
    log({"phase": "av2_train_seconds", "seconds": round(time.perf_counter() - t1, 3),
         "gather_conv_per_step": k1_per_step})
    del model, opt, batch, pb0, cd0, gt, steps
    torch.cuda.empty_cache()
    log({"phase": "av2", "seconds": round(time.perf_counter() - t0, 3)})
    return dict(stats=stats, per_request=per_request,
                train_per_step={k: v / AV2_TRAIN_STEPS for k, v in train_launches.items()},
                sweeps=sweeps, entry_dets=entry_dets, model=serving)


# the nuScenes entry point: the bench scenes written as an info tree, served
# and trained through the CLIs
NUSC_ENTRY_SEEDS = (0, 1, 2)
# masks written at 900 x 1,600 and read at --mask-downsample 2: the bench's
# 450 x 800 planes
NUSC_ENTRY_SCALE = 2
NUSC_ENTRY_WARMUP, NUSC_ENTRY_STEPS = 2, 3
NUSC_ENTRY_KERNELS = ("gather_conv", "ccl_roots", "nms_keep")


def nusc_entry_tree(root: str, cfg) -> dict:
    """The bench scenes of ``NUSC_ENTRY_SEEDS`` written as an mmdet3d
    nuScenes info tree through ``cli.make_fake_nuscenes.write_scene`` (the
    key frame and 9 sweeps as ``.bin`` files with their transforms, six
    cameras at 900 x 1,600 in the ``cams`` dict, the mask PNGs painted from
    the scene's camera masks), every written PNG decoded by ``data/png.py``
    and held bitwise to its painted plane; then the GT database over the
    tree by ``cli.create_gt_database``."""
    from fullysparsefusion_tpu_torch.cli import create_gt_database as G
    from fullysparsefusion_tpu_torch.cli import make_fake_nuscenes as M
    from fullysparsefusion_tpu_torch.data.png import read_png

    t0 = time.perf_counter()
    infos, scenes, planes, decode_ms = [], [], 0, 0.0
    for i, seed in enumerate(NUSC_ENTRY_SEEDS):
        sc, cam = bench_scene(seed, cfg)
        info = M.write_scene(root, i, sc, cam, img_h=450, img_w=800, fx=400.0,
                             scale=NUSC_ENTRY_SCALE)
        ids = (cam["masks"][0] & 0xFF).astype(np.uint8)
        ids = ids.repeat(NUSC_ENTRY_SCALE, axis=1).repeat(NUSC_ENTRY_SCALE, axis=2)
        sdir = os.path.join(root, "masks", info["token"])
        for f in sorted(os.listdir(sdir)):
            if not f.endswith(".png"):
                continue
            c, k = (int(x) for x in f[:-4].split("_"))
            t1 = time.perf_counter()
            got = read_png(os.path.join(sdir, f))
            decode_ms += (time.perf_counter() - t1) * 1e3
            if not np.array_equal(got, ids[c, :, :, k]):
                fail(f"nuScenes entry: {info['token']}/{f} does not decode to its painted plane")
            planes += 1
        infos.append(info)
        scenes.append((sc, cam))
    info_path = M.write_infos(root, infos)
    db = os.path.join(root, "gt_db.pkl")
    db_counts = G.run(G.parse_args(["--info-pkl", info_path, "--data-root", root, "--out", db]))
    log({"phase": "nusc_entry_tree", "samples": len(infos),
         "points_written": [int(sc["valid"].sum()) for sc, _ in scenes],
         "sweeps": len(infos[0]["sweeps"]), "planes": planes,
         "planes_held_bitwise": planes, "decode_ms_per_plane": round(decode_ms / planes, 3),
         "gt_database": {int(k): v for k, v in db_counts.items() if v},
         "seconds": round(time.perf_counter() - t0, 3)})
    return dict(info=info_path, masks=os.path.join(root, "masks"), db=db, scenes=scenes)


def nusc_entry_direct(model, tree: dict, cfg):
    """The valid detections (boxes, scores, labels) of ``model`` called
    directly on ``collate_scene([reader.sample(0)])`` and its masks, in eval
    form; the sample's camera data are held bitwise to the bench scene's
    own cameras."""
    from fullysparsefusion_tpu_torch.cli.common import load_masks, point_batch
    from fullysparsefusion_tpu_torch.data.nuscenes import NuScenesReader
    from fullysparsefusion_tpu_torch.data.pipelines import collate_scene
    from fullysparsefusion_tpu_torch.models.camera import CameraData

    reader = NuScenesReader(tree["info"], os.path.dirname(tree["info"]), cfg.fsd.class_names,
                            training=False, with_cbgs=False)
    s = reader.sample(0, augment=False)
    planes = load_masks([s], tree["masks"], cfg.num_classes, (900, 1600), NUSC_ENTRY_SCALE)
    _, cam = tree["scenes"][0]
    for name, got, want in zip(("masks", "anno", "lidar2img"), planes,
                               (cam["masks"], cam["anno"], cam["lidar2img"])):
        if got.dtype != want.dtype or not np.array_equal(got, want):
            fail(f"nuScenes entry: the tree's {name} differ from the bench scene's")
    batch = collate_scene([s], cfg.caps.points, cfg.caps.max_gt)
    model.eval()
    with torch.inference_mode():
        det = model.get_bboxes(model(point_batch(batch, "cuda"),
                                     CameraData.build(*planes, device="cuda"), 1), 1)
    det = [t[0].cpu().numpy() for t in det]
    v = det[3]
    return det[0][v], det[1][v], det[2][v]


def hold_detections(what: str, result: dict, direct) -> None:
    """A CLI result (JSON lists) bitwise equal to a direct call's arrays."""
    for key, want in zip(("boxes", "scores", "labels"), direct):
        if len(result[key]) != len(want) or (
                len(want) and not np.array_equal(np.asarray(result[key], want.dtype), want)):
            fail(f"{what}: {key} differ from the direct call ({len(result[key])} against "
                 f"{len(want)})")


def state_equal(a, b) -> bool:
    """Bitwise equality of two state dicts (nested dicts / lists of tensors
    and numbers)."""
    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a, b.to(a.device))
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            state_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(state_equal(x, y) for x, y in zip(a, b))
    return a == b


def nusc_entry_serve(cfg, tree: dict, workdir: str, wrappers) -> dict:
    """``cli.test.run --model fsf --eval`` over the three samples, the
    counters zeroed just before and read just after; per sample its host
    ms, ``gpu_ms``, detections and launches; seed 0's detections bitwise
    equal to the model called directly; the JSON and the metrics finite."""
    from fullysparsefusion_tpu_torch.cli import test as T

    t0 = time.perf_counter()
    out_json = os.path.join(workdir, "detections.json")
    args = T.parse_args(["--model", "fsf", "--eval", "--info-pkl", tree["info"], "--data-root",
                         os.path.dirname(tree["info"]), "--mask-dir", tree["masks"],
                         "--mask-downsample", str(NUSC_ENTRY_SCALE), "--out", out_json])
    torch.cuda.reset_peak_memory_stats()
    zero(wrappers)
    res = T.run(cfg, args)
    launches = counts(wrappers)
    for rec in res["samples"]:
        if min(rec["launches"][k] for k in NUSC_ENTRY_KERNELS) <= 0:
            fail(f"nuScenes entry request {rec['token']}: launches {rec['launches']}")
        log({"phase": "nusc_entry_request", **{k: (round(v, 3) if isinstance(v, float) else v)
                                               for k, v in rec.items()}})
    with open(out_json) as f:
        written = json.load(f)
    if written != res["results"] or len(written) != len(NUSC_ENTRY_SEEDS):
        fail("nuScenes entry: the written JSON differs from the returned results")
    for r in written:
        if not all(math.isfinite(x) for b in r["boxes"] for x in b + r["scores"]):
            fail(f"nuScenes entry: non-finite detections for {r['token']}")
    hold_detections("nuScenes entry request 0", written[0],
                    nusc_entry_direct(res["model"], tree, cfg))
    m = res["metrics"]
    if not (math.isfinite(m["mAP"]) and math.isfinite(m["NDS"])):
        fail(f"nuScenes entry: evaluate_detections gave mAP {m['mAP']}, NDS {m['NDS']}")
    per_request = {k: v / len(res["samples"]) for k, v in launches.items()}
    log({"phase": "nusc_entry_serve", "requests": len(res["samples"]), "mAP": m["mAP"],
         "NDS": m["NDS"], "launches_per_request": per_request,
         "peak_mem_mib": round(torch.cuda.max_memory_allocated() / 2**20, 1),
         "seconds": round(time.perf_counter() - t0, 3)})
    del res
    torch.cuda.empty_cache()
    return per_request


def nusc_entry_tta(cfg, tree: dict, workdir: str) -> dict:
    """``cli.test.run --tta`` on sample 0 with the default four-variant flip
    grid; the fusion's K3 call (the last ``nms_keep`` call: C = 10 over the
    union) held bitwise to its plain version and graph-timed beside its
    bound."""
    from fullysparsefusion_tpu_torch.cli import test as T
    from fullysparsefusion_tpu_torch.ops import nms

    t0 = time.perf_counter()
    args = T.parse_args(["--model", "fsf", "--tta", "--max-samples", "1", "--info-pkl",
                         tree["info"], "--data-root", os.path.dirname(tree["info"]),
                         "--mask-dir", tree["masks"], "--mask-downsample", str(NUSC_ENTRY_SCALE),
                         "--out", os.path.join(workdir, "tta.json")])
    calls = []
    with capture_calls(nms, "nms_keep", calls):
        res = T.run(cfg, args)
        launches = nms.nms_keep.launches
    (rec,) = res["samples"]
    call = calls[-1]
    c, n = call[1].shape
    if c != cfg.num_classes or n != rec["union"] or launches != len(calls):
        fail(f"nuScenes entry TTA: the fusion's K3 call is C = {c}, N = {n} over a union of "
             f"{rec['union']} ({launches} launches, {len(calls)} calls)")
    stats = replay_nms_keep(call, "nusc_entry_tta_kernel", union=n)
    del stats["flop"], stats["byte"]
    hold_bound("nuScenes entry TTA K3", stats["ms"], stats["bound_ms"])
    stats.update(C=c, N=n, launches=1)
    log({"phase": "nusc_entry_tta", "variants": 4, "union": rec["union"],
         "fused_detections": rec["detections"], "gpu_ms": round(rec["gpu_ms"], 3),
         "k3_launches": launches, "fusion_ms": stats["ms"], "fusion_bound_ms": stats["bound_ms"],
         "seconds": round(time.perf_counter() - t0, 3)})
    del res, calls
    torch.cuda.empty_cache()
    return stats


def nusc_entry_train(cfg, tree: dict, workdir: str, wrappers) -> dict:
    """``cli.train.run --model fsf`` (CBGS on, GT paste from the database)
    for 2 warm-up and 3 timed steps at batch 1, per step the host ms (read,
    paste, collate, masks, input), the phases' ms, peak MiB and launches;
    the step-5 checkpoint it writes; ``--resume`` for one more step, the
    restored parameters and optimizer state held bitwise to the saved ones;
    then ``cli.test.run --checkpoint`` on sample 0, its detections held
    bitwise to the trained model's own."""
    from fullysparsefusion_tpu_torch.cli import test as T
    from fullysparsefusion_tpu_torch.cli import train as TR
    from fullysparsefusion_tpu_torch.train import checkpoint as ckpt

    t0 = time.perf_counter()
    total = NUSC_ENTRY_WARMUP + NUSC_ENTRY_STEPS
    work = os.path.join(workdir, "work")
    argv = ["--model", "fsf", "--info-pkl", tree["info"], "--data-root",
            os.path.dirname(tree["info"]), "--mask-dir", tree["masks"], "--mask-downsample",
            str(NUSC_ENTRY_SCALE), "--gt-db", tree["db"], "--work-dir", work,
            "--log-interval", "1000"]
    zero(wrappers)
    out = TR.run(cfg, TR.parse_args(argv + ["--max-steps", str(total)]))
    launches = counts(wrappers)
    timed_steps = out["steps"][NUSC_ENTRY_WARMUP:]
    for rec in out["steps"]:
        if not all(math.isfinite(v) for v in rec["losses"].values()):
            fail(f"nuScenes entry train step {rec['step']}: non-finite losses")
        log({"phase": "nusc_entry_train_step", "step": rec["step"], "loss": rec["loss"],
             "paste": rec["paste"], "host_ms": {k: round(v, 3) for k, v in rec["host_ms"].items()},
             **{k: round(rec[k], 3) for k in ("forward_ms", "backward_ms", "optimizer_ms",
                                             "peak_mib")},
             "launches": rec["launches"]})
    per_step = {k: sum(r["launches"][k] for r in timed_steps) / NUSC_ENTRY_STEPS
                for k in launches}
    for k in ("gather_conv", "ccl_roots", "dw_per_tap"):
        if per_step[k] <= 0:
            fail(f"nuScenes entry train: kernel {k} was not launched")
    if sum(r["host_ms"]["paste"] for r in out["steps"]) <= 0:
        fail("nuScenes entry train: the GT sampler never ran")
    saved = ckpt.checkpoint_path(work, total)
    if ckpt.latest_checkpoint(work) != saved:
        fail(f"nuScenes entry train: latest checkpoint {ckpt.latest_checkpoint(work)}")
    model_state = {k: v.clone() for k, v in out["model"].state_dict().items()}
    opt_state = copy.deepcopy(out["opt"].state_dict())
    del out
    torch.cuda.empty_cache()

    restored = []
    load = ckpt.load_checkpoint

    def snapshot(path, model, opt):
        step = load(path, model, opt)
        restored.append((step, {k: v.clone() for k, v in model.state_dict().items()},
                         copy.deepcopy(opt.state_dict())))
        return step

    ckpt.load_checkpoint = snapshot
    try:
        out = TR.run(cfg, TR.parse_args(argv + ["--max-steps", str(total + 1), "--resume"]))
    finally:
        ckpt.load_checkpoint = load
    if len(restored) != 1 or restored[0][0] != total or out["start"] != total \
            or len(out["steps"]) != 1:
        fail(f"nuScenes entry resume: restored {[r[0] for r in restored]}, start {out['start']}")
    if not state_equal(model_state, restored[0][1]):
        fail("nuScenes entry resume: restored parameters differ from the saved ones")
    if not state_equal(opt_state, restored[0][2]):
        fail("nuScenes entry resume: restored optimizer state differs from the saved one")
    del model_state, opt_state, restored
    res = T.run(cfg, T.parse_args(["--model", "fsf", "--max-samples", "1", "--checkpoint",
                                   ckpt.checkpoint_path(work, total + 1), "--info-pkl",
                                   tree["info"], "--data-root", os.path.dirname(tree["info"]),
                                   "--mask-dir", tree["masks"], "--mask-downsample",
                                   str(NUSC_ENTRY_SCALE),
                                   "--out", os.path.join(workdir, "ckpt.json")]))
    hold_detections("nuScenes entry served from the checkpoint", res["results"][0],
                    nusc_entry_direct(out["model"], tree, cfg))
    mean = {k: sum(r[k] for r in timed_steps) / NUSC_ENTRY_STEPS
            for k in ("forward_ms", "backward_ms", "optimizer_ms")}
    host = {k: sum(r["host_ms"][k] for r in timed_steps) / NUSC_ENTRY_STEPS
            for k in timed_steps[0]["host_ms"]}
    log({"phase": "nusc_entry_train", "steps": NUSC_ENTRY_STEPS,
         "mean_ms": {k: round(v, 3) for k, v in mean.items()},
         "host_ms": {k: round(v, 3) for k, v in host.items()},
         "peak_mem_mib": round(max(r["peak_mib"] for r in timed_steps), 1),
         "launches_per_step": per_step, "resumed_step": total,
         "served_detections": len(res["results"][0]["scores"]),
         "seconds": round(time.perf_counter() - t0, 3)})
    del out, res
    torch.cuda.empty_cache()
    return per_step


def nusc_entry_phase(wrappers, root: str) -> dict:
    """Full-width nuScenes FSF at the bench capacities (random weights from
    seed 0) through the dataset entry points: the bench scenes written as an
    info tree under ``root``, served by the test CLI, with TTA, trained,
    resumed and served from the checkpoint by the train and test CLIs.
    Returns the launches and the tree."""
    t0 = time.perf_counter()
    cfg = bench_config()
    tree = nusc_entry_tree(root, cfg)
    per_request = nusc_entry_serve(cfg, tree, root, wrappers)
    tta = nusc_entry_tta(cfg, tree, root)
    per_step = nusc_entry_train(cfg, tree, root, wrappers)
    log({"phase": "nusc_entry_point", "seconds": round(time.perf_counter() - t0, 3)})
    return dict(per_request=per_request, train_per_step=per_step, tta=tta, tree=tree)

# -- reference configs and checkpoints ------------------------------------------------------

# the reconstructed reference config (tests/torch_reference_configs: the
# reference's own file is not in the repository)
REF_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                          "torch_reference_configs", "nuScenes", "FSF_nuScenes_config.py")
INTEROP_SEEDS = (0, 1, 2)
INTEROP_TRAIN_STEPS = 2
INTEROP_KERNELS = ("gather_conv", "ccl_roots", "nms_keep")
# the kernels' names in a profiler trace: K1, K2 (two kernels), K3 (two kernels)
TRACE_KERNELS = {"gather_conv": ("gather_conv_kernel",),
                 "ccl_roots": ("ccl_adjacency_bits", "ccl_union_find"),
                 "nms_keep": ("nms_mask_kernel", "nms_scan_kernel")}
# the program's spans of one FSF request (utils.profiling.span)
SERVING_SPANS = ("seg_core", "vfe", "sparse_unet", "seg_head", "camera_queries",
                 "lidar_queries", "foreground", "clustering", "fusion", "refine", "roi_points",
                 "decode")


def mib(path: str) -> float:
    return round(os.path.getsize(path) / 2**20, 1)


def save_reference_pth(path: str, sd: dict) -> None:
    """A state dict of NumPy arrays in mmcv's checkpoint layout."""
    torch.save({"meta": {"epoch": 6, "iter": 0, "config": os.path.basename(REF_CONFIG)},
                "state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)


def convert(what: str, argv: list) -> dict:
    """``cli.convert_checkpoint.main(argv)``; its report's counts logged."""
    from fullysparsefusion_tpu_torch.cli import convert_checkpoint as C

    t0 = time.perf_counter()
    out = C.main(argv)
    rec = {"phase": "interop_convert", "what": what, "seconds": round(time.perf_counter() - t0, 3)}
    if "report" in out:
        r = out["report"]
        rec.update(filled=r["filled"], total=r["total"], missing=len(r["missing"]),
                   unmapped=len(r["unmapped"]), mismatch=len(r["mismatch"]))
    else:
        rec.update(out)
    log(rec)
    return out


def hold_full_report(what: str, report: dict) -> None:
    if report["filled"] != report["total"] or report["missing"] or report["unmapped"] \
            or report["mismatch"]:
        fail(f"{what}: filled {report['filled']} of {report['total']}, missing "
             f"{report['missing'][:3]}, unmapped {report['unmapped'][:3]}, mismatch "
             f"{report['mismatch'][:3]}")


def config_differences(a, b, path="") -> list:
    """The fields (dotted paths) where two ``dataclasses.asdict`` trees differ."""
    if isinstance(a, dict) and isinstance(b, dict) and a.keys() == b.keys():
        return [d for k in a for d in config_differences(a[k], b[k], f"{path}.{k}")]
    return [] if (a == b and type(a) is type(b)) else [f"{path.lstrip('.')}: {a!r} != {b!r}"]


def interop_config():
    """``load_fsf_config`` on the reconstructed nuScenes file, field by field
    against ``nusc_fsf_config()``; the file's config at the bench
    capacities is then ``bench_config()``, which it returns."""
    from fullysparsefusion_tpu_torch.config import nusc_fsf_config
    from fullysparsefusion_tpu_torch.config_compat import load_fsf_config

    t0 = time.perf_counter()
    cfg = load_fsf_config(REF_CONFIG)
    diffs = config_differences(dataclasses.asdict(cfg), dataclasses.asdict(nusc_fsf_config()))
    if diffs:
        log({"phase": "interop_config", "differing_fields": diffs})
        fail(f"{REF_CONFIG} differs from nusc_fsf_config() in {len(diffs)} fields")
    want = bench_config()
    bench = load_fsf_config(REF_CONFIG, want.fsd.caps)
    bench = dataclasses.replace(bench, fsd=dataclasses.replace(
        bench.fsd, segmentor=dataclasses.replace(
            bench.fsd.segmentor,
            unet_stage_capacities=want.fsd.segmentor.unet_stage_capacities)))
    if bench != want:
        fail("the config file at the bench capacities is not bench_config()")
    log({"phase": "interop_config", "file": os.path.relpath(REF_CONFIG),
         "fields_held": len(list(_leaf_fields(dataclasses.asdict(cfg)))),
         "seconds": round(time.perf_counter() - t0, 3)})
    return bench


def _leaf_fields(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_fields(v, f"{path}.{k}")
    else:
        yield path


def interop_fsf(cfg, workdir: str, wrappers, main_per_request: dict):
    """The seeded full-width FSF's reference-layout state dict as an mmcv
    ``.pth``, converted by the CLI against the config file, loaded into a
    fresh FSF by ``load_jax_variables``: the bench requests of
    ``INTEROP_SEEDS`` bitwise the seeded model's detections, with the
    main path's launches per request; ``--export`` gives the state dict
    back bitwise. Returns the converted model and its launches per
    request."""
    from fullysparsefusion_tpu_torch.train import checkpoint as ckpt
    from fullysparsefusion_tpu_torch.train.torch_map import synthesize_state_dict
    from fullysparsefusion_tpu_torch.weights import build_fsf, to_jax_variables

    t0 = time.perf_counter()
    seeded = build_fsf(cfg, seed=0, device="cuda")
    sd = synthesize_state_dict(to_jax_variables(seeded), "fsf")
    pth, pkl, back = (os.path.join(workdir, n) for n in ("fsf.pth", "fsf_vars.pkl",
                                                          "fsf_export.pth"))
    save_reference_pth(pth, sd)
    log({"phase": "interop_fsf_checkpoint", "tensors": len(sd), "pth_mib": mib(pth),
         "seconds": round(time.perf_counter() - t0, 3)})
    report = convert("fsf", ["--pth", pth, "--model", "fsf", "--config", REF_CONFIG,
                             "--out", pkl])["report"]
    hold_full_report("FSF conversion", report)
    t1 = time.perf_counter()
    model = build_fsf(cfg, seed=1, device="cuda")
    ckpt.load_jax_variables(pkl, model)
    log({"phase": "interop_fsf_load", "pickle_mib": mib(pkl),
         "seconds": round(time.perf_counter() - t1, 3)})
    launches = []
    for seed in INTEROP_SEEDS:
        pb, cam = bench_request(seed, cfg)
        with torch.inference_mode():
            want = seeded.get_bboxes(seeded(pb, cam, 1), 1)
            torch.cuda.synchronize()
            zero(wrappers)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            got = model.get_bboxes(model(pb, cam, 1), 1)
            end.record()
        torch.cuda.synchronize()
        launches.append(counts(wrappers))
        for name, a, b in zip(got._fields, got, want):
            if not torch.equal(a, b):
                fail(f"FSF from the converted checkpoint, request seed {seed}: {name} differ")
        want_launches = {k: main_per_request[k] for k in INTEROP_KERNELS}
        if {k: launches[-1][k] for k in INTEROP_KERNELS} != want_launches:
            fail(f"FSF from the converted checkpoint, request seed {seed}: launches "
                 f"{launches[-1]}, the main path's {want_launches}")
        log({"phase": "interop_request", "seed": seed, "detections": int(got.valid.sum()),
             "gpu_ms": round(start.elapsed_time(end), 3), "launches": launches[-1],
             "bitwise_seeded": True})
    del seeded
    exported = convert("fsf export", ["--export", pkl, "--model", "fsf", "--out", back])
    again = torch.load(back, weights_only=True)["state_dict"]
    if list(again) != list(sd) or exported["exported"] != len(sd) or not all(
            np.array_equal(again[k].numpy(), v) for k, v in sd.items()):
        fail("--export did not give the written state dict back bitwise")
    log({"phase": "interop_fsf_export", "pth_mib": mib(back), "bitwise": True})
    per_request = {k: sum(n[k] for n in launches) / len(launches) for k in launches[0]}
    log({"phase": "interop_fsf", "requests": len(INTEROP_SEEDS),
         "launches_per_request": per_request, "seconds": round(time.perf_counter() - t0, 3)})
    return model, per_request


def interop_warm_start(cfg, tree: dict, workdir: str, wrappers, nusc_per_step: dict) -> None:
    """FSF's recipe: a seeded full-width FSD (at the reader's point width)
    written as an FSD-layout ``.pth``, converted against the FSF of the
    config file (the leaves FSF shares with FSD held bitwise), then
    ``cli.train.run`` with ``--config --init-from`` for
    ``INTEROP_TRAIN_STEPS`` steps on the nuScenes tree, given ``cfg`` (the
    file's config at the bench capacities, as the nuScenes entry point
    trains): the loaded state bitwise the conversion's, finite losses, the
    nuScenes entry point's launches per step."""
    import pickle

    from fullysparsefusion_tpu_torch.cli import common
    from fullysparsefusion_tpu_torch.cli import train as TR
    from fullysparsefusion_tpu_torch.train import checkpoint as ckpt
    from fullysparsefusion_tpu_torch.train.torch_map import synthesize_state_dict
    from fullysparsefusion_tpu_torch.weights import build_fsd, from_jax_variables, \
        to_jax_variables

    t0 = time.perf_counter()
    fsf_cfg = common.model_config(cfg, "fsf", common.READER_POINT_WIDTH)
    fsd_sd = synthesize_state_dict(to_jax_variables(build_fsd(fsf_cfg.fsd, seed=0,
                                                              device="cuda")), "fsd")
    pth, pkl = os.path.join(workdir, "fsd.pth"), os.path.join(workdir, "warm_vars.pkl")
    save_reference_pth(pth, fsd_sd)
    log({"phase": "interop_fsd_checkpoint", "tensors": len(fsd_sd), "pth_mib": mib(pth),
         "seconds": round(time.perf_counter() - t0, 3)})
    report = convert("fsd into fsf", ["--pth", pth, "--model", "fsf", "--config", REF_CONFIG,
                                      "--point-dim", str(fsf_cfg.fsd.segmentor.point_dim),
                                      "--out", pkl])["report"]
    if report["unmapped"] or report["mismatch"] or report["filled"] != len(fsd_sd):
        fail(f"FSD into FSF: {report['filled']} of {len(fsd_sd)} filled, unmapped "
             f"{report['unmapped'][:3]}, mismatch {report['mismatch'][:3]}")
    with open(pkl, "rb") as f:
        warm = pickle.load(f)
    as_fsf = synthesize_state_dict(warm, "fsf")
    shared = [k for k in fsd_sd if k in as_fsf]
    if len(shared) != len(fsd_sd) or not all(np.array_equal(as_fsf[k], fsd_sd[k])
                                             for k in shared):
        fail("FSD into FSF: a leaf FSF shares with FSD differs from the FSD's")
    log({"phase": "interop_warm_convert", "shared_leaves_bitwise": len(shared),
         "fsf_only_missing": len(report["missing"]), "unmapped": len(report["unmapped"]),
         "pickle_mib": mib(pkl)})

    loaded = []
    load = ckpt.load_jax_variables

    def snapshot(path, model):
        load(path, model)
        loaded.append({k: v.detach().cpu().clone() for k, v in model.state_dict().items()})

    args = TR.parse_args(["--config", REF_CONFIG, "--init-from", pkl, "--model", "fsf",
                          "--info-pkl", tree["info"], "--data-root", os.path.dirname(tree["info"]),
                          "--mask-dir", tree["masks"], "--mask-downsample", str(NUSC_ENTRY_SCALE),
                          "--work-dir", os.path.join(workdir, "work"),
                          "--max-steps", str(INTEROP_TRAIN_STEPS), "--log-interval", "1000"])
    ckpt.load_jax_variables = snapshot
    try:
        zero(wrappers)
        out = TR.run(cfg, args)
        launches = counts(wrappers)
    finally:
        ckpt.load_jax_variables = load
    want = from_jax_variables(warm)
    if len(loaded) != 1 or loaded[0].keys() != want.keys() or not all(
            torch.equal(loaded[0][k], v) for k, v in want.items()):
        fail("the train CLI's --init-from did not load the converted state bitwise")
    for rec in out["steps"]:
        if not all(math.isfinite(v) for v in rec["losses"].values()):
            fail(f"warm-started train step {rec['step']}: non-finite losses")
        log({"phase": "interop_train_step", "step": rec["step"], "loss": rec["loss"],
             **{k: round(rec[k], 3) for k in ("forward_ms", "backward_ms", "optimizer_ms",
                                             "peak_mib")},
             "host_ms": {k: round(v, 3) for k, v in rec["host_ms"].items()},
             "launches": rec["launches"]})
    per_step = {k: v / INTEROP_TRAIN_STEPS for k, v in launches.items()}
    for k in ("gather_conv", "dw_per_tap", "ccl_roots"):
        if per_step[k] != nusc_per_step[k]:
            fail(f"warm-started training launched {k} {per_step[k]} times a step, the "
                 f"nuScenes entry point {nusc_per_step[k]}")
    log({"phase": "interop_warm_start", "steps": INTEROP_TRAIN_STEPS,
         "launches_per_step": per_step, "seconds": round(time.perf_counter() - t0, 3)})
    del out
    torch.cuda.empty_cache()


def interop_htc(workdir: str, wrappers) -> None:
    """The seeded full HTC (DCN offsets drawn non-zero) as an HTC-layout
    ``.pth``, converted by the CLI, built strictly from the tree: one
    six-camera 900 x 1,600 sample's masks and anno table bitwise the seeded
    model's, K3 launched ``HTC_NMS_PER_CAMERA`` times a camera."""
    import pickle

    from fullysparsefusion_tpu_torch import generate_masks as gm
    from fullysparsefusion_tpu_torch.train.torch_map import synthesize_state_dict
    from fullysparsefusion_tpu_torch.weights import build_htc, to_jax_variables

    t0 = time.perf_counter()
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        seeded = htc_model(0)
        sd = synthesize_state_dict(to_jax_variables(seeded), "htc")
        seeded = seeded.cuda()
        pth, pkl = os.path.join(workdir, "htc.pth"), os.path.join(workdir, "htc_vars.pkl")
        save_reference_pth(pth, sd)
        log({"phase": "interop_htc_checkpoint", "tensors": len(sd), "pth_mib": mib(pth),
             "seconds": round(time.perf_counter() - t0, 3)})
        del sd
        hold_full_report("HTC conversion", convert("htc", ["--pth", pth, "--model", "htc",
                                                           "--out", pkl])["report"])
        with open(pkl, "rb") as f:
            model = build_htc(device="cuda", jax_variables=pickle.load(f))
        images = htc_images(0, HTC_CAMS, HTC_IMG_HW)
        want = gm.sample_masks(seeded, images, HTC_SCORE_THR, seeded.num_classes)
        torch.cuda.synchronize()
        zero(wrappers)
        t1 = time.perf_counter()
        got = gm.sample_masks(model, images, HTC_SCORE_THR, model.num_classes)
        sample_ms = (time.perf_counter() - t1) * 1e3
        launches = counts(wrappers)
    for name, a, b in zip(("planes", "anno"), got, want):
        if a.dtype != b.dtype or not np.array_equal(a, b):
            fail(f"HTC from the converted checkpoint: the sample's {name} differ")
    expect = {k: 0 for k in wrappers}
    expect["nms_keep"] = HTC_NMS_PER_CAMERA * HTC_CAMS
    if launches != expect:
        fail(f"HTC from the converted checkpoint: launches {launches}, expected {expect}")
    log({"phase": "interop_htc", "pickle_mib": mib(pkl), "sample_ms": round(sample_ms, 3),
         "painted_instances": int(got[1][:, 8].sum()), "launches": launches,
         "bitwise_seeded": True, "seconds": round(time.perf_counter() - t0, 3)})
    del seeded, model
    torch.cuda.empty_cache()


def interop_profile(model, cfg, workdir: str) -> None:
    """One FSF request under ``utils.profiling.device_trace``: the trace must
    name K1's, K2's and K3's CUDA kernels and carry every serving span of
    the program (``utils.profiling.span``), once each; their device ms."""
    from fullysparsefusion_tpu_torch.utils.profiling import device_trace, span

    t0 = time.perf_counter()
    pb, cam = bench_request(0, cfg)
    trace_dir = os.path.join(workdir, "trace")
    with device_trace(trace_dir) as tr, span("fsf_request"), torch.inference_mode():
        model.get_bboxes(model(pb, cam, 1), 1)
    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    found = {k: {n: sum(n in name for name in kernels) for n in names}
             for k, names in TRACE_KERNELS.items()}
    missing = [n for k in found for n, c in found[k].items() if c == 0]
    if missing:
        fail(f"the profiler trace names none of {missing} ({len(kernels)} kernel events)")
    annotations = [e.get("name") for e in events if e.get("cat") == "user_annotation"]
    lacking = [n for n in ("fsf_request",) + SERVING_SPANS if annotations.count(n) != 1]
    if lacking:
        fail(f"the profiler trace does not carry the spans {lacking} once each")
    summary = tr.summary()
    log({"phase": "interop_profile", "kernel_events": len(kernels), "trace_kernels": found,
         "span_ms": {k: round(v["device_ms"][0], 3) for k, v in summary.items()},
         "trace_mib": mib(os.path.join(trace_dir, "trace.json")),
         "seconds": round(time.perf_counter() - t0, 3)})


def reference_interop_phase(wrappers, tree: dict, root: str, main_per_request: dict,
                            nusc_per_step: dict) -> dict:
    """Reference configs and checkpoints on the card: the config file, FSF
    served from a converted reference-layout checkpoint, the FSD-pretrain
    warm start trained through the train CLI, HTC from a converted
    checkpoint, and one FSF request traced by the profiler. Returns the
    converted FSF's launches per request."""
    t0 = time.perf_counter()
    workdir = os.path.join(root, "interop")
    os.makedirs(workdir)
    cfg = interop_config()
    model, per_request = interop_fsf(cfg, workdir, wrappers, main_per_request)
    interop_profile(model, cfg, workdir)
    del model
    torch.cuda.empty_cache()
    interop_warm_start(cfg, tree, workdir, wrappers, nusc_per_step)
    interop_htc(workdir, wrappers)
    log({"phase": "reference_interop", "seconds": round(time.perf_counter() - t0, 3)})
    return per_request


# -- whole-model export ---------------------------------------------------------

EXPORT_SEEDS = (0, 1, 2)
# the exported program against the eager model: tests/test_export.py's bounds
EXPORT_RTOL, EXPORT_ATOL = 1e-5, 1e-6
REPO_ROOT = os.path.dirname(os.path.abspath(__file__))


def serving_call(module, inputs, wrappers) -> tuple:
    """(outputs on the CPU, gpu_ms by CUDA events, launches) of one call of
    an exported signature's forward, the counters zeroed just before."""
    torch.cuda.synchronize()
    zero(wrappers)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.inference_mode():
        start.record()
        out = module(*inputs)
        end.record()
    torch.cuda.synchronize()
    return [t.cpu() for t in out], start.elapsed_time(end), counts(wrappers)


def serve_fresh(pt2: str, requests: list, workdir: str, what: str) -> tuple:
    """``cli/serve_exported`` in a fresh process (it imports the op
    registration and no model module) on ``requests``, one more call of the
    first traced by the profiler: (each request's outputs, its report)."""
    from fullysparsefusion_tpu_torch.cli.serve_exported import request_dict

    paths = {n: os.path.join(workdir, f"{what}_{n}")
             for n in ("requests.pt", "outputs.pt", "report.json", "trace")}
    torch.save([{k: v.cpu() if torch.is_tensor(v) else v for k, v in request_dict(*r).items()}
                for r in requests], paths["requests.pt"])
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "fullysparsefusion_tpu_torch.cli.serve_exported",
         "--pt2", pt2, "--requests", paths["requests.pt"], "--out", paths["outputs.pt"],
         "--report", paths["report.json"], "--trace-dir", paths["trace"]],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        fail(f"serving the exported {what} in a fresh process: exit {proc.returncode}\n"
             f"{proc.stderr[-4000:]}")
    with open(paths["report.json"]) as f:
        report = json.load(f)
    report["process_seconds"] = time.perf_counter() - t0
    return torch.load(paths["outputs.pt"], weights_only=True), report


def graph_ops(program) -> dict:
    """The ``fsf::`` op calls of an exported program's graph, by op."""
    ops = {}
    for node in program.graph.nodes:
        if node.op == "call_function" and str(node.target).startswith("fsf."):
            ops[str(node.target)] = ops.get(str(node.target), 0) + 1
    return ops


def export_model(what: str, model, requests: list, workdir: str, wrappers,
                 main_per_request: dict) -> dict:
    """Export ``model``'s serving forward at batch 1 on the card, save the
    ``.pt2``, serve ``requests`` from it in a fresh process: each request's
    outputs held to the eager model's at ``EXPORT_RTOL`` / ``EXPORT_ATOL``
    (bitwise reported), its launches counted inside the ops equal to the
    eager forward's and to the main path's K1 and K2 with no K3, and the
    profiler trace's kernels equal to the counts. Returns the launches per
    exported request."""
    from fullysparsefusion_tpu_torch.cli import export_model as E

    pt2 = os.path.join(workdir, f"{what}.pt2")
    t0 = time.perf_counter()
    program = E.export(model, requests[0], batch_size=1)
    export_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    torch.export.save(program, pt2)
    save_s = time.perf_counter() - t1
    nodes, ops = len(program.graph.nodes), graph_ops(program)
    del program
    serving = E.serving_module(model, 1)
    serving_call(serving, requests[0], wrappers)          # warm, as the served program is
    eager = [serving_call(serving, r, wrappers) for r in requests]
    outputs, report = serve_fresh(pt2, requests, workdir, what)
    if report["model_modules"]:
        fail(f"serving the exported {what} imported {report['model_modules'][:3]}")
    want_launches = {"gather_conv": main_per_request["gather_conv"],
                     "ccl_roots": main_per_request["ccl_roots"], "nms_keep": 0, "dw_per_tap": 0}
    for seed, (want, eager_ms_, eager_launches), got, rec in zip(
            EXPORT_SEEDS, eager, outputs, report["requests"]):
        err, bitwise = 0.0, True
        for i, (g, w) in enumerate(zip(got, want)):
            if g.shape != w.shape or g.dtype != w.dtype:
                fail(f"exported {what}, request seed {seed}: output {i} is {tuple(g.shape)} "
                     f"{g.dtype}, eager {tuple(w.shape)} {w.dtype}")
            if not torch.isfinite(g).all():
                fail(f"exported {what}, request seed {seed}: output {i} not finite")
            over = (g - w).abs() > EXPORT_ATOL + EXPORT_RTOL * w.abs()
            if over.any():
                fail(f"exported {what}, request seed {seed}: output {i} differs from eager at "
                     f"{int(over.sum())} entries (max {float((g - w).abs().max()):.3g})")
            err = max(err, float((g - w).abs().max()))
            bitwise &= torch.equal(g, w)
        launches = {k: rec["launches"][k] for k in want_launches}
        if launches != {k: eager_launches[k] for k in want_launches} or launches != want_launches:
            fail(f"exported {what}, request seed {seed}: launches {launches}, eager "
                 f"{eager_launches}, expected {want_launches}")
        log({"phase": "export_request", "model": what, "seed": seed,
             "gpu_ms": round(rec["ms"], 3), "eager_gpu_ms": round(eager_ms_, 3),
             "launches": launches, "max_abs_err": err, "bitwise": bitwise})
    events = report["kernel_events"]
    trace = {k: {n: sum(c for name, c in events.items() if n in name) for n in names}
             for k, names in TRACE_KERNELS.items()}
    for k, found in trace.items():
        if any(c != want_launches[k] for c in found.values()):
            fail(f"exported {what}: the profiler trace has {found} of {k}, the ops counted "
                 f"{want_launches[k]}")
    log({"phase": "export_model", "model": what, "pt2_mib": mib(pt2),
         "export_seconds": round(export_s, 3), "save_seconds": round(save_s, 3),
         "load_seconds": round(report["load_seconds"], 3),
         "first_call_ms": round(report["first_call_ms"], 3),
         "process_seconds": round(report["process_seconds"], 3), "graph_nodes": nodes,
         "graph_ops": ops, "trace_kernels": trace, "requests": len(requests),
         "launches_per_request": want_launches})
    return want_launches


def export_cli(workdir: str) -> None:
    """``cli/export_model.py --config <the nuScenes file> --check`` as a
    subprocess on the card: FSF at the file's capacities, batch 2, exported,
    saved, loaded and held to the live model."""
    out = os.path.join(workdir, "fsf_config.pt2")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "fullysparsefusion_tpu_torch.cli.export_model",
         "--config", REF_CONFIG, "--out", out, "--check"],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=900)
    if proc.returncode != 0 or "artifact matches live model" not in proc.stdout:
        fail(f"cli.export_model --config --check: exit {proc.returncode}\n"
             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    log({"phase": "export_cli", "config": os.path.relpath(REF_CONFIG, REPO_ROOT),
         "output": proc.stdout.strip().splitlines()[-2:], "pt2_mib": mib(out),
         "seconds": round(time.perf_counter() - t0, 3)})


def export_phase(wrappers, root: str, main_per_request: dict) -> dict:
    """Whole-model export on the card: full-width FSF at ``bench_config()``
    and FSD at its ``fsd``, each exported at batch 1, saved and served from
    a fresh process on the bench requests of ``EXPORT_SEEDS``; then the
    export CLI on the reference config file. Returns each model's launches
    per exported request."""
    from fullysparsefusion_tpu_torch.weights import build_fsd, build_fsf

    t0 = time.perf_counter()
    workdir = os.path.join(root, "export")
    os.makedirs(workdir)
    cfg = bench_config()
    model = build_fsf(cfg, seed=0, device="cuda")
    per_request = {"fsf": export_model("fsf", model, [bench_request(s, cfg) for s in EXPORT_SEEDS],
                                       workdir, wrappers, main_per_request)}
    del model
    torch.cuda.empty_cache()
    model = build_fsd(cfg.fsd, seed=0, device="cuda")
    per_request["fsd"] = export_model("fsd", model, [(fsd_scene(s, cfg.fsd)[0],)
                                                     for s in EXPORT_SEEDS],
                                      workdir, wrappers, main_per_request)
    del model
    torch.cuda.empty_cache()
    export_cli(workdir)
    log({"phase": "export", "seconds": round(time.perf_counter() - t0, 3)})
    return per_request


# -- the offline tools ------------------------------------------------------------------

OFFLINE_FIXTURES = os.path.join(REPO_ROOT, "tests", "torch_offline_fixtures")
# the mask tool's score thresholds, tried in turn until a plane is painted
# (at random weights every class scores ~1/11: see HTC_SCORE_THR)
OFFLINE_SCORE_THRS = (0.3, 0.1, 0.05, 0.0)
# the AV2-shaped log: each sweep is the valid points of two AV2 bench scenes
OFFLINE_AV2_SWEEPS = ((0, 1), (1, 2), (2, 0))
OFFLINE_AV2_T0, OFFLINE_AV2_DT = 315969629019741000, 100_000_000
# AV2's annotation columns (av2.structures.cuboid), in its file order
OFFLINE_AV2_ANN_F32 = ("length_m", "width_m", "height_m", "qw", "qx", "qy", "qz", "tx_m", "ty_m",
                       "tz_m")


def sha256_array(a) -> str:
    """sha256 of an array's bytes, or of its strings joined by NUL (the
    digests of ``tests/torch_offline_fixtures/manifest.json``)."""
    import hashlib

    a = np.asarray(a)
    if a.dtype == object:
        return hashlib.sha256("\0".join(a).encode()).hexdigest()
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def refused(fn, path: str, what: str) -> str:
    """``fn(path)`` must raise a ``ValueError`` naming ``what``; returns it."""
    try:
        fn(path)
    except ValueError as e:
        if what not in str(e):
            fail(f"{os.path.basename(path)} raised {e!r}, which does not name {what}")
        return str(e)
    fail(f"{os.path.basename(path)} was read, but must be refused ({what})")


def offline_jpeg_fixtures(manifest: dict) -> None:
    """Every committed fixture JPEG through ``decode_jpeg``: shape and
    sha256 held to PIL's decode in the manifest (bitwise); the progressive
    one must raise."""
    from fullysparsefusion_tpu_torch.data.jpeg import decode_jpeg

    t0 = time.perf_counter()
    held, ms, refusals = 0, {}, []
    for group in ("jpeg", "cameras"):
        for name, entry in sorted(manifest[group].items()):
            path = os.path.join(OFFLINE_FIXTURES, name)
            if "port_raises" in entry:
                refusals.append(refused(decode_jpeg, path, entry["port_raises"]))
                continue
            t1 = time.perf_counter()
            img = decode_jpeg(path)
            ms[name] = round((time.perf_counter() - t1) * 1e3, 3)
            if list(img.shape) != entry["shape"] or sha256_array(img) != entry["sha256"]:
                fail(f"decode_jpeg({name}) is not PIL's decode (shape {img.shape})")
            held += 1
    log({"phase": "offline_jpeg", "held_bitwise": held, "refused": refusals,
         "camera_decode_ms": {k: v for k, v in ms.items() if k in manifest["cameras"]},
         "seconds": round(time.perf_counter() - t0, 3)})


def offline_masks(wrappers, tree: dict, root: str, manifest: dict, serve_per_request: dict) -> dict:
    """The mask tool at full HTC width from JPEGs on disk: the six committed
    900 x 1,600 camera JPEGs copied to each camera's ``data_path`` of the
    nuScenes entry tree, ``cli/generate_masks.py --backend htc`` (``build_htc``
    defaults, seed 0, ``--device cuda``, cuDNN deterministic) at the first
    of ``OFFLINE_SCORE_THRS`` that paints a plane, the counters zeroed just
    before each run and read just after (K3 12 times a sample, nothing
    else); the written tree bitwise ``sample_masks`` of the same model on
    the decoded images (which hold to the manifest), its PNG set the
    painted detections' planes; then ``cli/test.py --mask-dir`` serves FSF
    from it at ``--mask-downsample 2`` with the entry point's launches.
    Returns the launches per sample and per served request."""
    import pickle
    import shutil

    from fullysparsefusion_tpu_torch import generate_masks as gm
    from fullysparsefusion_tpu_torch.cli import generate_masks as G
    from fullysparsefusion_tpu_torch.cli import test as T
    from fullysparsefusion_tpu_torch.data.jpeg import load_sample_images
    from fullysparsefusion_tpu_torch.data.masks import load_sample_masks
    from fullysparsefusion_tpu_torch.data.nuscenes import ordered_cam_names

    t0 = time.perf_counter()
    data_root = os.path.dirname(tree["info"])
    with open(tree["info"], "rb") as f:
        infos = pickle.load(f)["infos"]
    for info in infos:
        for name, cam in info["cams"].items():
            dst = os.path.join(data_root, cam["data_path"])
            os.makedirs(os.path.dirname(dst), exist_ok=True)
            shutil.copyfile(os.path.join(OFFLINE_FIXTURES, f"{name}.jpg"), dst)
    out_dir = os.path.join(root, "htc_masks")
    built, load = [], G.load_htc

    def load_once(args, device):  # the CLI's model, built once across the thresholds
        if not built:
            built.append(load(args, device))
        return built[0]

    G.load_htc = load_once
    painted = {}
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                        allow_tf32=False):
            for thr in OFFLINE_SCORE_THRS:
                shutil.rmtree(out_dir, ignore_errors=True)
                zero(wrappers)
                recs = G.main(["--backend", "htc", "--info-pkl", tree["info"], "--data-root",
                               data_root, "--out-dir", out_dir, "--device", "cuda", "--seed", "0",
                               "--score-thr", str(thr)])
                launches = counts(wrappers)
                painted[thr] = sum(r["nonempty_planes"] for r in recs)
                if painted[thr]:
                    break
            if not painted[thr]:
                fail(f"the mask tool painted no plane at any threshold {OFFLINE_SCORE_THRS}")
            model = built[0]
            expect = {k: 0 for k in wrappers}
            expect["nms_keep"] = HTC_NMS_PER_CAMERA * HTC_CAMS * len(infos)
            if launches != expect:
                fail(f"the mask tool launched {launches}, expected {expect}")
            for info, rec in zip(infos, recs):
                if rec["launches"]["nms_keep"] != HTC_NMS_PER_CAMERA * HTC_CAMS:
                    fail(f"mask tool sample {rec['token']}: launches {rec['launches']}")
                images = load_sample_images(info, data_root)
                for c, name in enumerate(ordered_cam_names(info["cams"])):
                    if sha256_array(images[c]) != manifest["cameras"][f"{name}.jpg"]["sha256"]:
                        fail(f"mask tool sample {rec['token']}: camera {name} decodes differently")
                pasted, paste = [], gm.paste_detections
                gm.paste_detections = lambda *a: pasted.append(paste(*a)) or pasted[-1]
                try:
                    planes, anno = gm.sample_masks(model, images, thr, model.num_classes)
                finally:
                    gm.paste_detections = paste
                got, got_anno = load_sample_masks(out_dir, info["token"], HTC_CAMS,
                                                  model.num_classes, HTC_IMG_HW)
                if not (np.array_equal(got, planes) and np.array_equal(got_anno, anno)):
                    fail(f"mask tool sample {rec['token']}: the written tree is not sample_masks'")
                files = sorted(f for f in os.listdir(os.path.join(out_dir, info["token"]))
                               if f.endswith(".png"))
                if files != sorted(f"{c}_{k}.png" for c, k in gm.plane_keys(pasted[0])):
                    fail(f"mask tool sample {rec['token']}: PNG set {files}")
                log({"phase": "offline_mask_sample", "score_thr": thr,
                     **{k: (round(v, 3) if isinstance(v, float) else v) for k, v in rec.items()}})
    finally:
        G.load_htc = load
    parameters = sum(p.numel() for p in built[0].parameters())
    del built[:], model
    torch.cuda.empty_cache()
    log({"phase": "offline_masks", "samples": len(recs), "parameters": parameters,
         "painted_planes_per_threshold": {str(k): v for k, v in painted.items()},
         "score_thr": thr, "launches": launches,
         "mean_ms": {k: round(sum(r[k] for r in recs) / len(recs), 3)
                     for k in ("decode_ms", "gpu_ms", "paste_paint_ms", "write_ms")},
         "seconds": round(time.perf_counter() - t0, 3)})

    t1 = time.perf_counter()
    zero(wrappers)
    res = T.run(bench_config(), T.parse_args([
        "--model", "fsf", "--info-pkl", tree["info"], "--data-root", data_root, "--mask-dir",
        out_dir, "--mask-downsample", str(NUSC_ENTRY_SCALE), "--out",
        os.path.join(root, "htc_masks_detections.json")]))
    served = counts(wrappers)
    for rec in res["samples"]:
        if any(rec["launches"][k] != serve_per_request[k] for k in NUSC_ENTRY_KERNELS):
            fail(f"FSF on the mask tool's tree, {rec['token']}: launches {rec['launches']}, "
                 f"the entry point's {serve_per_request}")
        log({"phase": "offline_masks_request", **{k: (round(v, 3) if isinstance(v, float) else v)
                                                   for k, v in rec.items()}})
    for r in res["results"]:
        if not all(math.isfinite(x) for b in r["boxes"] for x in b + r["scores"]):
            fail(f"FSF on the mask tool's tree: non-finite detections for {r['token']}")
    per_request = {k: v / len(res["samples"]) for k, v in served.items()}
    log({"phase": "offline_masks_serve", "requests": len(res["samples"]),
         "detections": [len(r["scores"]) for r in res["results"]],
         "launches_per_request": per_request, "seconds": round(time.perf_counter() - t1, 3)})
    del res
    torch.cuda.empty_cache()
    return dict(per_sample={k: v / len(recs) for k, v in launches.items()},
                per_request=per_request)


def offline_av2(root: str, manifest: dict, av2: dict) -> None:
    """AV2 preparation at AV2's sizes: one log written by the port's Feather
    writer in AV2's schemas (three sweeps of float16 ``x, y, z``, uint8
    ``intensity`` and ``laser_number``, int32 ``offset_ns``, each the valid
    points of the two bench scenes of ``OFFLINE_AV2_SWEEPS``; their GT as
    ``annotations.feather``; ``city_SE3_egovehicle.feather`` of an ego at 10
    m/s turning at 0.3 rad/s, at every sweep and image timestamp; the
    calibration of ``cli/make_fake_av2.RingRig``, AV2's seven-camera ring
    layout; an empty ``.jpg`` per image, the cameras at 20 Hz off the
    sweeps), prepared by ``cli/prepare_av2.py``: each ``.bin`` bitwise the
    float16 -> float32 points and ``intensity / 255``, the boxes against
    the scenes', the frames read by ``AV2Reader``; the committed fixture
    feathers decoded against the manifest (the ZSTD one refused); the
    ``av2`` phase's detections through ``format_results`` and back through
    ``read_feather`` equal to their rows. Returns the log for ``av2_disk``."""
    from fullysparsefusion_tpu_torch.cli import make_fake_av2 as F
    from fullysparsefusion_tpu_torch.cli import prepare_av2 as P
    from fullysparsefusion_tpu_torch.config import AV2_CLASS_NAMES
    from fullysparsefusion_tpu_torch.data.av2 import (AV2Reader, boxes_to_av2_rows,
                                                      yaw_to_quat_wxyz)
    from fullysparsefusion_tpu_torch.data.feather import read_feather, write_feather

    t0 = time.perf_counter()
    split = os.path.join(root, "av2", "sensor")
    log_dir = os.path.join(split, "synthetic_log")
    lidar = os.path.join(log_dir, "sensors", "lidar")
    os.makedirs(lidar)
    rng = np.random.default_rng(0)
    stamps = [OFFLINE_AV2_T0 + k * OFFLINE_AV2_DT for k in range(len(OFFLINE_AV2_SWEEPS))]
    sweeps, write_ms, sizes, ann = {}, {}, {}, []
    for ts, seeds in zip(stamps, OFFLINE_AV2_SWEEPS):
        pts = np.concatenate([av2["sweeps"][s][0] for s in seeds])
        n = len(pts)
        cols = {"x": pts[:, 0].astype(np.float16), "y": pts[:, 1].astype(np.float16),
                "z": pts[:, 2].astype(np.float16),
                "intensity": np.clip(np.round(pts[:, 3] * 255), 0, 255).astype(np.uint8),
                "laser_number": rng.integers(0, 64, n).astype(np.uint8),
                "offset_ns": rng.integers(0, 10**8, n).astype(np.int32)}
        path = os.path.join(lidar, f"{ts}.feather")
        t1 = time.perf_counter()
        write_feather(cols, path)
        write_ms[ts] = round((time.perf_counter() - t1) * 1e3, 3)
        sizes[ts] = dict(rows=n, bytes=os.path.getsize(path))
        sweeps[ts] = cols
        for s in seeds:
            boxes, labels = av2["sweeps"][s][1:]
            ann += [(ts, b, int(c)) for b, c in zip(boxes, labels)]
    boxes = np.stack([b[:7] for _, b, _ in ann]).astype(np.float32)
    q = yaw_to_quat_wxyz(boxes[:, 6].astype(np.float64)).astype(np.float32)
    centre = dict(length_m=boxes[:, 3], width_m=boxes[:, 4], height_m=boxes[:, 5], qw=q[:, 0],
                  qx=q[:, 1], qy=q[:, 2], qz=q[:, 3], tx_m=boxes[:, 0], ty_m=boxes[:, 1],
                  tz_m=boxes[:, 2] + boxes[:, 5] / 2)
    ann_cols = {"timestamp_ns": np.array([t for t, _, _ in ann], np.int64),
                "track_uuid": np.array([f"track{i:04d}" for i in range(len(ann))], object),
                "category": np.array([AV2_CLASS_NAMES[c].upper() for _, _, c in ann], object),
                **{k: centre[k].astype(np.float32) for k in OFFLINE_AV2_ANN_F32},
                "num_interior_pts": np.zeros(len(ann), np.int64)}
    rig = F.RingRig()
    cam_stamps = F.camera_stamps(stamps)
    t1 = time.perf_counter()
    write_feather(ann_cols, os.path.join(log_dir, "annotations.feather"))
    F.write_poses(log_dir, np.concatenate([np.array(stamps, np.int64), *cam_stamps]))
    write_ms["annotations_and_pose"] = round((time.perf_counter() - t1) * 1e3, 3)
    F.write_rig(log_dir, rig)
    F.write_cameras(log_dir, cam_stamps)

    read_ms = {}
    for ts in stamps:
        t1 = time.perf_counter()
        back = read_feather(os.path.join(lidar, f"{ts}.feather"))
        read_ms[ts] = round((time.perf_counter() - t1) * 1e3, 3)
        if back.keys() != sweeps[ts].keys() or not all(
                back[k].dtype == v.dtype and np.array_equal(back[k], v)
                for k, v in sweeps[ts].items()):
            fail(f"read_feather of sweep {ts} differs from what write_feather wrote")
    ann_labels = np.array([c for _, _, c in ann])
    log_frames = {}
    t1 = time.perf_counter()
    info_path = os.path.join(root, "av2", "av2_infos.pkl")
    points_out = os.path.join(root, "av2", "points")
    infos = P.main(["--av2-root", split, "--out", info_path, "--points-out", points_out])
    prepare_s = time.perf_counter() - t1
    if [i["timestamp_ns"] for i in infos] != stamps:
        fail(f"prepare_av2 gave frames {[i['timestamp_ns'] for i in infos]}")
    frames = []
    reader = AV2Reader(info_path, os.path.dirname(points_out), AV2_CLASS_NAMES, training=False)
    for i, (info, ts) in enumerate(zip(infos, stamps)):
        c = sweeps[ts]
        want = np.stack([c["x"], c["y"], c["z"], c["intensity"] / 255.0], 1).astype(np.float32)
        got = np.fromfile(os.path.join(os.path.dirname(points_out), info["lidar_path"]),
                          np.float32).reshape(-1, 4)
        if not np.array_equal(got, want):
            fail(f"prepare_av2: {info['lidar_path']} is not the sweep's float32 points")
        sel = ann_cols["timestamp_ns"] == ts
        src = boxes[sel]
        gb = info["gt_boxes"]
        yaw_err = np.abs(np.angle(np.exp(1j * (gb[:, 6].astype(np.float64) - src[:, 6]))))
        if len(gb) != int(sel.sum()) or not np.array_equal(gb[:, [0, 1, 3, 4, 5]],
                                                         src[:, [0, 1, 3, 4, 5]]) \
                or np.abs(gb[:, 2] - src[:, 2]).max() > 1e-5 or yaw_err.max() > 1e-5:
            fail(f"prepare_av2: frame {ts}'s boxes differ from the scenes' GT")
        s = reader.sample(i)
        frames.append(dict(points=int(len(s["points"])), gt_written=int(sel.sum()),
                           gt_read=int(len(s["gt_labels"]))))
        log_frames[ts] = dict(points=got, boxes=src, labels=ann_labels[sel])
        if not len(s["points"]):
            fail(f"AV2Reader read no points of frame {ts}")

    fixtures, refusals = {}, []
    for name, entry in sorted(manifest["feather"].items()):
        path = os.path.join(OFFLINE_FIXTURES, name)
        if "port_raises" in entry:
            refusals.append(refused(read_feather, path, entry["port_raises"]))
            continue
        cols = read_feather(path)
        if {k: (str(v.dtype), sha256_array(v)) for k, v in cols.items()} != \
                {k: (e["dtype"], e["sha256"]) for k, e in entry["columns"].items()}:
            fail(f"read_feather({name}) differs from pandas' read in the manifest")
        fixtures[name] = len(next(iter(cols.values())))

    boxes_d, scores, labels, log_id, ts = av2["entry_dets"]
    out = reader.format_results([(boxes_d, scores, labels, log_id, ts)],
                                os.path.join(root, "av2", "detections.feather"))
    rows = boxes_to_av2_rows(boxes_d, scores, labels, AV2_CLASS_NAMES, log_id, ts)
    back = read_feather(out)
    if rows and (list(back) != list(rows[0]) or not all(
            back[k].tolist() == [r[k] for r in rows] for k in rows[0])):
        fail("format_results read back through read_feather differs from its rows")
    if len(rows) != (len(next(iter(back.values()))) if back else 0):
        fail(f"format_results wrote {len(back)} columns for {len(rows)} rows")
    log({"phase": "offline_av2", "sweeps": {str(k): v for k, v in sizes.items()},
         "write_ms": {str(k): v for k, v in write_ms.items()},
         "read_ms_per_sweep": {str(k): v for k, v in read_ms.items()},
         "annotation_rows": len(ann), "prepare_seconds": round(prepare_s, 3), "frames": frames,
         "bins_held_bitwise": len(infos), "fixtures_held": fixtures, "refused": refusals,
         "format_results_rows": len(rows), "detections_bytes": os.path.getsize(out),
         "seconds": round(time.perf_counter() - t0, 3)})
    return dict(split=split, log_id="synthetic_log", frames=log_frames, rig=rig,
                cam_stamps=cam_stamps, gt_read_plain=[f["gt_read"] for f in frames])


# the AV2 tree served from disk: masks painted at the cameras' native sizes,
# read at --mask-downsample 2 (the 775 x 1,024 grid of the AV2 bench's planes)
AV2_DISK_DOWNSAMPLE = 2
# a painted point covers a square of 2 r + 1 native pixels: the loader's
# nearest resize and downsample read a cell up to 3 source pixels before the
# point's own at downsample 2 (the front camera's resize)
AV2_DISK_RADIUS = 3
AV2_DISK_MIN_HIT_SHARE = 0.95
AV2_DISK_KERNELS = ("gather_conv", "ccl_roots", "nms_keep")


def av2_rig_hits(av2_log: dict, info: dict, frame: dict, painted: dict, xyz: np.ndarray, ids,
                 ids_uncompensated) -> dict:
    """Of one frame's in-box points (``xyz``: the request's valid points),
    those the rig sees (their own instance id at their true pixel, by the
    rig's geometry, in at least one camera) and of those the ones whose
    lookup slots (``ids`` [N, 2, cls], as the model's camera module got
    them; ``ids_uncompensated`` from the matrices without ego-motion
    compensation) hold an instance of their own class; and the points and
    in-box points inside three or more cameras' images by the prepared
    matrices and the cameras' native sizes."""
    from fullysparsefusion_tpu_torch.cli import make_fake_av2 as F
    from fullysparsefusion_tpu_torch.cli.prepare_av2 import RING_CAMERAS

    rig, ts = av2_log["rig"], info["timestamp_ns"]
    p64 = xyz.astype(np.float64)
    box = np.full(len(xyz), -1)
    for j, b in enumerate(frame["boxes"]):
        box[F.in_box(p64, b.astype(np.float64)) & (box < 0)] = j
    city = F.to_city(ts, p64)
    row_of = {(r["cam_id"], j): r["obj_id"] for r, j in zip(painted["rows"], painted["boxes"])}
    seen = np.zeros(len(xyz), bool)
    in_images = np.zeros(len(xyz), np.int64)
    for c, cam in enumerate(RING_CAMERAS):
        h, w = rig.hw(c)
        u, v, z = F.project(rig, c, info["cams"][cam]["timestamp_ns"], city)
        ok = (z > 1e-3) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
        px = np.where(ok, np.floor(u), 0).astype(np.int64)
        py = np.where(ok, np.floor(v), 0).astype(np.int64)
        own_of_box = np.array([row_of.get((c, j), -2) + 1 for j in range(len(frame["boxes"]))])
        own = np.where(box >= 0, own_of_box[np.maximum(box, 0)], -1)
        seen |= ok & (box >= 0) & (painted["ids"][c][py, px] == own)
        m = info["lidar2img"][c]
        q = p64 @ m[:3, :3].T + m[:3, 3]
        with np.errstate(divide="ignore", invalid="ignore"):
            qu, qv = q[:, 0] / q[:, 2], q[:, 1] / q[:, 2]
        in_images += (q[:, 2] > 1e-3) & (qu >= 0) & (qu < w) & (qv >= 0) & (qv < h)
    cls = frame["labels"][np.maximum(box, 0)]
    rows = np.arange(len(xyz))

    def hit(slots):
        return (slots[rows, :, cls] > 0).any(1)

    return dict(in_box=int((box >= 0).sum()), seen=int(seen.sum()),
                hits=int((seen & hit(ids)).sum()),
                hits_uncompensated=int((seen & hit(ids_uncompensated)).sum()),
                three_plus=int((in_images >= 3).sum()),
                three_plus_in_box=int(((in_images >= 3) & (box >= 0)).sum()))


def av2_disk(wrappers, root: str, av2_log: dict, model) -> dict:
    """FSF at AV2's full width served from a prepared tree on disk: the
    ``offline_av2`` log's frames get single-channel masks
    (``cli/make_fake_av2.paint_masks``: each GT box's interior points
    projected by the rig's own geometry at each camera's image timestamp,
    7 x 7 native pixels a point, farthest box first); ``cli/prepare_av2.py
    --fusion`` prepares the log (every frame's 96 GT boxes read back, the
    camera timestamps the nearest); ``cli/test.py --model fsf
    --eval-protocol av2 --eval`` serves it with the ``av2`` phase's model
    (the counters zeroed just before and read just after; per request the
    host's read / mask / input ms, ``gpu_ms``, detections, launches), its
    feather read back equal to its rows and its metrics finite; one
    request again, bitwise; every K1, K2 and K3 call of one request held
    to its plain version. The points' lookups are read from the model's
    camera module (``points_in_mask_compact``): of the in-box points the
    rig sees, the share with a hit of their own class must reach
    ``AV2_DISK_MIN_HIT_SHARE`` and beat the uncompensated chain's; the
    points in three or more cameras' images are counted."""
    from fullysparsefusion_tpu_torch.cli import make_fake_av2 as F
    from fullysparsefusion_tpu_torch.cli import prepare_av2 as P
    from fullysparsefusion_tpu_torch.cli import test as T
    from fullysparsefusion_tpu_torch.cli.common import (av2_grid_lidar2img, load_av2_masks,
                                                        point_batch)
    from fullysparsefusion_tpu_torch.config import AV2_CLASS_NAMES
    from fullysparsefusion_tpu_torch.data.av2 import AV2Reader, boxes_to_av2_rows
    from fullysparsefusion_tpu_torch.data.feather import read_feather
    from fullysparsefusion_tpu_torch.data.pipelines import collate_scene
    from fullysparsefusion_tpu_torch.models import camera
    from fullysparsefusion_tpu_torch.models.camera import CameraData

    t0 = time.perf_counter()
    device = next(model.parameters()).device
    rig, base = av2_log["rig"], os.path.join(root, "av2_disk")
    mask_dir = os.path.join(base, "masks")
    painted, paint_ms = {}, []
    for ts, fr in av2_log["frames"].items():
        t1 = time.perf_counter()
        t_cams = [P.nearest_stamp(st, ts) for st in av2_log["cam_stamps"]]
        painted[ts] = F.paint_masks(mask_dir, f"{av2_log['log_id']}_{ts}", fr["points"], fr["boxes"],
                                    fr["labels"], rig, ts, t_cams, AV2_DISK_RADIUS)
        paint_ms.append(round((time.perf_counter() - t1) * 1e3, 3))
    info_path = os.path.join(base, "av2_infos.pkl")
    t1 = time.perf_counter()
    infos = P.main(["--av2-root", av2_log["split"], "--out", info_path, "--points-out",
                    os.path.join(base, "points"), "--fusion"])
    prepare_s = time.perf_counter() - t1
    cfg = av2_config()
    reader = AV2Reader(info_path, base, AV2_CLASS_NAMES, training=False,
                       point_cloud_range=cfg.fsd.segmentor.point_cloud_range)
    gt_read = [int(len(reader.sample(i)["gt_labels"])) for i in range(len(infos))]
    gt_written = [len(fr["labels"]) for fr in av2_log["frames"].values()]
    if gt_read != gt_written:
        fail(f"av2_disk: prepare_av2 --fusion read back {gt_read} of {gt_written} GT boxes")
    for info in infos:
        for c, cam in enumerate(P.RING_CAMERAS):
            want = P.nearest_stamp(av2_log["cam_stamps"][c], info["timestamp_ns"])
            if info["cams"][cam]["timestamp_ns"] != want:
                fail(f"av2_disk: frame {info['timestamp_ns']} took {cam}'s image "
                     f"{info['cams'][cam]['timestamp_ns']}, not the nearest {want}")

    lookups = []
    orig = camera.points_in_mask_compact

    def recorder(xyz, batch_idx, lidar2img, masks, img_h, img_w, k=2):
        ids, scores = orig(xyz, batch_idx, lidar2img, masks, img_h, img_w, k)
        lookups.append(dict(xyz=xyz, batch_idx=batch_idx, masks=masks, hw=(img_h, img_w),
                            ids=ids))
        return ids, scores

    feather = os.path.join(base, "detections.feather")
    argv = ["--model", "fsf", "--eval-protocol", "av2", "--info-pkl", info_path, "--data-root",
            base, "--mask-dir", mask_dir, "--mask-downsample", str(AV2_DISK_DOWNSAMPLE)]
    torch.cuda.reset_peak_memory_stats()
    camera.points_in_mask_compact = recorder
    try:
        zero(wrappers)
        res = T.run(cfg, T.parse_args(argv + ["--eval", "--out", feather]), model=model)
        launches = counts(wrappers)
    finally:
        camera.points_in_mask_compact = orig
    for rec in res["samples"]:
        if min(rec["launches"][k] for k in AV2_DISK_KERNELS) <= 0:
            fail(f"av2_disk request {rec['token']}: launches {rec['launches']}")
        log_line = {k: (round(v, 3) if isinstance(v, float) else v) for k, v in rec.items()}
        log({"phase": "av2_disk_request", **log_line})
    for r in res["results"]:
        if not all(math.isfinite(x) for b in r["boxes"] for x in b + r["scores"]):
            fail(f"av2_disk: non-finite detections for {r['token']}")
    rows = [row for r in res["results"] for row in boxes_to_av2_rows(
        *T.av2_detections(r)[:3], AV2_CLASS_NAMES, r["log_id"], r["timestamp_ns"])]
    back = read_feather(feather)
    if not rows or list(back) != list(rows[0]) or not all(
            back[k].tolist() == [row[k] for row in rows] for k in rows[0]):
        fail("av2_disk: the feather read back differs from the detections' rows")
    m = res["metrics"]
    if not (math.isfinite(m["mAP"]) and math.isfinite(m["CDS"])):
        fail(f"av2_disk: evaluate_av2 gave mAP {m['mAP']}, CDS {m['CDS']}")
    again = T.run(cfg, T.parse_args(argv + ["--max-samples", "1", "--out",
                                            os.path.join(base, "again.feather")]), model=model)
    if again["results"][0] != res["results"][0]:
        fail("av2_disk: a repeated request changed its detections")

    hits = []
    for i, (info, lk) in enumerate(zip(infos, lookups)):
        ts = info["timestamp_ns"]
        n = len(reader.sample(i)["points"])
        front = info["cams"][P.RING_CAMERAS[0]]
        uncompensated = []
        for c in range(len(P.RING_CAMERAS)):
            uncompensated.append(P.build_lidar2img(
                np.eye(4), np.eye(4), np.linalg.inv(P.se3(rig.ego_R_cam(c), rig.ego_t_cam(c))),
                rig.intrinsics(c)))
        grid = (lk["hw"][0] * AV2_DISK_DOWNSAMPLE, lk["hw"][1] * AV2_DISK_DOWNSAMPLE)
        l2i = av2_grid_lidar2img(np.stack(uncompensated), (front["height_px"], front["width_px"]),
                                 grid, AV2_DISK_DOWNSAMPLE)
        with torch.inference_mode():
            ids_u, _ = orig(lk["xyz"], lk["batch_idx"], torch.as_tensor(l2i, device=device)[None],
                            lk["masks"], *lk["hw"])
        hits.append(av2_rig_hits(av2_log, info, av2_log["frames"][ts], painted[ts],
                                 lk["xyz"][:n].cpu().numpy(), lk["ids"][:n].cpu().numpy(),
                                 ids_u[:n].cpu().numpy()))
    seen = sum(h["seen"] for h in hits)
    share = sum(h["hits"] for h in hits) / seen
    share_u = sum(h["hits_uncompensated"] for h in hits) / seen
    if not (share >= AV2_DISK_MIN_HIT_SHARE and share_u < share):
        fail(f"av2_disk: hit share {share:.4f} (uncompensated {share_u:.4f}) of {seen} points; "
             f"at least {AV2_DISK_MIN_HIT_SHARE} and above the uncompensated chain's expected")

    s0 = reader.sample(0)
    front = infos[0]["cams"][P.RING_CAMERAS[0]]
    planes = load_av2_masks([s0], [(front["height_px"], front["width_px"])], mask_dir,
                            cfg.num_classes, T.av2_image_size(infos), AV2_DISK_DOWNSAMPLE)
    batch = collate_scene([s0], cfg.caps.points, cfg.caps.max_gt)
    stats = av2_check_kernels(model, (point_batch(batch, device),
                                      CameraData.build(*planes, device=device)),
                              phase="av2_disk_kernels")
    per_request = {k: v / len(res["samples"]) for k, v in launches.items()}
    log({"phase": "av2_disk", "frames": len(infos), "gt_read_fusion": gt_read,
         "gt_read_plain": av2_log["gt_read_plain"], "gt_written": gt_written,
         "anno_rows": [len(p["rows"]) for p in painted.values()], "paint_ms": paint_ms,
         "prepare_seconds": round(prepare_s, 3),
         **{f"{k}_per_request": [round(r[k], 3) for r in res["samples"]]
            for k in ("read_ms", "mask_ms", "input_ms", "gpu_ms")},
         "detections": [r["detections"] for r in res["samples"]],
         "launches_per_request": per_request, "in_box_points": [h["in_box"] for h in hits],
         "seen_points": [h["seen"] for h in hits], "hit_share": share,
         "hit_share_uncompensated": share_u,
         "points_in_3plus_cameras": [h["three_plus"] for h in hits],
         "in_box_points_in_3plus_cameras": [h["three_plus_in_box"] for h in hits],
         "points": [len(fr["points"]) for fr in av2_log["frames"].values()],
         "mAP": m["mAP"], "CDS": m["CDS"], "kernel_ms": {k: v["ms"] for k, v in stats.items()},
         "peak_mem_mib": round(torch.cuda.max_memory_allocated() / 2**20, 1),
         "seconds": round(time.perf_counter() - t0, 3)})
    del res, again, lookups
    torch.cuda.empty_cache()
    return per_request


def offline_tools_phase(wrappers, root: str, tree: dict, serve_per_request: dict,
                        av2: dict) -> dict:
    """The offline tools on the card's machine, with the port's own codecs:
    the fixture JPEGs, the mask tool at full HTC width over the nuScenes
    entry tree and FSF served from its masks, AV2 preparation and export,
    then FSF at AV2's width served from the prepared AV2 tree
    (``av2_disk``). Returns the mask tool's launches per sample, FSF's per
    request and ``av2_disk``'s per request."""
    t0 = time.perf_counter()
    with open(os.path.join(OFFLINE_FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    offline_jpeg_fixtures(manifest)
    launches = offline_masks(wrappers, tree, root, manifest, serve_per_request)
    av2_log = offline_av2(root, manifest, av2)
    log({"phase": "offline_tools", "seconds": round(time.perf_counter() - t0, 3)})
    launches["av2_disk"] = av2_disk(wrappers, root, av2_log, av2.pop("model"))
    return launches


# -- the training descent and the multi-node entry points ----------------------------------

# the JAX package's tools/train_descent.py defaults
DESCENT_STEPS, DESCENT_SCENES, DESCENT_LOG_EVERY = 120, 4, 20
# the first and last steps whose mean losses must fall
DESCENT_WINDOW = 20
# every step after the third within 2 % of the third's peak allocated MiB
DESCENT_MEM_STEP, DESCENT_MEM_RTOL = 3, 0.02
# launches per full-width FSF train step: K1 13 forward + 13 d_feats, K2 once,
# dw_per_tap 13, no decode
DESCENT_LAUNCHES = {"gather_conv": 26, "ccl_roots": 1, "nms_keep": 0, "dw_per_tap": 13,
                    "segment_sum": FSF_SEGMENT_SUMS}
MULTIHOST_STEPS = 3


def descent_phase(wrappers, out_path: str) -> dict:
    """``cli/train_descent.py`` at full width on the card: 120 AdamW steps
    (lr 1e-4, no lr multipliers) of FSF at ``bench_fsf_config(1)`` cycling
    the JAX tool's pool of four bench-scale scenes, the counters zeroed just
    before and read just after, the artifact written to ``out_path``. Every
    loss must be finite, the last step's loss below the first's and the mean
    of the last 20 below that of the first 20, every step after the third
    within 2 % of the third's peak allocated MiB, and every step's launches
    ``DESCENT_LAUNCHES``. Then one more step's backward K1 and
    ``dw_per_tap`` calls are held to their plain versions
    (``check_train_kernels``). Returns the launches per step."""
    from fullysparsefusion_tpu_torch.cli import train_descent as D

    t0 = time.perf_counter()
    zero(wrappers)
    res = D.run(D.parse_args(["--steps", str(DESCENT_STEPS), "--scenes", str(DESCENT_SCENES),
                              "--log-every", str(DESCENT_LOG_EVERY), "--out", out_path]))
    launches = counts(wrappers)
    art, steps = res["artifact"], res["artifact"]["per_step"]
    losses = [r["loss"] for r in steps]
    if not all(math.isfinite(v) for v in losses):
        fail(f"descent: non-finite loss at steps {[r['step'] for r in steps if not math.isfinite(r['loss'])]}")
    first = sum(losses[:DESCENT_WINDOW]) / DESCENT_WINDOW
    last = sum(losses[-DESCENT_WINDOW:]) / DESCENT_WINDOW
    if not (art["loss_last"] < art["loss_first"] and last < first):
        fail(f"descent: the loss did not fall: {art['loss_first']} -> {art['loss_last']}, "
             f"mean of the first {DESCENT_WINDOW} {first}, of the last {last}")
    ref = steps[DESCENT_MEM_STEP - 1]["peak_mib"]
    off = [(r["step"], round(r["peak_mib"], 1)) for r in steps[DESCENT_MEM_STEP:]
           if abs(r["peak_mib"] - ref) > DESCENT_MEM_RTOL * ref]
    if off:
        fail(f"descent: peak MiB of steps {off[:8]} off step {DESCENT_MEM_STEP}'s {ref:.1f} by "
             f"more than {DESCENT_MEM_RTOL:.0%}")
    bad = [(r["step"], r["launches"]) for r in steps if r["launches"] != DESCENT_LAUNCHES]
    if bad or launches != {k: v * DESCENT_STEPS for k, v in DESCENT_LAUNCHES.items()}:
        fail(f"descent: launches {bad[:4]} (expected {DESCENT_LAUNCHES} every step; total "
             f"{launches})")
    opt_ms = [r["optimizer_ms"] for r in steps]
    peaks = [r["peak_mib"] for r in steps]
    log({"phase": "descent", "steps": DESCENT_STEPS, "scenes": DESCENT_SCENES,
         "config": art["config"], "parameters": art["parameters"],
         "loss_first": art["loss_first"], "loss_last": art["loss_last"],
         f"loss_mean_first_{DESCENT_WINDOW}": first, f"loss_mean_last_{DESCENT_WINDOW}": last,
         "sec_per_step_steady": art["sec_per_step_steady"],
         "mean_ms": {k: round(sum(r[k] for r in steps[1:]) / (DESCENT_STEPS - 1), 3)
                     for k in ("forward_ms", "backward_ms", "optimizer_ms", "step_ms")},
         "peak_mib": {"step3": round(ref, 1), "min_after": round(min(peaks[DESCENT_MEM_STEP:]), 1),
                      "max_after": round(max(peaks[DESCENT_MEM_STEP:]), 1),
                      "per_scene": [round(v, 1) for v in peaks[DESCENT_MEM_STEP:
                                                               DESCENT_MEM_STEP + DESCENT_SCENES]]},
         "reserved_mib": {"first": round(steps[0]["reserved_mib"], 1),
                          "last": round(steps[-1]["reserved_mib"], 1)},
         "slowest_step": art["slowest_step"], "slowest_optimizer": art["slowest_optimizer"],
         "optimizer_ms_median": round(sorted(opt_ms)[len(opt_ms) // 2], 3),
         "optimizer_ms_first_8": [round(v, 3) for v in opt_ms[:8]],
         "launches_per_step": DESCENT_LAUNCHES, "card": art["card"],
         "artifact": os.path.basename(out_path),
         "seconds": round(time.perf_counter() - t0, 3)})
    for entry in art["log"]:
        log({"phase": "descent_log", **entry})
    pool = res["pool"]
    stats = check_train_kernels(res["model"], res["opt"], pool[DESCENT_STEPS % len(pool)],
                                DESCENT_STEPS, phase="descent_kernel_calls")
    log({"phase": "descent_kernels", "gather_conv_bwd_ms": round(stats["gather_conv_bwd"]["ms"], 4),
         "gather_conv_bwd_max_abs_err": stats["gather_conv_bwd"]["err"],
         "dw_per_tap_ms": round(stats["dw_per_tap"]["ms"], 4),
         "dw_per_tap_max_abs_err": stats["dw_per_tap"]["max_abs_err"]})
    del res, pool
    torch.cuda.empty_cache()
    return dict(DESCENT_LAUNCHES)


def torchrun(argv: list, what: str, env=None, timeout: float = 900.0) -> str:
    """``argv`` (a ``torch.distributed.run`` command or a launch script) in
    its own process group from the repository root; every process of the
    group is ended if it outlasts ``timeout``. Fails on a non-zero exit;
    returns the standard output."""
    import signal

    proc = subprocess.Popen(argv, cwd=REPO_ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        fail(f"{what}: still running after {timeout} s")
    if proc.returncode != 0:
        fail(f"{what}: exit {proc.returncode}\n{out[-2000:]}\n{err[-4000:]}")
    return out


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def multihost_phase(tree: dict, root: str) -> dict:
    """The ``--multihost`` entry points on the card over the nuScenes entry
    tree, at the CLIs' own full-width config: ``cli/train.py --multihost``
    under ``python -m torch.distributed.run --standalone --nproc-per-node 1``
    (NCCL through ``env://``) for 3 steps, its checkpoint's parameters and
    optimizer state and its log (rank 0's launches of each step included)
    bitwise those of the same run through ``cli/train.py`` in this process;
    then ``tools/launch_test_torch.sh`` (``--multihost --tmpdir``, one rank
    per card) serving that checkpoint, its JSON byte for byte, its metrics
    and its launches (rank 0's summary line, summed over the ranks) those
    of ``cli/test.py`` in this process. Returns the launched jobs' launches:
    per step (``train``, read from the job's log) and per request
    (``test``)."""
    from fullysparsefusion_tpu_torch.cli import test as T
    from fullysparsefusion_tpu_torch.cli import train as TR
    from fullysparsefusion_tpu_torch.cli.common import config_from_args
    from fullysparsefusion_tpu_torch.train import checkpoint as ckpt

    t0 = time.perf_counter()
    data = ["--info-pkl", tree["info"], "--data-root", os.path.dirname(tree["info"]),
            "--mask-dir", tree["masks"], "--mask-downsample", str(NUSC_ENTRY_SCALE)]
    train = ["--model", "fsf", *data, "--gt-db", tree["db"], "--max-steps", str(MULTIHOST_STEPS),
             "--log-interval", "1"]
    works = {k: os.path.join(root, f"multihost_{k}") for k in ("one", "torchrun")}
    t1 = time.perf_counter()
    stdout = torchrun([sys.executable, "-m", "torch.distributed.run", "--standalone",
                       "--nproc-per-node", "1", "-m", "fullysparsefusion_tpu_torch.cli.train",
                       "--multihost", *train, "--work-dir", works["torchrun"]],
                      "cli.train --multihost under torch.distributed.run")
    train_s = time.perf_counter() - t1
    args = TR.parse_args(train + ["--work-dir", works["one"]])
    TR.run(config_from_args(args), args)
    torch.cuda.empty_cache()
    path = {k: ckpt.checkpoint_path(w, MULTIHOST_STEPS) for k, w in works.items()}
    got, want = (torch.load(path[k], map_location="cpu", weights_only=True)
                 for k in ("torchrun", "one"))
    for key in ("model", "optimizer", "step"):
        if not state_equal(want[key], got[key]):
            fail(f"multihost train: the checkpoint's {key} differs from one process's")
    with open(os.path.join(works["torchrun"], "train_log.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    with open(os.path.join(works["one"], "train_log.jsonl")) as f:
        logged_one = [json.loads(line) for line in f]
    strip = lambda recs: [{k: v for k, v in r.items() if k != "sec_per_step"} for r in recs]  # noqa: E731
    if strip(logged) != strip(logged_one) or len(logged) != MULTIHOST_STEPS:
        fail("multihost train: the log differs from one process's")
    n_logged = stdout.count('"step": ')
    if n_logged != MULTIHOST_STEPS:
        fail(f"multihost train: rank 0 printed {n_logged} log lines")
    train_launches = logged[0]["launches"]
    if any(r["launches"] != train_launches for r in logged):
        fail(f"multihost train: launches differ between steps: {[r['launches'] for r in logged]}")
    for k in ("gather_conv", "ccl_roots", "dw_per_tap"):
        if train_launches[k] <= 0:
            fail(f"multihost train: kernel {k} was not launched in the job's steps")
    log({"phase": "multihost_train", "world_size": 1, "backend": "nccl", "steps": MULTIHOST_STEPS,
         "losses": [r["loss"] for r in logged], "checkpoint_bitwise": True,
         "checkpoint_mib": mib(path["one"]), "process_seconds": round(train_s, 3),
         "launches_per_step": train_launches})
    del got, want

    serve = ["--model", "fsf", *data[4:]]
    one_json, two_json = (os.path.join(root, f"multihost_{k}.json") for k in ("one", "torchrun"))
    shards = os.path.join(root, "multihost_shards")
    args = T.parse_args(["--config", REF_CONFIG, "--checkpoint", path["torchrun"], *data[:4],
                         "--eval", "--out", one_json, *serve])
    res = T.run(config_from_args(args), args)
    t1 = time.perf_counter()
    stdout = torchrun([os.path.join(REPO_ROOT, "tools", "launch_test_torch.sh"), REF_CONFIG,
                       path["torchrun"], tree["info"], os.path.dirname(tree["info"]), *serve,
                       "--tmpdir", shards, "--out", two_json],
                      "tools/launch_test_torch.sh (cli.test --multihost --tmpdir)",
                      env=dict(os.environ, MASTER_PORT=str(free_port())))
    test_s = time.perf_counter() - t1
    with open(one_json, "rb") as f, open(two_json, "rb") as g:
        if f.read() != g.read():
            fail("multihost test: the merged JSON differs from one process's")
    if sorted(os.listdir(shards)) != ["results_rank000.json"]:
        fail(f"multihost test: shard files {sorted(os.listdir(shards))}")
    if json.dumps(res["metrics"], indent=2) not in stdout:
        fail("multihost test: rank 0's metrics differ from one process's")
    (summary,) = [json.loads(line) for line in stdout.splitlines()
                  if line.startswith('{"samples": ')]
    n = len(res["results"])
    if summary["samples"] != n or summary["launches"] != res["launches"]:
        fail(f"multihost test: rank 0's summary {summary} against one process's "
             f"{n} samples, launches {res['launches']}")
    for k in NUSC_ENTRY_KERNELS:
        if summary["launches"][k] <= 0:
            fail(f"multihost test: kernel {k} was not launched in the job")
    test_launches = {k: v / n for k, v in summary["launches"].items()}
    log({"phase": "multihost_test", "world_size": 1, "samples": n,
         "detections": [len(r["scores"]) for r in res["results"]], "json_mib": mib(one_json),
         "json_byte_identical": True, "mAP": res["metrics"]["mAP"], "NDS": res["metrics"]["NDS"],
         "process_seconds": round(test_s, 3), "launches_per_request": test_launches})
    del res
    torch.cuda.empty_cache()
    log({"phase": "multihost", "seconds": round(time.perf_counter() - t0, 3)})
    return {"train": train_launches, "test": test_launches}


KERNEL_INFO = {
    "gather_conv": ("fullysparsefusion_tpu_torch/csrc/gather_conv.cu",
                    "fullysparsefusion_tpu/ops/pallas_kernels.py:366"),
    "ccl_roots": ("fullysparsefusion_tpu_torch/csrc/ccl.cu",
                  "fullysparsefusion_tpu/ops/pallas_kernels.py:70"),
    "nms_keep": ("fullysparsefusion_tpu_torch/csrc/nms.cu",
                 "fullysparsefusion_tpu/ops/pallas_kernels.py:511"),
    # no Pallas kernel: the JAX package's d_w is XLA's per-tap gather + matmul
    "dw_per_tap": ("fullysparsefusion_tpu_torch/csrc/gather_conv_dw.cu",
                   "fullysparsefusion_tpu/ops/sparse_conv.py:380"),
    # no Pallas kernel: the JAX package's segment sums are XLA's scatter-add
    "segment_sum": ("fullysparsefusion_tpu_torch/csrc/segment.cu",
                    "fullysparsefusion_tpu/ops/segment.py:221"),
}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Drive the PyTorch port on one NVIDIA GPU.")
    ap.add_argument("--descent-out", help="the descent phase's artifact (default: a temporary "
                                          "directory's, removed at the end)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    from fullysparsefusion_tpu_torch.ops import segment
    from fullysparsefusion_tpu_torch.weights import build_fsf

    # comparisons in f32 mean f32: no TF32 in cuBLAS or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    build_kernels()
    segment_totals = segment_sum_phase()
    small_reference_check()
    small_train_reference_check()
    small_fsd_reference_check()
    small_two_stage_reference_check()
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        small_htc_reference_check()

    cfg = bench_config()
    t0 = time.perf_counter()
    model = build_fsf(cfg, seed=0, device="cuda")
    requests = [(s, bench_request(s, cfg)) for s in REQUEST_SEEDS]
    torch.cuda.synchronize()
    log({"phase": "setup", "seconds": round(time.perf_counter() - t0, 3),
         "parameters": sum(p.numel() for p in model.parameters())})

    wrappers = kernel_wrappers()
    zero(wrappers)
    dets = serve(model, requests)
    launches = counts(wrappers)
    log({"phase": "main_path_launches", "requests": len(requests), **launches})
    main_per_request = {k: v / len(requests) for k, v in launches.items()}
    for name, n in launches.items():
        if n <= 0 and name != "dw_per_tap":
            fail(f"kernel {name} was not launched on the main path")
    first, again = dets[0], dets[-1]
    for name, a, b in zip(first._fields, first, again):
        if not torch.equal(a, b):
            fail(f"re-run of request seed 0 changed {name}")

    stats = check_kernels(model, requests[0][1])
    nusc_sums = stats.pop("segment_sum")
    del model, requests, dets
    torch.cuda.empty_cache()

    model, opt, batch = train_setup(cfg)
    train_launches, k1_per_step = train(model, opt, batch, wrappers)
    train_sums = []
    with capture_calls(segment.SegmentInfo, "sum", train_sums):
        train_stats = check_train_kernels(model, opt, batch, TRAIN_WARMUP + TRAIN_STEPS)
    train_sums = replay_request_sums(train_sums, "nuScenes train step's forward",
                                     "nusc_train_forward", "train_segment_sum")
    adversarial_dw_per_tap()
    stats["dw_per_tap"] = train_stats["dw_per_tap"]
    launches["dw_per_tap"] = train_launches["dw_per_tap"]
    with tempfile.TemporaryDirectory() as workdir:
        ddp_launches = ddp_world1(model, opt, batch, wrappers, TRAIN_WARMUP + TRAIN_STEPS + 1,
                                  workdir)
        del model, opt, batch
        torch.cuda.empty_cache()
        ddp_two_ranks(workdir)
    train_to_map(wrappers)
    fsd = fsd_phase(wrappers)
    two_stage = two_stage_phase(wrappers)
    sst_phase()
    htc = htc_phase(wrappers)
    av2 = av2_phase(wrappers)
    with tempfile.TemporaryDirectory() as root:
        nusc = nusc_entry_phase(wrappers, root)
        interop = reference_interop_phase(
            wrappers, nusc["tree"], root,
            main_per_request=main_per_request, nusc_per_step=nusc["train_per_step"])
        exported = export_phase(wrappers, root, main_per_request)
        offline = offline_tools_phase(wrappers, root, nusc["tree"], nusc["per_request"], av2)
        multihost = multihost_phase(nusc["tree"], root)
    with tempfile.TemporaryDirectory() as workdir:
        descent = descent_phase(wrappers, args.descent_out or
                                os.path.join(workdir, "h100_fsf_training_descent.json"))
    entries = []
    for name, st in stats.items():
        source, replaces = KERNEL_INFO[name]
        entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                 "launches": launches[name], "max_abs_err": st["max_abs_err"],
                 "ms": st["ms"], "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
                 "bound_by": st["bound_by"], "library_ms": None,
                 "train_launches_per_step": train_launches[name] / TRAIN_STEPS,
                 "sharded_launches_per_step": ddp_launches[name]}
        if name == "dw_per_tap":
            entry["bmm_ms"], entry["tile_fill"] = st["bmm_ms"], st["tile_fill"]
        if name == "gather_conv":
            entry["train_launches_per_step_by_pass"] = k1_per_step
            bwd = train_stats["gather_conv_bwd"]
            entry["train_backward"] = {"ms": bwd["ms"], "plain_ms": bwd["plain_ms"],
                                       "bound_ms": bwd["bound_ms"], "max_abs_err": bwd["err"]}
        fst = fsd["stats"][name]
        entry.update(fsd_launches_per_request=fsd["per_request"][name],
                     fsd_train_launches_per_step=fsd["train_per_step"][name],
                     fsd_sharded_launches_per_step=fsd["sharded_per_step"][name],
                     fsd={k: fst[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                              "bound_by") if k in fst})
        if name == "gather_conv":
            bwd = fst["train_backward"]
            entry["fsd"]["train_backward"] = {"ms": bwd["ms"], "plain_ms": bwd["plain_ms"],
                                              "bound_ms": bwd["bound_ms"],
                                              "max_abs_err": bwd["err"]}
        if name == "nms_keep":
            entry["fsd"]["per_task"] = fst["per_task"]
        tst = two_stage["stats"][name]
        entry.update(two_stage_launches_per_request=two_stage["per_request"][name],
                     two_stage_train_launches_per_step=two_stage["train_per_step"][name],
                     two_stage={k: tst[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                    "bound_by") if k in tst})
        if name == "gather_conv":
            bwd = tst["train_backward"]
            entry["two_stage"]["train_backward"] = {"ms": bwd["ms"], "plain_ms": bwd["plain_ms"],
                                                    "bound_ms": bwd["bound_ms"],
                                                    "max_abs_err": bwd["err"]}
        entry["htc_launches_per_request"] = htc["per_request"][name]
        if name == "nms_keep":
            entry["htc"] = htc["per_shape"]
        ast = av2["stats"][name]
        entry.update(av2_launches_per_request=av2["per_request"][name],
                     av2_train_launches_per_step=av2["train_per_step"][name],
                     av2={k: ast[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                              "bound_by") if k in ast})
        if name == "gather_conv":
            bwd = ast["train_backward"]
            entry["av2"]["train_backward"] = {"ms": bwd["ms"], "plain_ms": bwd["plain_ms"],
                                              "bound_ms": bwd["bound_ms"],
                                              "max_abs_err": bwd["err"]}
        entry.update(nusc_entry_launches_per_request=nusc["per_request"][name],
                     nusc_entry_train_launches_per_step=nusc["train_per_step"][name],
                     interop_launches_per_request=interop[name],
                     export_launches_per_request=exported["fsf"][name],
                     fsd_export_launches_per_request=exported["fsd"][name],
                     mask_tool_launches_per_sample=offline["per_sample"][name],
                     mask_tool_fsf_launches_per_request=offline["per_request"][name],
                     av2_disk_launches_per_request=offline["av2_disk"][name],
                     descent_launches_per_step=descent[name],
                     multihost_train_launches_per_step=multihost["train"][name],
                     multihost_test_launches_per_request=multihost["test"][name])
        if name == "nms_keep":
            entry["tta"] = nusc["tta"]
        entries.append(entry)
    source, replaces = KERNEL_INFO["segment_sum"]
    entries.append({"name": "segment_sum", "route": "cuda", "source": source,
                    "replaces": replaces, "launches": launches["segment_sum"],
                    "max_abs_err": 0.0, **{k: {m: round(v, 5) for m, v in t.items()}
                                           for k, t in segment_totals.items()},
                    "nusc_request": nusc_sums, "nusc_train_forward": train_sums,
                    "av2_request": av2["stats"]["segment_sum"],
                    "train_launches_per_step": train_launches["segment_sum"] / TRAIN_STEPS,
                    "av2_launches_per_request": av2["per_request"]["segment_sum"],
                    "av2_train_launches_per_step": av2["train_per_step"]["segment_sum"],
                    "descent_launches_per_step": descent["segment_sum"]})
    log({"phase": "total", "seconds": round(time.perf_counter() - t_start, 3)})
    log({"kernels": entries})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
