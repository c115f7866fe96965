#!/usr/bin/env python3
"""Drive the PyTorch port (``fullysparsefusion_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, on a machine with a CUDA GPU

Phases, each of which ends the script with a non-zero exit on failure:

1. build the CUDA kernels from ``fullysparsefusion_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together);
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
   reversed chain, one component of all N nodes, N = 1,000 and 8,192,
   coincident points, mixed batch ids, all invalid), each timed.

The last lines are a ``{"kernels": [...]}`` JSON object, the card's name and
power limit from ``nvidia-smi``, and ``{"ok": true, "device": {...}}``.
Without a CUDA device the script exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import copy
import functools
import json
import subprocess
import sys
import time

import torch

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 outside
# the tensor cores, HBM3 bandwidth. Used only for the bound column.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# bench-scale capacities (the JAX package's bench.py, batch 1)
BENCH_CAPS = dict(
    points=131072, voxels=57344, prevox=65536, fg_per_group=4096,
    cluster_voxels_per_group=1024, clusters=1024, max_gt=128,
    frustum_points=16384, frustum_objects=256, roi_points=32768, max_roi_points=512,
)
BENCH_STAGE_CAPS = (57344, 40960, 24576, 8192, 2560)
REQUEST_SEEDS = (0, 1, 2, 0)

# K1 tolerance: bf16 products are exact in f32, so kernel and plain version
# differ only in the order of the f32 sums (27 taps x Cin terms)
K1_RTOL = 1e-4
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


def build_kernels():
    from fullysparsefusion_tpu_torch import kernels

    t0 = time.perf_counter()
    per = kernels.build_all()
    log({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
         "per_source_seconds": {k: round(v, 3) for k, v in per.items()}})


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
    from fullysparsefusion_tpu_torch.config import (
        Capacities, FSDConfig, FSFConfig, VoteSegmentorConfig)

    seg = VoteSegmentorConfig(unet_stage_capacities=BENCH_STAGE_CAPS)
    return FSFConfig(fsd=FSDConfig(caps=Capacities(**BENCH_CAPS), segmentor=seg))


def bench_request(seed: int, cfg, device="cuda"):
    """One bench-scale request on ``device``: the JAX package bench's scene."""
    from fullysparsefusion_tpu_torch import synthetic as S

    sc = S.make_lidar_scene_arrays(seed=seed, n_cap=cfg.caps.points, max_gt=cfg.caps.max_gt,
                                   n_boxes=32, extent=48.0)
    cam = S.make_camera_arrays(sc["gt_boxes"], sc["gt_labels"], sc["gt_valid"], batch_size=1,
                               num_cams=cfg.num_cams, num_classes=cfg.num_classes,
                               img_h=450, img_w=800, max_anno=250, fx=400.0)
    return S.fsf_inputs(sc, cam, device=device)


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
                   ("random", 1, 8192), ("coincident", 6, 1024), ("mixed_batch", 6, 1024),
                   ("all_invalid", 6, 1024))


def adversarial_ccl_roots():
    """K2 on the inputs that are hard for a sweep-based CCL (the reversed
    chain: one sweep per hop; one component of all N nodes), N off the word
    and at the wrapper's largest, complete graphs, batch ids that split them
    and all-invalid nodes: bitwise against the plain version, each timed."""
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
    log({"phase": "kernel_adversarial", "kernel": "ccl_roots", "tolerance": 0,
         "cases": cases})


def check_kernels(model, request):
    """Replay every kernel call of one request against its plain version."""
    from fullysparsefusion_tpu_torch.ops import ccl, nms, sparse_conv

    calls = {"gather_conv": [], "ccl_roots": [], "nms_keep": []}
    with capture_calls(sparse_conv, "gather_conv", calls["gather_conv"]), \
            capture_calls(ccl, "ccl_roots", calls["ccl_roots"]), \
            capture_calls(nms, "nms_keep", calls["nms_keep"]):
        model.get_bboxes(model(*request, 1), 1)
    torch.cuda.synchronize()
    results = {}

    # K1: gather conv, every conv of the frame's gather path, with its plan
    rows_out, tot = [], dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, err=0.0, flop=0.0, byte=0.0)
    for feats, rows, w, plan in calls["gather_conv"]:
        err = check_gather_conv(feats, rows, w, plan)
        n_src, cin = feats.shape
        k3, n_out = rows.shape
        cout = w.shape[2]
        hits = int((rows < n_src).sum())
        flop = 2.0 * hits * cin * cout
        byte = 2.0 * n_src * cin + 4.0 * k3 * n_out + 2.0 * k3 * cin * cout + 4.0 * n_out * cout
        ms = time_ms(lambda: sparse_conv.gather_conv(feats, rows, w, plan), 20)
        eager = eager_ms(lambda: sparse_conv.gather_conv(feats, rows, w, plan), 20)
        plain_ms = eager_ms(lambda: sparse_conv.gather_conv_plain(feats, rows, w), 5)
        bound = max(flop / PEAK_BF16_FLOPS, byte / PEAK_BYTES) * 1e3
        taps = tile_taps(plan, k3)
        rows_out.append({"n_src": n_src, "n_out": n_out, "cin": cin, "cout": cout, "hits": hits,
                         "hit_share": round(hits / (k3 * n_out), 4),
                         "taps_per_tile": round(float(taps.float().mean()), 3),
                         "all_miss_tiles": int((taps == 0).sum()), "tiles": int(taps.numel()),
                         "ms": round(ms, 4), "eager_ms": round(eager, 4),
                         "plain_ms": round(plain_ms, 4),
                         "bound_ms": round(bound, 5), "max_abs_err": err})
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound), ("flop", flop),
                     ("byte", byte)):
            tot[k] += v
        tot["err"] = max(tot["err"], err)
    log({"phase": "kernel_calls", "kernel": "gather_conv", "calls": rows_out})
    adversarial_gather_conv(*calls["gather_conv"][0][:3])
    results["gather_conv"] = dict(
        max_abs_err=tot["err"], ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
        bound_by="operations" if tot["flop"] / PEAK_BF16_FLOPS > tot["byte"] / PEAK_BYTES
        else "bytes")

    # K2: CCL roots (bitwise)
    (xy, batch, valid), = calls["ccl_roots"]
    got, sweeps = check_ccl_roots(xy, batch, valid, "the request's call")
    g, n = valid.shape
    same = (batch[:, :, None] == batch[:, None, :]) & valid[:, :, None] & valid[:, None, :]
    flop = 5.0 * float(same.sum())       # one distance test per valid same-batch pair
    byte = g * n * (8 + 4 + 1 + 4)
    bound = max(flop / PEAK_F32_FLOPS, byte / PEAK_BYTES) * 1e3
    call = functools.partial(ccl.ccl_roots, xy, batch, valid)
    results["ccl_roots"] = dict(
        max_abs_err=0.0, ms=time_ms(call, 20),
        plain_ms=eager_ms(lambda: ccl.ccl_roots_plain(xy, batch, valid), 3), bound_ms=bound,
        bound_by="operations" if flop / PEAK_F32_FLOPS > byte / PEAK_BYTES else "bytes")
    log({"phase": "kernel_calls", "kernel": "ccl_roots", "G": g, "N": n,
         "valid_per_problem": valid.sum(1).tolist(), "components": components(got),
         "plain_sweeps": sweeps, "ms": round(results["ccl_roots"]["ms"], 5),
         "eager_ms": round(eager_ms(call, 20), 5)})
    adversarial_ccl_roots()

    # K3: NMS keep masks (bitwise)
    (iou, order, vs, thr), = calls["nms_keep"]
    got = nms.nms_keep(iou, order, vs, thr)
    ref = nms.nms_keep_plain(iou, order, vs, thr)
    if not torch.equal(got, ref):
        fail(f"nms_keep differs from its plain version at {int((got != ref).sum())} rows")
    c, n = order.shape
    pos = torch.arange(n, device=got.device)
    flop = float(((n - 1 - pos)[None, :] * got).sum())   # one compare per later row, per kept row
    byte = 4.0 * n * n + c * n * (4 + 1 + 1)
    bound = max(flop / PEAK_F32_FLOPS, byte / PEAK_BYTES) * 1e3
    call = functools.partial(nms.nms_keep, iou, order, vs, thr)
    results["nms_keep"] = dict(
        max_abs_err=0.0, ms=time_ms(call, 20),
        plain_ms=eager_ms(lambda: nms.nms_keep_plain(iou, order, vs, thr), 3), bound_ms=bound,
        bound_by="operations" if flop / PEAK_F32_FLOPS > byte / PEAK_BYTES else "bytes")
    log({"phase": "kernel_calls", "kernel": "nms_keep", "C": c, "N": n,
         "kept": int(got.sum()), "valid": int(vs.sum()),
         "ms": round(results["nms_keep"]["ms"], 5), "eager_ms": round(eager_ms(call, 20), 5)})
    return results


KERNEL_INFO = {
    "gather_conv": ("fullysparsefusion_tpu_torch/csrc/gather_conv.cu",
                    "fullysparsefusion_tpu/ops/pallas_kernels.py:366"),
    "ccl_roots": ("fullysparsefusion_tpu_torch/csrc/ccl.cu",
                  "fullysparsefusion_tpu/ops/pallas_kernels.py:70"),
    "nms_keep": ("fullysparsefusion_tpu_torch/csrc/nms.cu",
                 "fullysparsefusion_tpu/ops/pallas_kernels.py:511"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    from fullysparsefusion_tpu_torch.ops import ccl, nms, sparse_conv
    from fullysparsefusion_tpu_torch.weights import build_fsf

    # comparisons in f32 mean f32: no TF32 in cuBLAS or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    build_kernels()
    small_reference_check()

    cfg = bench_config()
    t0 = time.perf_counter()
    model = build_fsf(cfg, seed=0, device="cuda")
    requests = [(s, bench_request(s, cfg)) for s in REQUEST_SEEDS]
    torch.cuda.synchronize()
    log({"phase": "setup", "seconds": round(time.perf_counter() - t0, 3),
         "parameters": sum(p.numel() for p in model.parameters())})

    wrappers = {"gather_conv": sparse_conv.gather_conv, "ccl_roots": ccl.ccl_roots,
                "nms_keep": nms.nms_keep}
    for fn in wrappers.values():
        fn.launches = 0
    dets = serve(model, requests)
    launches = {name: fn.launches for name, fn in wrappers.items()}
    log({"phase": "main_path_launches", "requests": len(requests), **launches})
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")
    first, again = dets[0], dets[-1]
    for name, a, b in zip(first._fields, first, again):
        if not torch.equal(a, b):
            fail(f"re-run of request seed 0 changed {name}")

    stats = check_kernels(model, requests[0][1])
    entries = []
    for name, st in stats.items():
        source, replaces = KERNEL_INFO[name]
        entries.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[name], "max_abs_err": st["max_abs_err"],
                        "ms": st["ms"], "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
                        "bound_by": st["bound_by"], "library_ms": None})
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
