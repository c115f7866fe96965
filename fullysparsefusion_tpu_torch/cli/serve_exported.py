"""Serve an exported ``.pt2`` (``cli/export_model.py``) with no model code.

It imports ``ops.library`` (the kernels as ``fsf::`` ops, the input
containers as pytree nodes) and no module of ``models``: it loads the
program, runs each request of a requests file on it (after one untimed
call), and writes the outputs and a JSON report (load seconds; the first
call's ms; per request its ms, by CUDA events on the card, and the kernels'
launches; the ``models`` modules that were imported, which must be none).

    python -m fullysparsefusion_tpu_torch.cli.serve_exported --pt2 fsf.pt2 \
        --requests requests.pt --out outputs.pt --report report.json

A requests file is ``torch.save`` of a list of :func:`request_dict`; the
outputs file is the list of each request's output tensors, on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional

import torch

from ..ops.library import kernel_launches, launches_since
from ..utils.containers import CameraData, PointBatch

PORT = __name__.split(".")[0]


def request_dict(pb: PointBatch, cam: Optional[CameraData] = None) -> Dict:
    """One request's inputs as a dict of tensors and ints (what
    ``torch.load(weights_only=True)`` reads back); no ``cam`` for FSD."""
    d = {"points": pb.points, "batch_idx": pb.batch_idx, "valid": pb.valid}
    if cam is not None:
        d.update(masks=cam.masks, anno=cam.anno, lidar2img=cam.lidar2img, img_h=cam.img_h,
                 img_w=cam.img_w)
    return d


def request_inputs(d: Dict, device) -> tuple:
    """The program's inputs of :func:`request_dict`'s ``d`` on ``device``."""
    pb = PointBatch(*(d[k].to(device) for k in ("points", "batch_idx", "valid")))
    if "masks" not in d:
        return (pb,)
    return pb, CameraData(*(d[k].to(device) for k in ("masks", "anno", "lidar2img")),
                          img_h=d["img_h"], img_w=d["img_w"])


def timed_call(module, inputs, device):
    """(outputs, ms) of one call: CUDA events on the card, the host clock on
    the CPU."""
    with torch.inference_mode():
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = module(*inputs)
            end.record()
            end.synchronize()
            return out, start.elapsed_time(end)
        t0 = time.perf_counter()
        out = module(*inputs)
        return out, (time.perf_counter() - t0) * 1e3


def kernel_events(module, inputs, trace_dir: str) -> Dict[str, int]:
    """Each CUDA kernel's launches in a profiler trace of one call, by name."""
    from ..utils.profiling import device_trace

    with device_trace(trace_dir), torch.inference_mode():
        module(*inputs)
    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    found: Dict[str, int] = {}
    for e in events:
        if e.get("cat") == "kernel":
            found[e["name"]] = found.get(e["name"], 0) + 1
    return found


def serve(pt2: str, requests: List[Dict], device, trace_dir: Optional[str] = None) -> tuple:
    """Load ``pt2``, run the first request once (its ms is the report's
    ``first_call_ms``: the process's first call, cold), then every request.
    Returns (each request's outputs on the CPU, the report)."""
    t0 = time.perf_counter()
    module = torch.export.load(pt2).module()
    report: Dict = {"load_seconds": time.perf_counter() - t0, "requests": []}
    report["first_call_ms"] = timed_call(module, request_inputs(requests[0], device), device)[1]
    outputs = []
    for d in requests:
        inputs = request_inputs(d, device)
        before = kernel_launches()
        out, ms = timed_call(module, inputs, device)
        outputs.append([t.cpu() for t in out])
        report["requests"].append({"ms": ms, "launches": launches_since(before)})
    if trace_dir:
        report["kernel_events"] = kernel_events(module, request_inputs(requests[0], device),
                                                trace_dir)
    report["model_modules"] = sorted(m for m in sys.modules if m.startswith(f"{PORT}.models"))
    return outputs, report


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pt2", required=True, help="the exported program")
    ap.add_argument("--requests", required=True, help="torch.save'd list of request dicts")
    ap.add_argument("--out", required=True, help="where to torch.save the outputs")
    ap.add_argument("--report", help="where to write the JSON report (default: print it)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--trace-dir", help="trace one more call of the first request here and "
                                        "count its CUDA kernels by name")
    return ap.parse_args(argv)


def main(argv=None) -> Dict:
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to serve on the CPU")
    requests = torch.load(args.requests, weights_only=True)
    outputs, report = serve(args.pt2, requests, device, args.trace_dir)
    torch.save(outputs, args.out)
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f)
    else:
        print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
