"""The device trace of a bounded stretch of the window (``torch.profiler``,
CUDA activity through CUPTI), reduced to what the per-layer metrics read.

The profiler is started after the window's first unit (a frame or a step)
and stopped after ``traced_units`` more, each inside a ``bench_unit``
marker; the stretch runs from the first marked unit's start on the host to
the later of the last one's end and the last device operation.
Busy time is the union of the device operations' intervals (kernels,
copies, fills) inside it. An idle gap is named by the innermost host
operation that was running at its midpoint."""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


UNIT = "bench_unit"


def profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def warm_up(fn) -> None:
    """One profile of ``fn()`` in set-up, thrown away: the first profile of a
    process pays CUPTI's start-up, which the measured stretch must not."""
    with profiler():
        fn()


def unit():
    """The marker around each unit of the stretch."""
    from torch.profiler import record_function

    return record_function(UNIT)


def export(prof) -> dict:
    """The profiler's Chrome trace, read back (through a file under the
    temporary directory, removed at once)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)
    finally:
        os.remove(path)


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def reduce(trace: dict) -> Dict:
    """``{"window_s", "busy_s", "units", "kernels": [(name, ts, dur) µs],
    "device_ops": [[name, s]] top 10, "idle_gaps": [[host op, s]] top 10}``
    of a stretch, or None where the trace holds no device operation."""
    ev = trace.get("traceEvents", [])
    steps = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in ev
                   if e.get("name") == UNIT and e.get("cat") == "user_annotation" and "dur" in e)
    dev = [e for e in ev if e.get("cat") in DEVICE_CATS and "dur" in e]
    if not steps or not dev:
        return None
    lo = steps[0][0]
    dev = [e for e in dev if e["ts"] + e["dur"] > lo]
    if not dev:
        return None
    hi = max(steps[-1][1], max(e["ts"] + e["dur"] for e in dev))
    busy = _merge([(max(e["ts"], lo), min(e["ts"] + e["dur"], hi)) for e in dev])
    busy_us = sum(b - a for a, b in busy)
    by_name: Dict[str, float] = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    cpu = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in ev
                 if e.get("cat") in ("cpu_op", "user_annotation") and "dur" in e
                 and e.get("name") != UNIT)
    starts = [c[0] for c in cpu]
    gaps: Dict[str, float] = {}
    edges = [(lo, lo)] + busy + [(hi, hi)]
    for (_, a), (b, _) in zip(edges[:-1], edges[1:]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        name = "host outside any op"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 400, -1), -1):
            if cpu[j][1] >= mid:
                name = cpu[j][2]
                break
        gaps[name] = gaps.get(name, 0.0) + (b - a)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return dict(window_s=(hi - lo) * 1e-6, busy_s=busy_us * 1e-6, units=len(steps),
                kernels=[(e["name"], e["ts"], e["dur"]) for e in dev if e.get("cat") == "kernel"],
                device_ops=[[n, v * 1e-6] for n, v in top],
                idle_gaps=[[n, v * 1e-6] for n, v in top_gaps])
