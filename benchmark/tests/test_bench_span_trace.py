"""Launches, host syncs, device copies and idle time put down to the
program's spans, on a hand-made Chrome trace with nested spans."""
import pytest

from benchmark.harness import span_trace, trace
from benchmark.tests.test_bench_trace import TRACE, event


def call(name, ts, corr=None, cat="cuda_runtime"):
    e = event(cat, name, ts, 2)
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def device(cat, name, ts, dur, corr):
    return dict(event(cat, name, ts, dur), args={"correlation": corr})


SPANS = {"traceEvents": [
    event("user_annotation", trace.UNIT, 0, 100),
    event("user_annotation", trace.UNIT, 100, 100),
    event("user_annotation", "lidar_queries", 5, 80),         # 5-85
    event("user_annotation", "foreground", 10, 40),           # 10-50, inside lidar_queries
    event("user_annotation", "clustering", 20, 10),           # 20-30, inside foreground
    event("user_annotation", "decode", 110, 60),              # 110-170
    event("user_annotation", "Optimizer.step#AdamW.step", 180, 10),   # not the program's
    event("cpu_op", "aten::nonzero", 22, 6),
    call("cudaLaunchKernel", 12, 1),                          # foreground
    call("cudaLaunchKernel", 24, 2),                          # clustering
    call("cudaMemcpyAsync", 25, 3),                           # clustering
    call("cudaStreamSynchronize", 26),                        # clustering
    call("cuLaunchKernelEx", 60, 4, cat="cuda_driver"),       # lidar_queries
    call("cudaLaunchKernel", 120, 5),                         # decode
    call("cudaMemcpy", 130, 6),                               # decode: a sync and a copy
    call("cudaDeviceSynchronize", 185),                       # outside the program's spans
    call("cudaLaunchKernel", -30, 7),                         # before the stretch
    device("kernel", "k1", 14, 10, 1),                        # 14-24
    device("kernel", "k2", 30, 5, 2),                         # 30-35
    device("gpu_memcpy", "copy", 35, 5, 3),                   # 35-40
    device("kernel", "k3", 62, 20, 4),                        # 62-82
    device("kernel", "k4", 122, 8, 5),                        # 122-130
    device("gpu_memcpy", "copy", 131, 4, 6),                  # 131-135
    device("kernel", "k_old", -20, 25, 7),                    # 0-5 inside the stretch
]}


def test_launches_syncs_copies_and_idle_land_on_the_innermost_span():
    names = ("lidar_queries", "foreground", "clustering", "decode")
    got = span_trace.by_span(SPANS, names)
    # busy: 0-5, 14-24, 30-40, 62-82, 122-130, 131-135; the stretch ends at 200
    # idle (µs), by midpoint: 5-14 at 9.5 lidar_queries (foreground opens at
    # 10); 24-30 at 27 clustering; 40-62 at 51 lidar_queries; 82-122 at 102
    # outside; 130-131 decode; 135-200 at 167.5 decode
    want = {
        "foreground": dict(launches=1, syncs=0, copies=0, idle_ms=0.0),
        "clustering": dict(launches=1, syncs=1, copies=1, idle_ms=6e-3),
        "lidar_queries": dict(launches=1, syncs=0, copies=0, idle_ms=31e-3),
        "decode": dict(launches=1, syncs=1, copies=1, idle_ms=66e-3),
        span_trace.OUTSIDE: dict(launches=0, syncs=1, copies=0, idle_ms=40e-3),
    }
    assert set(got) == set(want)
    for name, row in want.items():     # per unit: two units
        assert got[name] == pytest.approx({k: v / 2 for k, v in row.items()}), name
    total_idle = sum(r["idle_ms"] for r in got.values()) * 2
    r = trace.reduce(SPANS)
    assert total_idle * 1e-3 == pytest.approx(r["window_s"] - r["busy_s"])


def test_every_annotation_is_a_span_by_default_and_no_unit_no_reading():
    got = span_trace.by_span(SPANS)
    assert got["Optimizer.step#AdamW.step"]["syncs"] == 0.5
    assert span_trace.OUTSIDE not in got or got[span_trace.OUTSIDE]["syncs"] == 0
    assert span_trace.by_span({"traceEvents": [event("user_annotation", "decode", 0, 9)]}) is None


def test_a_trace_without_program_spans_puts_its_idle_time_outside():
    assert span_trace.by_span(TRACE) == {
        span_trace.OUTSIDE: dict(launches=0, syncs=0, copies=0, idle_ms=pytest.approx(115e-3 / 2))}
