"""The trace reduction on a hand-made Chrome trace: the stretch, the union of
device intervals, launches, and idle gaps named by the innermost host op."""
import pytest

from benchmark.harness import readers, trace


def event(cat, name, ts, dur):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "ph": "X"}


TRACE = {"traceEvents": [
    event("user_annotation", trace.UNIT, 0, 100),
    event("user_annotation", trace.UNIT, 100, 100),
    event("cpu_op", "aten::outer", 0, 60),
    event("cpu_op", "aten::inner", 20, 25),    # 20-45, inside outer
    event("kernel", "k_a", 10, 20),          # 10-30
    event("kernel", "k_b", 25, 10),          # overlaps: union 10-35
    event("gpu_memcpy", "copy", 50, 10),     # 50-60
    event("kernel", "k_a", 150, 70),         # 150-220: past the last unit's end
    event("kernel", "k_old", -50, 20),       # before the stretch: left out
]}


def test_reduce_counts_the_union_and_names_the_gaps():
    r = trace.reduce(TRACE)
    assert r["units"] == 2
    assert r["window_s"] == pytest.approx(220e-6)          # 0 .. the last kernel's end
    assert r["busy_s"] == pytest.approx((25 + 10 + 70) * 1e-6)
    assert [k[0] for k in r["kernels"]] == ["k_a", "k_b", "k_a"]
    gaps = dict(r["idle_gaps"])
    assert gaps == pytest.approx({"aten::outer": 10e-6,               # 0-10
                                  "aten::inner": 15e-6,               # 35-50, mid 42.5
                                  "host outside any op": 90e-6})      # 60-150
    readings = {"mode": "serve", "trace": r}
    assert readers.launches(readings, "serve") == 1.5
    assert readers.idle_share(readings, "serve") == pytest.approx(100 * (1 - 105 / 220))
    assert readers.launches(readings, "train") is None


def test_no_device_operation_no_reading():
    assert trace.reduce({"traceEvents": [event("user_annotation", trace.UNIT, 0, 10)]}) is None
