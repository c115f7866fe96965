"""``program_spans.py`` on a tiny cell on the CPU: the program's spans
record over the harness's window, and the run's result is still
``run.py``'s."""
from benchmark import program_spans
from benchmark.tests import tiny

TOP = ["seg_core", "seg_head", "camera_queries", "lidar_queries", "fusion", "refine", "decode"]


def test_program_spans_over_a_tiny_serving_window(tmp_path):
    root = tiny.make_checkout(str(tmp_path))
    state = {}
    undo = program_spans.install(state)
    try:
        res = tiny.run(root, "tiny.stream")
    finally:
        undo()
    assert res["correct"] and res["attempted"] >= 1
    out = program_spans.report(state)
    spans = out["program_spans"]
    assert [k for k, s in spans.items() if s["parent"] is None] == TOP
    assert spans["clustering"]["parent"] == "foreground"
    assert all(s["calls"] == 1 and s["host_ms"] > 0 and s["device_ms"] is None
               for s in spans.values())
    assert out["latency_ms"] > 0 and "span_trace" not in out
    assert program_spans.table(out).count("\n") == len(spans)
