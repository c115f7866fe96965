"""One run of one cell as ``run.py`` makes it, with the program's span
tracing (``utils.profiling.tracing``) open over the measured window.

    python3 benchmark/program_spans.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Standard output holds ``run.py``'s result line, then one more JSON line:
``program_spans`` (per span in the order it first opened: its parent, calls
per unit, and the medians of its device ms (CUDA events), host ms and host
self ms), ``harness_spans`` (the medians of the benchmark's own spans),
``latency_ms`` (serving: the median frame latency), ``top_level_share``
(serving: the top-level spans' device-ms medians summed over that latency)
and, with ``--trace 1``, ``span_trace``: :func:`harness.span_trace.by_span`
of the traced stretch, per unit. Standard error has the per-span table.
Run beside ``run.py`` on the same seed with ``--trace 0``, it measures what
the spans cost."""
import time

T_START = time.perf_counter()

import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def install(state):
    """Patch the harness's window, stretch and measure so that the program's
    spans record over the window and the traced stretch is also read by
    span; what they find goes into ``state``. Returns the undo."""
    from benchmark.harness import cell as cells, span_trace, trace as tracing
    from fullysparsefusion_tpu_torch.utils import profiling

    window, measure = cells._window, cells.measure

    def traced_window(*a, **k):
        with profiling.tracing() as tr:
            out = window(*a, **k)
        state["summary"] = tr.summary()
        return out

    class Stretch(cells.Stretch):
        def finish(self):
            if self.prof is not None:
                raw = tracing.export(self.prof)
                state["span_trace"] = span_trace.by_span(raw, state.get("summary", {}))
                self.result = tracing.reduce(raw)
                self.prof = None
            return self.result

    def kept_measure(*a, **k):
        res, readings = measure(*a, **k)
        state["readings"] = readings
        return res, readings

    cells._window, cells.Stretch, cells.measure = traced_window, Stretch, kept_measure

    def undo():
        cells._window, cells.Stretch, cells.measure = window, Stretch.__base__, measure

    return undo


def report(state) -> dict:
    r = state["readings"]
    units = max(r["units"], 1)
    spans = {}
    for name, s in state.get("summary", {}).items():
        spans[name] = dict(parent=s["parent"], calls=len(s["host_ms"]) / units,
                           **{k: statistics.median(s[k]) if s[k] else None
                              for k in ("device_ms", "host_ms", "self_ms")})
    out = dict(program_spans=spans,
               harness_spans={k: statistics.median(v) for k, v in r.get("spans", {}).items() if v})
    if r["mode"] == "serve" and r["latency_s"]:
        lat = statistics.median(r["latency_s"]) * 1e3
        top = sum(s["device_ms"] or 0.0 for s in spans.values() if s["parent"] is None)
        out.update(latency_ms=lat, top_level_share=top / lat)
    if state.get("span_trace") is not None:
        out["span_trace"] = state["span_trace"]
    return out


def table(out: dict) -> str:
    rows = ["span | parent | calls/unit | device ms | host self ms | launches | syncs | copies"
            " | idle ms (per unit)"]
    st = out.get("span_trace") or {}
    for name, s in list(out["program_spans"].items()) + [(n, None) for n in st
                                                          if n not in out["program_spans"]]:
        t = st.get(name, {})
        cells = [name, s and s["parent"], s and round(s["calls"], 2),
                 s and s["device_ms"] and round(s["device_ms"], 3),
                 s and round(s["self_ms"], 3)]
        cells += [round(t[k], 3) if k in t else "" for k in ("launches", "syncs", "copies",
                                                              "idle_ms")]
        rows.append(" | ".join("" if c is None else str(c) for c in cells))
    return "\n".join(rows)


def main(argv=None) -> int:
    sys.path.insert(0, ROOT)
    from benchmark import run as bench

    bench.T_START = T_START
    state = {}
    install(state)
    rc = bench.main(argv)
    if rc != 0 or "readings" not in state:
        return rc
    out = report(state)
    print(table(out), file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
