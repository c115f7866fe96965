"""A device trace's launches, host syncs, device copies and idle time, put
down to the program's spans (``utils.profiling.span``: ``user_annotation``
events on the host, on the clock of the trace's kernels).

Over the traced stretch that :func:`trace.reduce` reads, each is given to
the innermost span open on the host at its moment, or to ``OUTSIDE``:

- a launch: a kernel event, at the host call that launched it
  (``cuda_runtime`` or ``cuda_driver``, matched by ``args.correlation``);
- a device copy: a ``gpu_memcpy`` event, likewise;
- a host sync: a host call that blocks until the card is done
  (``SYNC_CALLS``), at its start;
- idle time: a gap of :func:`trace.reduce`'s busy union, at its midpoint.

Counts and idle ms are per unit (frame or step) of the stretch."""
from __future__ import annotations

import bisect
from typing import Dict, Iterable, Optional

from .trace import DEVICE_CATS, UNIT, _merge

HOST_CALL_CATS = ("cuda_runtime", "cuda_driver")
SYNC_CALLS = frozenset((
    "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy",
    "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize"))
OUTSIDE = "outside program spans"


def by_span(trace: dict, names: Optional[Iterable[str]] = None) -> Optional[Dict[str, Dict]]:
    """``{span name: {"launches", "syncs", "copies", "idle_ms"}}`` per unit,
    with ``OUTSIDE`` for what no span holds; ``names`` (default: every
    ``user_annotation`` but the unit marker) are the spans. None where the
    trace has no unit marker."""
    ev = trace.get("traceEvents", [])
    units = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in ev
                   if e.get("name") == UNIT and e.get("cat") == "user_annotation" and "dur" in e)
    if not units:
        return None
    keep = None if names is None else set(names)
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in ev
                   if e.get("cat") == "user_annotation" and "dur" in e and e["name"] != UNIT
                   and (keep is None or e["name"] in keep))
    starts = [s[0] for s in spans]

    def innermost(t: float) -> str:
        for j in range(bisect.bisect_right(starts, t) - 1, -1, -1):
            if spans[j][1] >= t:
                return spans[j][2]
        return OUTSIDE

    lo, host_hi = units[0][0], units[-1][1]
    rows: Dict[str, Dict[str, float]] = {}

    def add(name: str, key: str, v: float = 1) -> None:
        row = rows.setdefault(name, dict(launches=0, syncs=0, copies=0, idle_ms=0.0))
        row[key] += v

    calls = {}
    for e in ev:
        if e.get("cat") not in HOST_CALL_CATS or not lo <= e["ts"] <= host_hi:
            continue
        corr = e.get("args", {}).get("correlation")
        if corr is not None:
            calls[corr] = e["ts"]
        if e.get("name") in SYNC_CALLS:
            add(innermost(e["ts"]), "syncs")
    dev = [e for e in ev if e.get("cat") in DEVICE_CATS and "dur" in e
           and e["ts"] + e["dur"] > lo]
    for e in dev:
        at = calls.get(e.get("args", {}).get("correlation"))
        if at is not None and e["cat"] in ("kernel", "gpu_memcpy"):
            add(innermost(at), "launches" if e["cat"] == "kernel" else "copies")
    if dev:
        hi = max(host_hi, max(e["ts"] + e["dur"] for e in dev))
        busy = _merge([(max(e["ts"], lo), min(e["ts"] + e["dur"], hi)) for e in dev])
        edges = [(lo, lo)] + busy + [(hi, hi)]
        for (_, a), (b, _) in zip(edges[:-1], edges[1:]):
            if b > a:
                add(innermost(0.5 * (a + b)), "idle_ms", (b - a) * 1e-3)
    n = len(units)
    return {name: {k: v / n for k, v in row.items()} for name, row in rows.items()}
