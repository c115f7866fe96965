"""What the metric readers under ``benchmark/metrics/`` share.

A reader is ``read(r) -> float | None`` over the readings of one run:

- ``r["mode"]``: ``serve`` or ``train``;
- ``r["window_s"]``, ``r["units"]``: the measured window's seconds and the
  frames or steps completed in it (host clock); ``r["latency_s"]``: each
  frame's latency; ``r["setup_s"]``: process start to the window's opening;
- ``r["trace"]``: :func:`trace.reduce` of the traced stretch, or None;
- ``r["spans"]``: ms per span name, one entry per call in the window;
- ``r["work"]``: the reference's work per unit of the traced stretch
  (:meth:`costs.WorkCount.totals`), or None.

A reader that finds nothing to read returns None, and the run leaves that
metric out of its line."""
from __future__ import annotations

import statistics
from typing import Iterable, Optional

from . import costs


def median(values) -> Optional[float]:
    values = list(values)
    return statistics.median(values) if values else None


def percentile(values, q: float) -> Optional[float]:
    """The ``q``-th percentile (0–100) by linear interpolation between
    closest ranks, over all values."""
    v = sorted(values)
    if not v:
        return None
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def kernel_seconds_per_unit(r, names: Iterable[str]) -> Optional[float]:
    """Device seconds per unit of the traced kernels whose name contains one
    of ``names``; None without a trace or where none ran."""
    t = r.get("trace")
    if not t or not t["units"]:
        return None
    names = tuple(names)
    us = sum(d for n, _, d in t["kernels"] if any(k in n for k in names))
    return us * 1e-6 / t["units"] if us > 0 else None


def span_ms(r, name: str, mode: str) -> Optional[float]:
    if r["mode"] != mode:
        return None
    return median(r.get("spans", {}).get(name, []))


def roofline(r, mode: str, kernels: Iterable[str], work_keys: Iterable[str]) -> Optional[float]:
    """100 × the least time of the work under ``work_keys`` over the device
    time of ``kernels``, per unit."""
    if r["mode"] != mode or not r.get("work"):
        return None
    t = kernel_seconds_per_unit(r, kernels)
    least = sum(r["work"][k] for k in work_keys)
    if t is None or least <= 0:
        return None
    return 100.0 * least / t


def mfu(r, mode: str) -> Optional[float]:
    """100 × the unit's counted operations over (the traced stretch's
    seconds per unit × the bf16 peak)."""
    t = r.get("trace")
    if r["mode"] != mode or not r.get("work") or not t or not t["units"]:
        return None
    return 100.0 * r["work"]["flop"] / (t["window_s"] / t["units"] * costs.PEAK_BF16)


def idle_share(r, mode: str) -> Optional[float]:
    t = r.get("trace")
    if r["mode"] != mode or not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def launches(r, mode: str) -> Optional[float]:
    t = r.get("trace")
    if r["mode"] != mode or not t or not t["units"]:
        return None
    return len(t["kernels"]) / t["units"]
