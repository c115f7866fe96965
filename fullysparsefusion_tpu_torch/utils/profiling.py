"""Spans of the program's phases, and a ``torch.profiler`` trace of a block.

:func:`span` marks a phase where it runs (``with span("refine"): ...``).
With tracing off, the default, it returns one shared null context and does
nothing else. Inside ``with tracing() as tr:`` each span

- enters ``torch.profiler.record_function(name)``, so that it lands in an
  active profiler trace as a ``user_annotation`` on the clock of the
  trace's kernels;
- records a CUDA event pair on the current stream where CUDA is in use
  (initialised when tracing starts);
- reads ``time.perf_counter_ns()`` at both ends;
- keeps its parent, the innermost span open when it opened.

Spans stay in memory; :meth:`Tracer.summary` synchronises once, after the
work, and gives each name's calls. :func:`device_trace` records the host and
the card with ``torch.profiler`` inside :func:`tracing`, so its Chrome trace
carries the spans. Spans are meant for one thread; ``torch.export`` runs
with tracing off.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import torch

_NULL = contextlib.nullcontext()
_active: Optional["Tracer"] = None


def span(name: str):
    """A context manager around one phase named ``name`` (recorded only
    inside :func:`tracing`)."""
    tr = _active
    if tr is None:
        return _NULL
    return _Span(tr, name)


class _Span:
    __slots__ = ("tracer", "name", "parent", "scope", "events", "t0", "t1", "child_ns")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer, self.name = tracer, name
        self.events = None
        self.child_ns = 0

    def __enter__(self):
        tr = self.tracer
        self.parent = tr.open[-1] if tr.open else None
        tr.open.append(self)
        tr.spans.append(self)
        self.scope = torch.profiler.record_function(self.name)
        self.scope.__enter__()
        if tr.cuda:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.events is not None:
            self.events[1].record()
        self.scope.__exit__(*exc)
        tr = self.tracer
        tr.open.pop()
        if self.parent is not None:
            self.parent.child_ns += self.t1 - self.t0
        return False


class Tracer:
    """The spans recorded inside one :func:`tracing` block, in the order
    they opened."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.spans: List[_Span] = []
        self.open: List[_Span] = []

    def summary(self) -> Dict[str, Dict]:
        """Per span name, in the order of its first call: ``parent`` (the
        first call's parent's name, or None), ``device_ms`` (CUDA events;
        empty without CUDA), ``host_ms`` and ``self_ms`` (host time less
        what child spans cover), one entry per finished call. Synchronises
        the card once."""
        if self.cuda:
            torch.cuda.synchronize()
        out: Dict[str, Dict] = {}
        for s in self.spans:
            if not hasattr(s, "t1"):
                continue
            e = out.setdefault(s.name, dict(parent=s.parent.name if s.parent else None,
                                            device_ms=[], host_ms=[], self_ms=[]))
            if s.events is not None:
                e["device_ms"].append(s.events[0].elapsed_time(s.events[1]))
            e["host_ms"].append((s.t1 - s.t0) * 1e-6)
            e["self_ms"].append((s.t1 - s.t0 - s.child_ns) * 1e-6)
        return out


@contextlib.contextmanager
def tracing():
    """Record every :func:`span` of the block; yields the :class:`Tracer`.
    Inside another ``tracing`` block it yields the open tracer."""
    global _active
    if _active is not None:
        yield _active
        return
    tr = Tracer(torch.cuda.is_initialized())
    _active = tr
    try:
        yield tr
    finally:
        _active = None


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (CPU and, when a card is
    there, CUDA activities) inside :func:`tracing`, and write ``trace.json``
    (Chrome trace format), which carries the spans, into ``log_dir``;
    yields the :class:`Tracer`."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with tracing() as tr, torch.profiler.profile(activities=activities) as prof:
        yield tr
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
