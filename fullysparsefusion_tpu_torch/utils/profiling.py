"""Profiling and tracing (the port's counterpart of the JAX package's
``utils/profiling.py``).

:class:`SectionTimer` replaces the reference's ``TorchTimer`` (a
CUDA-synchronised section timer with periodic averaged prints): a section
ends when the CUDA streams of the tensors given as ``sync`` are done.
:func:`device_trace` records a ``torch.profiler`` trace of the host and the
card and writes it as a Chrome trace; :func:`named_scope` labels a span in
it.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch


def _tensors(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def block_until_ready(tree) -> None:
    """Wait for the current stream of every CUDA device that holds a tensor
    of ``tree`` (nested dicts, lists and tuples); CPU tensors are ready."""
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.current_stream(dev).synchronize()


class SectionTimer:
    """Section timer with a device sync and periodic averages.

    Usage::

        timer = SectionTimer(print_interval=20)
        with timer.section("segmentor") as sync:
            out = seg_fn(x)
            sync(out)

    ``sync(tree)`` (or ``section(name, sync=tree)`` for a tree made
    before the section) names what the section waits for before it stops
    the clock."""

    def __init__(self, print_interval: int = 20, enabled: bool = True):
        self.print_interval = print_interval
        self.enabled = enabled
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str, sync=None):
        waits = [] if sync is None else [sync]
        if not self.enabled:
            yield waits.append
            return
        t0 = time.perf_counter()
        yield waits.append
        block_until_ready(waits)
        dt = time.perf_counter() - t0
        self.totals[name] += dt
        self.counts[name] += 1
        if self.counts[name] % self.print_interval == 0:
            avg = self.totals[name] / self.counts[name] * 1000
            print(f"[timer] {name}: avg {avg:.1f} ms over {self.counts[name]} calls")

    def summary(self) -> Dict[str, float]:
        """Mean ms per section."""
        return {k: self.totals[k] / max(self.counts[k], 1) * 1000 for k in self.totals}


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (CPU and, when a card is
    there, CUDA activities) and write ``trace.json`` (Chrome trace format)
    into ``log_dir``; yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def named_scope(name: str):
    """A labelled span in :func:`device_trace`'s trace
    (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)
