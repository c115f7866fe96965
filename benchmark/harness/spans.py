"""Spans from the benchmark's own files: CUDA events recorded around a
module's forward (forward hooks) or around a method of a module (wrapped on
the instance), or at the phase marks of the program's train step. Nothing
is synchronised while they record; :meth:`Spans.ms` reads them after the
window."""
from __future__ import annotations

import functools
from typing import Callable, Dict, List

import torch


class Spans:
    def __init__(self):
        self.events: Dict[str, List] = {}
        self._handles = []
        self._open: Dict[str, List] = {}

    def _event(self):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def begin(self, name: str) -> None:
        self._open.setdefault(name, []).append(self._event())

    def end(self, name: str) -> None:
        self.events.setdefault(name, []).append((self._open[name].pop(), self._event()))

    def module(self, name: str, module: torch.nn.Module) -> None:
        """A span around every call of ``module``."""
        self._handles.append(module.register_forward_pre_hook(lambda m, a: self.begin(name)))
        self._handles.append(module.register_forward_hook(lambda m, a, o: self.end(name)))

    def method(self, name: str, owner, attr: str) -> None:
        """A span around every call of ``owner.attr`` (wrapped on the
        instance)."""
        fn = getattr(owner, attr)

        @functools.wraps(fn)
        def wrapped(*a, **k):
            self.begin(name)
            try:
                return fn(*a, **k)
            finally:
                self.end(name)

        setattr(owner, attr, wrapped)

    def marks(self, names: Dict[str, str]) -> Callable[[str], None]:
        """A ``mark(phase)`` callback for the train step: the span
        ``names[phase]`` runs from the previous mark (or :meth:`start`) to
        this one."""
        def mark(phase: str) -> None:
            e = self._event()
            if phase in names:
                self.events.setdefault(names[phase], []).append((self._last, e))
            self._last = e

        return mark

    def start(self) -> None:
        self._last = self._event()

    def ms(self) -> Dict[str, List[float]]:
        torch.cuda.synchronize()
        return {k: [a.elapsed_time(b) for a, b in v] for k, v in self.events.items()}
