"""One run of one cell: set-up, the measured window, the traced stretch, the
check against the reference, and the result line.

Serving (traffic ``mode`` ``serve``): a closed loop with one frame in
flight; a unit is the family's ``serve_one``, from a frame's data where the
mix keeps it to the answer on the host. Training (``train``): the family's
train step over a pool held on the device; the window ends with a device
synchronise.

With ``trace`` on, the profiler covers ``traced_units`` units after the
window's first, and CUDA-event spans record the model's phases in every
unit; the work of the traced units is counted from the reference's pass
over the same frames after the window.

What is particular to a model lives in its family's file,
``benchmark/families/<family>.py`` (:func:`manifest.family`), which gives:

- ``MODES``: the traffic modes it runs, each with the mix keys it reads
  beyond the harness's; ``check_cell(cfg_file, traffic)``: ValueError for a
  cell it cannot run;
- ``reference_model(cfg_file, device)``, ``program_model(cfg_file, state,
  device)`` and ``make_state(cfg_file, seed, device)``: the two sides and
  the weights of a seed, one ``state_dict`` for both;
- ``make_frame(cfg_file, traffic, seed, i, objects, device)``: frame ``i``
  of the pool, with ``index`` and ``objects``;
- serving: ``serve_one(model, frame, device)`` (the timed unit),
  ``failed(answer)``, ``serve_spans(spans, model)``, ``reference_answer(ref,
  frame, device)``, ``served_numbers(want, got)`` (by the names of the
  configuration's ``limits``) and ``work_count(ref, training=False)``
  (``costs.WorkCount``'s interface);
- training: ``program_batch(frame, device)``, ``program_train(run, model)``
  (the optimizer, ``step(batch, s, mark=None)``), ``TRAIN_MARKS`` and
  ``judge_train(run, pool, losses, first, change, traced, readings)``;
- for ``calibrate.py``: context managers entered around a run
  (:attr:`Run.variants`), such as ``control()``."""
from __future__ import annotations

import contextlib
import gc
import math
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import judge, manifest, trace as tracing, traffic as traffic_mod
from .spans import Spans


class Run:
    # what calibrate.py puts in the program's place or plants in it: (name,
    # *args) of a context manager of the family's, entered around the run
    variants: Tuple[tuple, ...] = ()

    def __init__(self, root: str, cell_name: str, seed: int, seconds: float, trace: bool,
                 device: str, t_start: float, bench_dir: Optional[str] = None):
        self.root, self.seed, self.seconds, self.trace = root, seed, seconds, trace
        self.device, self.t_start = device, t_start
        self.bench_dir = bench_dir or manifest.BENCH_DIR
        self.manifest = manifest.load(root)
        self.cell = manifest.cell(self.manifest, cell_name)
        self.cfg = manifest.config_file(self.manifest, self.cell, root)
        self.family = manifest.family(self.cfg, self.bench_dir)
        traffic = manifest.traffic_file(self.cell, self.bench_dir)
        self.traffic = traffic_mod.check(traffic, self.family.MODES.get(traffic.get("mode"), ()))
        self.mode = self.traffic["mode"]
        if self.mode not in self.family.MODES:
            raise ValueError(f"cell {cell_name!r}: family {self.cfg['family']!r} runs "
                             f"{sorted(self.family.MODES)}, not {self.mode!r}")
        self.family.check_cell(self.cfg, self.traffic)
        self.limits = self.cfg["limits"]
        self.checks: Dict[str, Dict[str, float]] = {}
        self.rng = np.random.default_rng([seed & traffic_mod.SEED_MASK, 7])

    @property
    def cuda(self) -> bool:
        return self.device != "cpu"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def free(self) -> None:
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    def check(self, name: str, value: float, limit: float) -> None:
        self.checks[name] = {"value": float(value), "limit": float(limit)}

    def correct(self) -> bool:
        return bool(self.checks) and all(
            math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in self.checks.values())

    def state(self):
        """The weights of this run's seed, made anew on the device."""
        return self.family.make_state(self.cfg, self.seed, self.device)

    def reference(self, state):
        model = self.family.reference_model(self.cfg, self.device)
        model.load_state_dict(state, strict=True)
        return model.eval()


class Stretch:
    """The traced stretch of a window: units ``1 … k`` (the first unit runs
    unprofiled)."""

    def __init__(self, run: Run, warm):
        self.k = run.traffic["traced_units"] if (run.trace and run.cuda) else 0
        self.prof = None
        self.result = None
        if self.k:
            tracing.warm_up(warm)

    def around(self, i: int, fn):
        """Run unit ``i`` of the window, profiled where it belongs to the
        stretch."""
        if not self.k or not 1 <= i <= self.k:
            return fn()
        if i == 1:
            self.prof = tracing.profiler()
            self.prof.start()
        with tracing.unit():
            out = fn()
        if i == self.k:
            self.prof.stop()
        return out

    def units(self, order: List[int]) -> List[int]:
        """Pool indices of the traced units."""
        return order[1:self.k + 1]

    def finish(self):
        if self.prof is not None:
            self.result = tracing.reduce(tracing.export(self.prof))
            self.prof = None
        return self.result


def _window(run: Run, unit, stretch: Stretch, units_done: List[int]):
    """Units until ``run.seconds`` have passed; returns the window's seconds."""
    t0 = time.perf_counter()
    i = 0
    while True:
        stretch.around(i, lambda: unit(i))
        i += 1
        if time.perf_counter() - t0 >= run.seconds:
            break
    run.sync()
    units_done.append(i)
    return time.perf_counter() - t0


# --- serving ---------------------------------------------------------------

def _phases(run: Run, phases: Dict[str, float], name: str) -> None:
    """Set-up's phases on the host clock (after a synchronise), for the log."""
    run.sync()
    phases[name] = time.perf_counter() - run.t_start - sum(phases.values())


def serve(run: Run) -> Dict[str, Any]:
    fam, dev = run.family, run.device
    phases: Dict[str, float] = {}
    _phases(run, phases, "start")
    pool = traffic_mod.make_pool(fam, run.cfg, run.traffic, run.seed, dev)
    _phases(run, phases, "pool")
    model = fam.program_model(run.cfg, run.state(), dev)
    _phases(run, phases, "model")
    serve_one = fam.serve_one
    serve_one(model, pool[0], dev)
    _phases(run, phases, "first_frame")
    for frame in pool[1:]:                      # every frame of the window, once
        serve_one(model, frame, dev)
    _phases(run, phases, "warm_up")
    stretch = Stretch(run, lambda: serve_one(model, pool[0], dev))
    spans = None
    if run.trace and run.cuda:
        spans = Spans()
        fam.serve_spans(spans, model)
    run.sync()
    setup_s = time.perf_counter() - run.t_start

    answers, latency, order, done = [], [], [], []

    def unit(i):
        frame = pool[i % len(pool)]
        ts = time.perf_counter()
        answers.append(serve_one(model, frame, dev))
        latency.append(time.perf_counter() - ts)
        order.append(frame.index)

    window_s = _window(run, unit, stretch, done)
    peak = torch.cuda.max_memory_allocated() if run.cuda else 0
    readings = dict(mode="serve", window_s=window_s, units=done[0], latency_s=latency,
                    setup_s=setup_s, spans=spans.ms() if spans else {}, work=None,
                    setup_phases=phases)
    failed = sum(1 for a in answers if fam.failed(a))
    del model
    run.free()
    readings["trace"] = stretch.finish()
    _judge_serve(run, pool, answers, order, stretch.units(order), readings)
    return dict(readings=readings, attempted=done[0], failed=failed, peak=peak)


def _judge_serve(run: Run, pool, answers, order, traced: List[int], readings) -> None:
    """The reference serves a sample of the window's answers, drawn from the
    seed (the frame with the most objects always among them), and the
    frames of the traced stretch, whose work it counts."""
    fam = run.family
    n = min(run.traffic["judged_units"], len(pool))
    most = max(range(len(pool)), key=lambda i: pool[i].objects)
    rest = [i for i in range(len(pool)) if i != most]
    judged = [most] + [int(i) for i in run.rng.choice(rest, size=n - 1, replace=False)]
    at = {}
    for idx in judged:
        seen = [j for j, o in enumerate(order) if o == idx]
        if seen:
            at[idx] = int(run.rng.choice(seen))
    ref = run.reference(run.state())
    works = {}
    for idx in sorted(set(at) | set(traced)):
        wc = fam.work_count(ref) if idx in traced else None
        want = fam.reference_answer(ref, pool[idx], run.device)
        if wc is not None:
            works[idx] = wc.totals()
            wc.detach()
        if idx in at:
            for name, value in fam.served_numbers(want, answers[at[idx]]).items():
                run.check(f"{name}.frame{idx}", value, run.limits[name])
    if traced:
        readings["work"] = {k: float(np.mean([works[i][k] for i in traced]))
                            for k in works[traced[0]]}
    del ref
    run.free()


# --- training --------------------------------------------------------------

def train(run: Run) -> Dict[str, Any]:
    fam, dev = run.family, run.device
    phases: Dict[str, float] = {}
    _phases(run, phases, "start")
    pool = traffic_mod.make_pool(fam, run.cfg, run.traffic, run.seed, dev)
    batches = [fam.program_batch(f, dev) for f in pool]
    _phases(run, phases, "pool")
    state = run.state()
    model = fam.program_model(run.cfg, state, dev)
    _phases(run, phases, "model")
    opt, train_step = fam.program_train(run, model)
    names = {id(p): n for n, p in model.named_parameters()}
    checked = run.traffic["checked_steps"]
    losses = []
    for s in range(checked):                    # the warm-up steps the reference follows
        loss, terms, _ = train_step(batches[s % len(pool)], s)
        losses.append(float(loss))
        if s == 0:
            first_grad = judge.adam_first_grads(opt, names)
            first_grad_t = judge.adam_first_grad_tensors(opt, names)
            first_terms = {k: float(v) for k, v in terms.items()}
    with torch.no_grad():
        change = {n: float((p.double() - state[n].double()).norm())
                  for n, p in model.named_parameters()}
    del state
    _phases(run, phases, "checked_steps")
    for s in range(checked, len(pool)):         # every scene of the window, once
        train_step(batches[s], s)
    _phases(run, phases, "warm_up")
    base = len(pool)

    def step(i, mark=None):
        return train_step(batches[(base + i) % len(pool)], base + i, mark)

    stretch = Stretch(run, lambda: None)
    spans = None
    if run.trace and run.cuda:
        spans = Spans()
        mark = spans.marks(fam.TRAIN_MARKS)
    run.sync()
    setup_s = time.perf_counter() - run.t_start

    last, done, order = [], [], []

    def unit(i):
        if spans is not None:
            spans.start()
            out = step(i, mark)
        else:
            out = step(i)
        last.append(out[0])
        order.append((base + i) % len(pool))

    window_s = _window(run, unit, stretch, done)
    peak = torch.cuda.max_memory_allocated() if run.cuda else 0
    failed = int((~torch.isfinite(torch.stack(last))).sum())
    readings = dict(mode="train", window_s=window_s, units=done[0], latency_s=[],
                    setup_s=setup_s, spans=spans.ms() if spans else {}, work=None,
                    setup_phases=phases)
    del model, opt, train_step, batches, last
    run.free()
    readings["trace"] = stretch.finish()
    readings["first_terms"] = first_terms
    fam.judge_train(run, pool, losses, (first_grad, first_grad_t), change, stretch.units(order),
                    readings)
    return dict(readings=readings, attempted=done[0], failed=failed, peak=peak)


# --- the result --------------------------------------------------------------

def result(run: Run, out: Dict[str, Any]) -> Dict[str, Any]:
    """The result line's object; ``checks`` comes last."""
    r = out["readings"]
    kind = "per_layer" if run.trace else "end_to_end"
    metrics = {}
    for m in manifest.metrics(run.manifest, run.cell["name"], kind):
        v = manifest.reader(m["name"], run.bench_dir)(r)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device = {"platform": "gpu" if run.cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if run.cuda else "cpu",
              "count": int(run.cell["chips"]), "memory_peak_bytes": int(out["peak"])}
    res = {"correct": run.correct(), "attempted": int(out["attempted"]),
           "failed": int(out["failed"]), "metrics": metrics, "device": device}
    t = r.get("trace")
    if run.trace and t:
        device["busy_s"] = t["busy_s"]
        device["window_s"] = t["window_s"]
        res["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    if r.get("not_compared"):
        res["not_compared"] = r["not_compared"]
    res["checks"] = run.checks
    return res


def measure(root: str, cell_name: str, seed: int, seconds: float, trace: bool, device: str,
            t_start: float, bench_dir: Optional[str] = None):
    """(the result line's object, the run's readings)."""
    run = Run(root, cell_name, seed, seconds, trace, device, t_start, bench_dir)
    with contextlib.ExitStack() as planted:
        for name, *args in run.variants:
            planted.enter_context(getattr(run.family, name)(*args))
        out = serve(run) if run.mode == "serve" else train(run)
    return result(run, out), out["readings"]


def run_cell(*args, **kw) -> Dict[str, Any]:
    """The result line's object of one run (arguments as :func:`measure`)."""
    return measure(*args, **kw)[0]
