"""One run of one cell: set-up, the measured window, the traced stretch, the
check against the reference, and the result line.

Serving (traffic ``mode`` ``serve``): a closed loop with one frame in
flight. A frame runs from handing the program its points on the host to its
detections on the host: ``FSF.forward`` + ``FSF.get_bboxes`` under
``torch.inference_mode``, the detections copied back. Training (``train``):
the program's ``parallel.train.train_step`` over a pool held on the device;
the window ends with a device synchronise.

With ``trace`` on, the profiler covers ``traced_units`` units after the
window's first, and CUDA-event spans record the model's phases in every
unit; the work of the traced units is counted from the reference's pass
over the same frames after the window."""
from __future__ import annotations

import gc
import math
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import costs, judge, manifest, sides, trace as tracing, traffic as traffic_mod, weights
from .spans import Spans

class Run:
    # the step from which the detection terms count, over the configuration's
    # ``train.enable_detection_step`` where set (calibrate.py's witness only)
    detection_from_override: Optional[int] = None

    def __init__(self, root: str, cell_name: str, seed: int, seconds: float, trace: bool,
                 device: str, t_start: float, bench_dir: Optional[str] = None):
        self.root, self.seed, self.seconds, self.trace = root, seed, seconds, trace
        self.device, self.t_start = device, t_start
        self.bench_dir = bench_dir or manifest.BENCH_DIR
        self.manifest = manifest.load(root)
        self.cell = manifest.cell(self.manifest, cell_name)
        self.cfg = manifest.config_file(self.manifest, self.cell, root)
        self.traffic = traffic_mod.check(manifest.traffic_file(self.cell, self.bench_dir))
        self.mode = self.traffic["mode"]
        self.limits = self.cfg["limits"]
        self.checks: Dict[str, Dict[str, float]] = {}
        self.rng = np.random.default_rng([seed & traffic_mod.SEED_MASK, 7])
        if self.mode == "train" and \
                self.traffic["checked_steps"] > self.cfg["train"]["enable_detection_step"]:
            raise ValueError("the checked steps have to lie in the segmentor-only warm-up "
                             "(traffic checked_steps <= config train.enable_detection_step)")

    def detection_from(self) -> int:
        if self.detection_from_override is not None:
            return self.detection_from_override
        return self.cfg["train"]["enable_detection_step"]

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
        return weights.make_state(sides.reference_model(self.cfg, "meta"), self.seed, self.device)

    def reference(self, state):
        model = sides.reference_model(self.cfg, self.device)
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

def _serve_one(model, frame, device):
    pb, cam, _ = sides.program_inputs(frame, device)
    with torch.inference_mode():
        res = model(pb, cam, 1)
        det = model.get_bboxes(res, 1)
    return {k: getattr(det, k)[0].cpu() for k in ("boxes", "scores", "labels", "valid")}


def _phases(run: Run, phases: Dict[str, float], name: str) -> None:
    """Set-up's phases on the host clock (after a synchronise), for the log."""
    run.sync()
    phases[name] = time.perf_counter() - run.t_start - sum(phases.values())


def serve(run: Run) -> Dict[str, Any]:
    dev = run.device
    phases: Dict[str, float] = {}
    _phases(run, phases, "start")
    pool = traffic_mod.make_pool(run.cfg, run.traffic, run.seed, dev)
    _phases(run, phases, "pool")
    model = sides.program_model(run.cfg, run.state(), dev)
    _phases(run, phases, "model")
    _serve_one(model, pool[0], dev)
    _phases(run, phases, "first_frame")
    for frame in pool[1:]:                      # every frame of the window, once
        _serve_one(model, frame, dev)
    _phases(run, phases, "warm_up")
    stretch = Stretch(run, lambda: _serve_one(model, pool[0], dev))
    spans = None
    if run.trace and run.cuda:
        spans = Spans()
        spans.module("seg_core", model.seg_core)
        spans.method("foreground", model.fsd_branch, "extract_foreground")
    run.sync()
    setup_s = time.perf_counter() - run.t_start

    answers, latency, order, done = [], [], [], []

    def unit(i):
        frame = pool[i % len(pool)]
        ts = time.perf_counter()
        answers.append(_serve_one(model, frame, dev))
        latency.append(time.perf_counter() - ts)
        order.append(frame.index)

    window_s = _window(run, unit, stretch, done)
    peak = torch.cuda.max_memory_allocated() if run.cuda else 0
    readings = dict(mode="serve", window_s=window_s, units=done[0], latency_s=latency,
                    setup_s=setup_s, spans=spans.ms() if spans else {}, work=None,
                    setup_phases=phases)
    failed = sum(1 for a in answers
                 if not all(torch.isfinite(a[k]).all() for k in ("boxes", "scores")))
    del model
    run.free()
    readings["trace"] = stretch.finish()
    _judge_serve(run, pool, answers, order, stretch.units(order), readings)
    return dict(readings=readings, attempted=done[0], failed=failed, peak=peak)


def _judge_serve(run: Run, pool, answers, order, traced: List[int], readings) -> None:
    """The reference serves a sample of the window's answers, drawn from the
    seed (the frame with the most objects always among them), and the
    frames of the traced stretch, whose work it counts."""
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
        wc = costs.WorkCount(ref) if idx in traced else None
        pb, cam, _ = sides.reference_inputs(pool[idx], run.device)
        with torch.inference_mode():
            det = judge.as_dict(ref.get_bboxes(ref(pb, cam, 1), 1))
        if wc is not None:
            works[idx] = wc.totals()
            wc.detach()
        if idx in at:
            run.check(f"moved_share.frame{idx}", judge.moved_share(det, answers[at[idx]]),
                      run.limits["moved_share"])
    if traced:
        readings["work"] = {k: float(np.mean([works[i][k] for i in traced]))
                            for k in works[traced[0]]}
    del ref
    run.free()


# --- training --------------------------------------------------------------

def _optimizer(make, model, cfg):
    t = cfg["train"]
    return make(model, base_lr=t["base_lr"], total_steps=t["total_steps"],
                weight_decay=t["weight_decay"], grad_clip_norm=t["grad_clip_norm"],
                lr_mult_rules=t["lr_mult_rules"])


def train(run: Run) -> Dict[str, Any]:
    from fullysparsefusion_tpu_torch.parallel.train import Batch, make_optimizer, train_step
    from fullysparsefusion_tpu_torch.train.hooks import RuntimeSchedule

    dev = run.device
    phases: Dict[str, float] = {}
    _phases(run, phases, "start")
    pool = traffic_mod.make_pool(run.cfg, run.traffic, run.seed, dev)
    batches = []
    for f in pool:
        pb, cam, gt = sides.program_inputs(f, dev)
        batches.append(Batch(pb, cam, gt, gt))
    _phases(run, phases, "pool")
    state = run.state()
    model = sides.program_model(run.cfg, state, dev)
    _phases(run, phases, "model")
    opt = _optimizer(make_optimizer, model, run.cfg)
    sched = RuntimeSchedule(enable_detection_step=run.detection_from())
    names = {id(p): n for n, p in model.named_parameters()}
    checked = run.traffic["checked_steps"]
    losses = []
    for s in range(checked):                    # the warm-up steps the reference follows
        loss, terms, _ = train_step(model, opt, sched, batches[s % len(pool)], s)
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
    for s in range(checked, len(pool)):         # every scene of the window, once, detecting
        train_step(model, opt, sched, batches[s], s)
    _phases(run, phases, "warm_up")
    base = len(pool)

    def step(i, mark=None):
        return train_step(model, opt, sched, batches[(base + i) % len(pool)], base + i, mark)

    stretch = Stretch(run, lambda: None)
    spans = None
    if run.trace and run.cuda:
        spans = Spans()
        mark = spans.marks({"forward": "forward", "backward": "backward"})
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
    del model, opt, batches, last
    run.free()
    readings["trace"] = stretch.finish()
    readings["first_terms"] = first_terms
    _judge_train(run, pool, losses, (first_grad, first_grad_t), change, stretch.units(order),
                 readings)
    return dict(readings=readings, attempted=done[0], failed=failed, peak=peak)


def _judge_train(run: Run, pool, losses, first, change, traced, readings) -> None:
    """The reference follows the checked steps from the same weights on the
    same scenes, on the same schedule; its passes over the traced units'
    scenes count their work."""
    from ..reference.hooks import RuntimeSchedule
    from ..reference.train import Batch, make_optimizer, train_step

    first_grad, first_grad_t = first
    state = run.state()
    ref = run.reference(state)
    opt = _optimizer(make_optimizer, ref, run.cfg)
    names = {id(p): n for n, p in ref.named_parameters()}
    sched = RuntimeSchedule(enable_detection_step=run.detection_from())
    ref_losses, works = [], {}
    for s in range(len(losses)):
        idx = s % len(pool)
        pb, cam, gt = sides.reference_inputs(pool[idx], run.device)
        wc = costs.WorkCount(ref, training=True) if idx in traced and idx not in works else None
        loss, terms, _ = train_step(ref, opt, sched, Batch(pb, cam, gt, gt), s,
                                    wc.mark if wc is not None else None)
        ref_losses.append(float(loss))
        if s == 0:
            ref_terms = {k: float(v) for k, v in terms.items()}
        if wc is not None:
            works[idx] = wc.totals()
            wc.detach()
        if s == 0:
            ref_grad = judge.adam_first_grads(opt, names)
            grad_diff = judge.adam_first_grad_diffs(opt, names, first_grad_t)
    with torch.no_grad():
        ref_change = {n: float((p.double() - state[n].double()).norm())
                      for n, p in ref.named_parameters()}
    reached = judge.reached_leaves(ref_grad)
    g = judge.leaf_gaps(ref_grad, first_grad, reached)
    c = judge.leaf_gaps(ref_change, change, reached)
    d = judge.leaf_gaps(ref_grad, first_grad, reached, diff=grad_diff)
    got_terms = readings.pop("first_terms")
    numbers = dict(
        loss_gap=judge.loss_gap(ref_losses, losses), grad_leaf_gap=g[0][0],
        change_leaf_gap=c[0][0], grad_diff_gap=d[0][0],
        seg_loss_gap=judge.seg_loss_gap(ref_terms, got_terms),
        grad_median_gap=judge.median([v for v, _ in g]),
        change_median_gap=judge.median([v for v, _ in c]),
        grad_diff_median=judge.median([v for v, _ in d]))
    readings["not_compared"] = {}
    for name, value in numbers.items():     # a number the configuration sets no limit for
        if name in run.limits:              # is reported, not compared (PERF.md says why)
            run.check(name, value, run.limits[name])
        else:
            readings["not_compared"][name] = value
    readings["detail"] = dict(
        reached_leaves=len(reached),
        grad_worst=[[k, v] for v, k in g[:5]], change_worst=[[k, v] for v, k in c[:5]],
        grad_diff_worst=[[k, v] for v, k in d[:5]],
        losses=[ref_losses, losses],
        first_terms={k: [ref_terms[k], got_terms.get(k)] for k in ref_terms
                     if abs(ref_terms[k] - got_terms.get(k, 0.0)) > 1e-3 * max(abs(ref_terms[k]), 1e-6)},
        seg_terms={k: [ref_terms[k], got_terms.get(k)] for k in judge.SEG_TERMS})
    readings["leaves"] = dict(ref_grad=ref_grad, grad=first_grad, ref_change=ref_change,
                              change=change, grad_diff=grad_diff)
    counted = [i for i in traced if i in works]
    if counted:
        readings["work"] = {k: float(np.mean([works[i][k] for i in counted]))
                            for k in works[counted[0]]}
    del ref, opt, state
    run.free()


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
    out = serve(run) if run.mode == "serve" else train(run)
    return result(run, out), out["readings"]


def run_cell(*args, **kw) -> Dict[str, Any]:
    """The result line's object of one run (arguments as :func:`measure`)."""
    return measure(*args, **kw)[0]
