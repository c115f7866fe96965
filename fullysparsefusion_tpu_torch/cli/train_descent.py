"""Full-width FSF training descent (the port's counterpart of the JAX
package's ``tools/train_descent.py``).

Runs ``--steps`` full-fusion training steps of FSF at the JAX package
bench's capacities (``config.bench_fsf_config(--batch)``: 131,072 points and
57,344 voxels a sample, six cameras with 450 x 800 masks) on the card
(``--cpu``: on the host), cycling through a pool of ``--scenes`` synthetic
scenes, and writes a loss-curve artifact to ``--out``.

The pool is the JAX tool's: scene ``s`` joins the samples of
``synthetic.make_lidar_scene_arrays(seed=101 + 17 s + b, n_boxes=32,
extent=48)`` for b < ``--batch`` (sample b's points at batch index b), its
cameras are ``make_camera_arrays`` of the joined GT at 450 x 800 (250 anno
rows, fx 400), the points carry the no-aug xyz channels, and the scene's GT
serves as the augmented and the no-aug GT. The model is FSF with weights
from seed 0; the optimizer ``make_optimizer(base_lr=1e-4,
total_steps=--steps)`` with no per-module lr multipliers, as the JAX tool
has it; each step is ``parallel.train.train_step`` at the default
``RuntimeSchedule``.

The artifact carries the JAX tool's keys (``device``, ``config``,
``steps``, ``sec_per_step_steady``, ``loss_first``, ``loss_last``, and
``log``: every ``--log-every`` steps the loss, each ``loss*`` and
``*num_pos`` term and the mean host seconds a step since the previous
entry; ``loss_last`` is the last step's loss) and adds, for every step
(``per_step``), the loss, the device ms of forward, backward and optimizer
(CUDA events; the host clock on the CPU), the peak and reserved MiB of the
card's allocator, and the kernels' launches; the slowest step and the
slowest optimizer phase with their steps; and the card's name and power
limit as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
prints them. The JAX tool's ``pair_budget_probe`` (``FSF_DEBUG_PAIR_BUDGET``)
is left out: it arms a probe of the JAX package's compact rulebook path,
which the port does not have.

    python -m fullysparsefusion_tpu_torch.cli.train_descent --steps 120
    python -m fullysparsefusion_tpu_torch.cli.train_descent --tiny --cpu --steps 3 \\
        --log-every 1 --out /tmp/descent.json
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import synthetic as S
from ..config import FSFConfig, bench_fsf_config, tiny_fsf_config
from ..parallel.train import Batch, make_optimizer, train_step
from ..train.hooks import RuntimeSchedule
from ..weights import build_fsf
from .common import kernel_launches, launches_since, resolve_device
from .train import StepTimer

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(REPO, "docs", "h100_fsf_training_descent.json")
# the JAX tool's cameras
IMG_H, IMG_W, MAX_ANNO, FX = 450, 800, 250, 400.0


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=120)
    p.add_argument("--scenes", type=int, default=4, help="the pool of synthetic scenes")
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--batch", type=int, default=1,
                   help="samples a step (the JAX tool's FSF_BENCH_BATCH)")
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--tiny", action="store_true", help="the tiny test config (CI)")
    p.add_argument("--cpu", action="store_true", help="run on the host CPU")
    return p.parse_args(argv)


def pool_arrays(cfg: FSFConfig, scenes: int, batch: int) -> List[Tuple[Dict, Dict]]:
    """The JAX tool's pool as NumPy arrays: per scene (the joined samples
    with the no-aug channels and the GT, the cameras)."""
    per = cfg.caps.points // batch
    n_boxes = min(32, cfg.caps.max_gt)            # 32, but for the tiny config's 16 slots
    pool = []
    for s in range(scenes):
        parts = [S.make_lidar_scene_arrays(seed=101 + s * 17 + b, n_cap=per,
                                           max_gt=cfg.caps.max_gt, n_boxes=n_boxes, extent=48.0)
                 for b in range(batch)]
        sc = {k: np.concatenate([p[k] for p in parts])
              for k in ("valid", "gt_boxes", "gt_labels", "gt_valid")}
        sc["points"] = S.with_noaug_channels_array(np.concatenate([p["points"] for p in parts]))
        sc["batch_idx"] = np.concatenate([p["batch_idx"] + b for b, p in enumerate(parts)])
        cam = S.make_camera_arrays(sc["gt_boxes"], sc["gt_labels"], sc["gt_valid"],
                                   batch_size=batch, num_cams=cfg.num_cams,
                                   num_classes=cfg.num_classes, img_h=IMG_H, img_w=IMG_W,
                                   max_anno=MAX_ANNO, fx=FX)
        pool.append((sc, cam))
    return pool


def scene_pool(cfg: FSFConfig, scenes: int, batch: int, device) -> List[Batch]:
    """The pool on ``device``, each scene's GT as both GTs."""
    out = []
    for sc, cam in pool_arrays(cfg, scenes, batch):
        gt = S.to_ground_truth(sc, device)
        out.append(Batch(S.to_point_batch(sc, device), S.to_camera_data(cam, device), gt, gt))
    return out


def card_name_and_limit() -> Optional[str]:
    """``nvidia-smi``'s name and power limit of the first card (None
    without ``nvidia-smi``)."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True, check=True)
    except FileNotFoundError:
        return None
    return smi.stdout.strip().splitlines()[0]


def run(args) -> Dict:
    """The descent as ``args`` say. Returns the ``artifact`` (also written
    to ``args.out``), the trained ``model``, its optimizer ``opt`` and the
    ``pool``."""
    device = resolve_device(args.cpu)
    cuda = device.type == "cuda"
    cfg = tiny_fsf_config() if args.tiny else bench_fsf_config(args.batch)
    t0 = time.perf_counter()
    pool = scene_pool(cfg, args.scenes, args.batch, device)
    model = build_fsf(cfg, seed=0, device=device)
    opt = make_optimizer(model, base_lr=1e-4, total_steps=args.steps)
    setup_s = time.perf_counter() - t0
    sched = RuntimeSchedule()
    per_step, log = [], []
    t_log = None
    for i in range(args.steps):
        batch = pool[i % len(pool)]
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        before = kernel_launches()
        timer = StepTimer(device)
        t_step = time.perf_counter()
        timer.mark("start")
        loss, losses, gnorm = train_step(model, opt, sched, batch, i, timer.mark)
        phases = timer.ms()                     # synchronizes the card
        rec = {"step": i + 1, "scene": i % len(pool), "loss": float(loss),
               "grad_norm": float(gnorm), **phases,
               "step_ms": sum(phases.values()), "host_ms": (time.perf_counter() - t_step) * 1e3,
               "launches": launches_since(before)}
        if cuda:
            rec["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
            rec["reserved_mib"] = torch.cuda.memory_reserved() / 2**20
        per_step.append(rec)
        if i == 0:
            print(f"step 1: loss {rec['loss']:.4f} (first step {rec['host_ms'] / 1e3:.1f} s)",
                  flush=True)
            t_log = time.perf_counter()
        elif (i + 1) % args.log_every == 0:
            n = i + 1 - (log[-1]["step"] if log else 1)
            entry = {"step": i + 1, "loss": round(rec["loss"], 4),
                     "sec_per_step": round((time.perf_counter() - t_log) / n, 3)}
            entry.update({k: round(float(v), 4) for k, v in sorted(losses.items())
                          if "loss" in k or k.endswith("num_pos")})
            log.append(entry)
            print(json.dumps(entry), flush=True)
            t_log = time.perf_counter()
    slowest = max(per_step, key=lambda r: r["step_ms"])
    slowest_opt = max(per_step, key=lambda r: r["optimizer_ms"])
    artifact = {
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
        "card": card_name_and_limit() if cuda else None,
        "config": ("tiny test config" if args.tiny else
                   f"bench capacities ({cfg.caps.points // args.batch // 1000}k pts, "
                   f"{cfg.caps.voxels} voxels, {cfg.num_cams} cams {IMG_H}x{IMG_W} masks)")
                  + f", {args.scenes}-scene pool, batch {args.batch}",
        "steps": args.steps,
        "sec_per_step_steady": log[-1]["sec_per_step"] if log else None,
        "loss_first": per_step[0]["loss"],
        "loss_last": per_step[-1]["loss"],
        "setup_seconds": setup_s,
        "parameters": sum(p.numel() for p in model.parameters()),
        "slowest_step": {k: slowest[k] for k in ("step", "step_ms", "optimizer_ms")},
        "slowest_optimizer": {k: slowest_opt[k] for k in ("step", "optimizer_ms")},
        "log": log,
        "per_step": per_step,
    }
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(artifact, f, indent=1)
        print(f"wrote {args.out}")
    return dict(artifact=artifact, model=model, opt=opt, pool=pool)


def main(argv: Optional[list] = None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
