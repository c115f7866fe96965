"""The training step, plain (frozen copy of the program's one-process step):
the train-mode forward with losses, the backward of the summed loss, the
optax-style global-norm clip, and AdamW with each group's lr ``mult ·
lr_schedule(step)``."""
from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .hooks import RuntimeSchedule
from .utils.containers import CameraData, GroundTruth, PointBatch


def cyclic_lr_schedule(base_lr: float, total_steps: int,
                       target_ratio: Tuple[float, float] = (10.0, 1e-4),
                       step_ratio_up: float = 0.4) -> Callable[[int], float]:
    """mmcv's cyclic policy, one cycle, cosine annealing up to ``base_lr ·
    target_ratio[0]`` over the first ``step_ratio_up`` of the steps and down
    to ``base_lr · target_ratio[1]``, evaluated in f32."""
    up_steps = max(int(total_steps * step_ratio_up), 1)
    down_steps = max(total_steps - up_steps, 1)
    peak = base_lr * target_ratio[0]
    floor = base_lr * target_ratio[1]
    f32 = np.float32

    def sched(step: int) -> float:
        s = f32(step)
        if s < up_steps:
            t = np.clip(s / f32(up_steps), f32(0), f32(1))
            v = f32(base_lr) + f32((peak - base_lr) * 0.5) * (f32(1) - np.cos(f32(math.pi) * t))
        else:
            t = np.clip((s - f32(up_steps)) / f32(down_steps), f32(0), f32(1))
            v = f32(floor) + f32((peak - floor) * 0.5) * (f32(1) + np.cos(f32(math.pi) * t))
        return float(f32(v))

    return sched


def make_optimizer(model: nn.Module, base_lr: float = 1e-4, total_steps: int = 10000,
                   weight_decay: float = 0.01, grad_clip_norm: float = 35.0,
                   lr_mult_rules: Optional[Mapping[str, float]] = None) -> torch.optim.AdamW:
    """AdamW (β 0.9 / 0.999, eps 1e-8), one param group per lr multiplier
    (the first rule whose prefix starts a parameter's name, else 1)."""
    rules = dict(lr_mult_rules or {})
    groups: Dict[float, list] = {}
    for name, p in model.named_parameters():
        mult = next((m for prefix, m in rules.items() if name.startswith(prefix)), 1.0)
        groups.setdefault(mult, []).append(p)
    opt = torch.optim.AdamW(
        [dict(params=ps, lr=base_lr * mult, lr_mult=mult) for mult, ps in groups.items()],
        lr=base_lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
    opt.lr_schedule = cyclic_lr_schedule(base_lr, total_steps)
    opt.grad_clip_norm = grad_clip_norm
    return opt


def total_loss(losses: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Sum of every term whose key contains "loss"."""
    return sum(v for k, v in losses.items() if "loss" in k)


def clip_grad_global_norm_(params, max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm``: every gradient times ``max_norm /
    ‖g‖`` when ‖g‖ ≥ ``max_norm``. Returns ‖g‖."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, torch.full_like(norm, max_norm)))
    return norm


class Batch(NamedTuple):
    pb: PointBatch
    cam: Optional[CameraData]
    gt: GroundTruth
    no_aug_gt: Optional[GroundTruth]


def optimizer_step(opt: torch.optim.Optimizer, step: int) -> torch.Tensor:
    gnorm = clip_grad_global_norm_([p for g in opt.param_groups for p in g["params"]],
                                   opt.grad_clip_norm)
    lr = opt.lr_schedule(step)
    for group in opt.param_groups:
        group["lr"] = lr * group["lr_mult"]
    opt.step()
    return gnorm


def train_step(model: nn.Module, opt: torch.optim.Optimizer, sched: RuntimeSchedule,
               batch: Batch, step: int, mark: Optional[Callable[[str], None]] = None):
    """One step: (total loss, losses, grad norm), still on the device.
    ``mark(phase)`` is called as each of "forward", "backward" and
    "optimizer" ends."""
    mark = mark or (lambda phase: None)
    model.train()
    opt.zero_grad(set_to_none=True)
    out = model(batch.pb, batch.cam, batch.gt.boxes.shape[0], batch.gt, batch.no_aug_gt,
                thresh_buffer=sched.threshold_buffer(step),
                detection_weight=1.0 if sched.enable_detection(step) else 0.0)
    loss = total_loss(out["losses"])
    mark("forward")
    loss.backward()
    mark("backward")
    losses = {k: v.detach() for k, v in out["losses"].items()}
    gnorm = optimizer_step(opt, step)
    mark("optimizer")
    return loss.detach(), losses, gnorm
