"""Training step (port of ``parallel/train.py``): one process, or data
parallel over the ranks of a ``torch.distributed`` group.

The JAX package's optimizer is the optax chain ``clip_by_global_norm(35)``
→ ``adamw(cyclic lr, wd 0.01)`` → per-module lr multipliers (the
segmentor core ×0.2 for FSF). Here it is ``torch.optim.AdamW`` with one
param group per multiplier, so each group's lr is ``mult · lr(step)`` and
its weight decay, applied to every parameter as optax does, scales with it;
the clip is written out with optax's rule (``g · max / ‖g‖`` when ‖g‖ ≥ max,
no epsilon). The lr of step n is ``cyclic_lr_schedule(n)`` with n counted
from 0, as optax counts.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..models.camera import CameraData
from ..models.fsd import SingleStageFSD
from ..models.layers import bn_group
from ..models.two_stage import TwoStageFSD
from ..train.hooks import RuntimeSchedule
from ..utils.containers import GroundTruth, PointBatch
from ..utils.profiling import span


def cyclic_lr_schedule(base_lr: float, total_steps: int,
                       target_ratio: Tuple[float, float] = (10.0, 1e-4),
                       step_ratio_up: float = 0.4) -> Callable[[int], float]:
    """mmcv's cyclic policy, one cycle, cosine annealing up to ``base_lr ·
    target_ratio[0]`` over the first ``step_ratio_up`` of the steps and down
    to ``base_lr · target_ratio[1]``; evaluated in f32 as the JAX package
    does."""
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
    """AdamW (β 0.9 / 0.999, eps 1e-8) over ``model``'s parameters, one
    param group per lr multiplier: a parameter whose name starts with a rule's
    prefix (the first that matches) takes its multiplier, every other 1.
    The optimizer carries ``lr_schedule`` and ``grad_clip_norm`` for
    :func:`train_step`."""
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
    """Sum of every term whose key contains "loss" (the prefixed FSF keys
    included; ``num_pos`` and ``assign_recall`` are diagnostics)."""
    return sum(v for k, v in losses.items() if "loss" in k)


def clip_grad_global_norm_(params, max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm``: every gradient times ``max_norm /
    ‖g‖`` when the global norm ‖g‖ ≥ ``max_norm``. Returns ‖g‖. Multi-tensor
    kernels, no host sync: the gradients are divided by ‖g‖ and multiplied
    by ``max_norm`` (optax's order) where the clip applies, by 1 and 1
    elsewhere."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, torch.full_like(norm, max_norm)))
    return norm


class Batch(NamedTuple):
    """One training batch: points, camera data, the augmented and the no-aug
    ground truth. FSF's points carry the no-aug xyz channels; the LiDAR-only
    ``SingleStageFSD`` and ``TwoStageFSD`` take no camera data and no no-aug
    GT (None)."""

    pb: PointBatch
    cam: Optional[CameraData]
    gt: GroundTruth
    no_aug_gt: Optional[GroundTruth]


def fsf_forward(model: nn.Module, batch: Batch, **kw):
    """``FSF`` on ``batch`` (the JAX package's ``fsf_forward_fn``)."""
    return model(batch.pb, batch.cam, batch.gt.boxes.shape[0], batch.gt, batch.no_aug_gt, **kw)


def fsd_forward(model: nn.Module, batch: Batch, **kw):
    """``SingleStageFSD`` or ``TwoStageFSD`` on ``batch``'s points and GT
    (the JAX package's ``fsd_forward_fn``)."""
    return model(batch.pb, batch.gt.boxes.shape[0], batch.gt, **kw)


def optimizer_step(opt: torch.optim.Optimizer, step: int) -> torch.Tensor:
    """Apply the gradients in ``.grad``: the global-norm clip, then AdamW
    with each group's lr ``mult · lr_schedule(step)`` (step counted from
    0). Returns the gradient's global norm before the clip."""
    gnorm = clip_grad_global_norm_([p for g in opt.param_groups for p in g["params"]],
                                   opt.grad_clip_norm)
    lr = opt.lr_schedule(step)
    for group in opt.param_groups:
        group["lr"] = lr * group["lr_mult"]
    opt.step()
    return gnorm


def allreduce_grads_mean_(params, group) -> None:
    """Replace every parameter's ``.grad`` by its mean over ``group``'s
    ranks, in one all-reduce of one flat f32 buffer. A parameter without a
    gradient on this rank contributes zeros, so every rank issues the same
    collective whatever its data; afterwards every parameter has one."""
    params = list(params)
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for p in params])
    dist.all_reduce(flat, group=group)
    flat.div_(dist.get_world_size(group))
    for p, g in zip(params, flat.split([p.numel() for p in params])):
        p.grad = g.view_as(p)


def allreduce_mean(values: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """The mean over ``group``'s ranks of each (detached, scalar) value, in
    one all-reduce."""
    keys = list(values)
    flat = torch.stack([values[k].detach().float() for k in keys])
    dist.all_reduce(flat, group=group)
    flat.div_(dist.get_world_size(group))
    return dict(zip(keys, flat.unbind()))


def sharded_train_step(model: nn.Module, opt: torch.optim.Optimizer, sched: RuntimeSchedule,
                       batch: Batch, step: int, group=None,
                       mark: Optional[Callable[[str], None]] = None):
    """One data-parallel step over the ranks of ``group``, each with its own
    ``batch``: the train-mode forward with losses (:func:`fsd_forward` for a
    ``SingleStageFSD`` or ``TwoStageFSD``, :func:`fsf_forward` otherwise) under
    ``layers.bn_group(group)`` (SyncBN statistics, loss normalizers averaged
    over the ranks), the backward of this rank's :func:`total_loss` (the
    BN all-reduces carry every rank's cotangents into it), each gradient
    averaged over the ranks, then :func:`optimizer_step` as in one process:
    the same gradients keep the ranks' parameters equal. This is the JAX
    package's ``make_generic_sharded_train_step``: the gradient of the mean
    over ranks of the global loss. ``group=None`` is one process
    (:func:`train_step`).

    ``mark(phase)``, when given, is called as each of "forward",
    "backward", "allreduce" (with a group: gradients and losses averaged)
    and "optimizer" ends, just after the span of that phase
    (``step.forward`` … ``step.optimizer``, :mod:`utils.profiling`). Returns (total loss, losses, grad norm), the
    first two averaged over the ranks, all still on the device."""
    mark = mark or (lambda phase: None)
    with span("step.forward"):
        model.train()
        opt.zero_grad(set_to_none=True)
        forward = fsd_forward if isinstance(model, (SingleStageFSD, TwoStageFSD)) else fsf_forward
        with bn_group(group):
            out = forward(model, batch, thresh_buffer=sched.threshold_buffer(step),
                          detection_weight=1.0 if sched.enable_detection(step) else 0.0)
        loss = total_loss(out["losses"])
    mark("forward")
    with span("step.backward"):
        loss.backward()
    mark("backward")
    losses = {k: v.detach() for k, v in out["losses"].items()}
    loss = loss.detach()
    if group is not None:
        with span("step.allreduce"):
            allreduce_grads_mean_(model.parameters(), group)
            reduced = allreduce_mean(dict(losses, _total=loss), group)
        loss = reduced.pop("_total")
        losses = reduced
        mark("allreduce")
    with span("step.optimizer"):
        gnorm = optimizer_step(opt, step)
    mark("optimizer")
    return loss, losses, gnorm


def train_step(model: nn.Module, opt: torch.optim.Optimizer, sched: RuntimeSchedule,
               batch: Batch, step: int, mark: Optional[Callable[[str], None]] = None):
    """One step in one process: train-mode forward with losses
    (thresh_buffer and the detection weight from ``sched`` at ``step``),
    backward of :func:`total_loss`, the global-norm clip, and AdamW at
    ``lr_schedule(step)`` per group. ``mark(phase)``, when given, is called
    as each of "forward", "backward" and "optimizer" ends. Returns (total
    loss, losses, grad norm), all still on the device."""
    return sharded_train_step(model, opt, sched, batch, step, None, mark)
