"""Shared NN building blocks (port of ``models/layers.py``).

Child modules carry the JAX package's flax names (``Dense_0``, ``Norm_0``,
``LayerNorm_0``, ``MaskedBatchNorm_0``) so a flax variable tree maps onto
the ``state_dict`` by a walk (:mod:`..weights`).

Under :func:`bn_group` the train-form ``MaskedBatchNorm`` takes global
statistics over the ranks of a ``torch.distributed`` group (SyncBN) and
:func:`mesh_mean` averages the detection losses' normalizers over them, as
the JAX package's ``bn_axis`` does over a mesh axis.
"""
from __future__ import annotations

import contextlib
import contextvars
from functools import partial
from typing import Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

# The process group of a data-parallel train step (None: local math).
# Consulted by MaskedBatchNorm's train form (SyncBN statistics) and by the
# detection losses' normalizers (mesh_mean).
_BN_GROUP: contextvars.ContextVar = contextvars.ContextVar("bn_group", default=None)


@contextlib.contextmanager
def bn_group(group: Optional["dist.ProcessGroup"]):
    """Cross-rank statistics (SyncBN + synced loss normalizers) over
    ``group`` inside the block; ``None`` keeps every rank's math local."""
    tok = _BN_GROUP.set(group)
    try:
        yield
    finally:
        _BN_GROUP.reset(tok)


@contextlib.contextmanager
def bn_form(module: nn.Module, train: Optional[bool]):
    """``module`` in train (``True``) or eval (``False``) mode inside the
    block, back to its mode after; ``None`` leaves it as it is."""
    was = module.training
    if train is not None:
        module.train(train)
    try:
        yield
    finally:
        module.train(was)


def mesh_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean of ``x`` over the active group's ranks (identity outside
    :func:`bn_group`). Applied to detached counts, so no gradient: with the
    gradient mean of the train step it makes a normalised loss
    ``global_sum / global_count``, as one process on the whole batch."""
    group = _BN_GROUP.get()
    if group is None:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, group=group)
    return y / dist.get_world_size(group)


class _AllReduceSum(torch.autograd.Function):
    """Differentiable all-reduce (sum): the backward all-reduces the
    cotangents, so each rank's gradient carries every rank's."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.apply(g, ctx.group), None


def get_activation(name: str):
    """The JAX package's activation table; an unknown name raises KeyError."""
    return {
        "relu": F.relu,
        # flax's gelu is the tanh approximation
        "gelu": partial(F.gelu, approximate="tanh"),
        "silu": F.silu,
        "tanh": torch.tanh,
        "identity": lambda x: x,
    }[name]


class LayerNorm(nn.Module):
    """flax ``LayerNorm``: var = E[x²] − E[x]² (clamped at 0), f32."""

    def __init__(self, c: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over the valid rows of a [N, C] tensor (eps 1e-3).

    In train mode (``self.training``) it normalises by the valid rows'
    statistics, in f32 even for bf16 input, with the biased variance
    ``max(E[x²] − mean², 0)`` over ``n = max(Σvalid, 1)`` rows, and folds them
    into the running statistics with the torch momentum convention
    ``(1 − m)·running + m·batch`` (m = 0.01); in eval mode it uses the running
    statistics. ``valid=None`` means every row. Under :func:`bn_group` the
    (n, Σx, Σx²) of every rank are summed, in one differentiable
    all-reduce, before the clamp of n, so every rank normalises by (and
    folds into its buffers) the same global statistics."""

    def __init__(self, c: int, eps: float = 1e-3, momentum: float = 0.01):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor, valid=None) -> torch.Tensor:
        xf = x.float()
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            w = (torch.ones(x.shape[0], device=x.device) if valid is None
                 else valid.float())[:, None]
            n, sx, sxx = w.sum(), (xf * w).sum(0), (xf * xf * w).sum(0)
            group = _BN_GROUP.get()
            if group is not None:
                c = sx.shape[0]
                n, sx, sxx = _AllReduceSum.apply(torch.cat([n[None], sx, sxx]), group
                                                 ).split([1, c, c])
                n = n[0]
            n = n.clamp(min=1.0)
            mean = sx / n
            var = torch.clamp(sxx / n - mean ** 2, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(m * mean)
                self.running_var.mul_(1 - m).add_(m * var)
        return (xf - mean) * torch.rsqrt(var + self.eps) * self.weight + self.bias


class Norm(nn.Module):
    """'ln' (LayerNorm), 'bn' (MaskedBatchNorm) or 'none'."""

    def __init__(self, kind: str, c: int, eps: float = 1e-3):
        super().__init__()
        self.kind = kind
        if kind == "ln":
            self.LayerNorm_0 = LayerNorm(c, eps)
        elif kind == "bn":
            self.MaskedBatchNorm_0 = MaskedBatchNorm(c, eps)
        elif kind != "none":
            raise ValueError(kind)

    def forward(self, x, valid=None):
        if self.kind == "ln":
            return self.LayerNorm_0(x)
        if self.kind == "bn":
            return self.MaskedBatchNorm_0(x, valid)
        return x


class MLP(nn.Module):
    """Linear(bias=False) → Norm → Act per hidden dim; optional biased head."""

    def __init__(self, in_dim: int, hidden_dims: Sequence[int], norm: str = "ln",
                 act: str = "relu", is_head: bool = False, bias: bool = False):
        super().__init__()
        self.act = get_activation(act)
        self.n = len(hidden_dims)
        self.is_head = is_head
        d = in_dim
        for i, c in enumerate(hidden_dims):
            head = i == self.n - 1 and is_head
            setattr(self, f"Dense_{i}", nn.Linear(d, c, bias=head or bias))
            if not head:
                setattr(self, f"Norm_{i}", Norm(norm, c))
            d = c
        self.out_dim = d

    def forward(self, x, valid=None):
        for i in range(self.n):
            x = getattr(self, f"Dense_{i}")(x)
            if not (i == self.n - 1 and self.is_head):
                x = self.act(getattr(self, f"Norm_{i}")(x, valid))
        return x
