"""Shared NN building blocks (port of ``models/layers.py``).

Child modules carry the JAX package's flax names (``Dense_0``, ``Norm_0``,
``LayerNorm_0``, ``MaskedBatchNorm_0``) so a flax variable tree maps onto
the ``state_dict`` by a walk (:mod:`..weights`).
"""
from __future__ import annotations

from functools import partial
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def get_activation(name: str):
    return {
        "relu": F.relu,
        # flax's gelu is the tanh approximation
        "gelu": partial(F.gelu, approximate="tanh"),
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
    statistics. ``valid=None`` means every row."""

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
            n = w.sum().clamp(min=1.0)
            mean = (xf * w).sum(0) / n
            var = torch.clamp((xf * xf * w).sum(0) / n - mean ** 2, min=0.0)
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
