"""Weights made on the device from the seed, in one draw.

The distributions are the program's initialisation (``weights.init_parameters``):
dense and sparse-conv weights truncated normal (±2σ) with variance
1/fan_in, biases 0, norm scales 1 with statistics 0 / 1, and the
enhancement MLP's last layer 0. All truncated normal values of a model come
from one ``trunc_normal_`` call on a ``torch.Generator`` of the device and
are cut into leaves, so the weights cost one kernel, not one per leaf. The
same state is handed to the program and to the reference."""
from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn


def _layout(model: nn.Module):
    """(name, fan_in or None) of each truncated-normal leaf, and the leaves
    that are 0, 1, in the order of ``model.named_modules()``."""
    from ..reference.models.fsf import ZeroInitMLP
    from ..reference.models.layers import LayerNorm, MaskedBatchNorm
    from ..reference.models.sparse_unet import _ConvBlock

    normal, zeros, ones = [], [], []
    zero_last = set()
    for name, m in model.named_modules():
        if isinstance(m, ZeroInitMLP):
            zero_last.add(f"{name}.Dense_{m.n - 1}")
    for name, m in model.named_modules():
        p = f"{name}." if name else ""
        if isinstance(m, nn.Linear):
            if name in zero_last:
                zeros.append(p + "weight")
            else:
                normal.append((p + "weight", m.weight.shape[1]))
            if m.bias is not None:
                zeros.append(p + "bias")
        elif isinstance(m, _ConvBlock):
            normal.append((p + "w", m.w.shape[0] * m.w.shape[1]))
        elif isinstance(m, (LayerNorm, MaskedBatchNorm)):
            ones.append(p + "weight")
            zeros.append(p + "bias")
            if isinstance(m, MaskedBatchNorm):
                zeros.append(p + "running_mean")
                ones.append(p + "running_var")
    return normal, zeros, ones


def make_state(model: nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """A full ``state_dict`` for ``model`` (the reference's FSF, whose names
    the program's shares) on ``device``, drawn from ``seed``."""
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    normal, zeros, ones = _layout(model)
    total = sum(math.prod(shapes[n]) for n, _ in normal)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & ((1 << 63) - 1))
    flat = torch.empty(total, dtype=torch.float32, device=device)
    nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    state, at = {}, 0
    for name, fan_in in normal:
        n = math.prod(shapes[name])
        # the unit truncated normal has std 0.8796; scale to std sqrt(1 / fan_in)
        state[name] = flat[at:at + n].view(shapes[name]) * (math.sqrt(1.0 / fan_in) / 0.87962566103423978)
        at += n
    for name in zeros:
        state[name] = torch.zeros(shapes[name], device=device)
    for name in ones:
        state[name] = torch.ones(shapes[name], device=device)
    if set(state) != set(shapes):
        raise KeyError(f"weights: no rule for {sorted(set(shapes) - set(state))}")
    return state
