"""Weights made on the device from the seed, in one draw.

A family gives the layout: which leaves of its reference model are drawn
truncated normal (±2σ, variance 1/fan_in), and which are 0 and 1. All
truncated normal values of a model come from one ``trunc_normal_`` call on
a ``torch.Generator`` of the device and are cut into leaves, so the weights
cost one kernel, not one per leaf. The same state is handed to the program
and to the reference."""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch
from torch import nn

# model -> ([(name, fan_in)] truncated normal, [name] of 0, [name] of 1), in a fixed order
Layout = Callable[[nn.Module], Tuple[List[Tuple[str, int]], List[str], List[str]]]


def make_state(model: nn.Module, seed: int, device, layout: Layout) -> Dict[str, torch.Tensor]:
    """A full ``state_dict`` for ``model`` (the reference's, whose names the
    program's shares) on ``device``, drawn from ``seed`` by ``layout``."""
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    normal, zeros, ones = layout(model)
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
