"""Training checkpoints: the model's ``state_dict`` (parameters and BN
running statistics), the optimizer's (moments, step counts, param groups
with their lr multipliers) and the step, in one ``torch.save`` file."""
from __future__ import annotations

import os

import torch
from torch import nn


def save_checkpoint(path: str, model: nn.Module, opt: torch.optim.Optimizer, step: int) -> None:
    """Write atomically: a partial file never replaces a good one."""
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save({"model": model.state_dict(), "optimizer": opt.state_dict(), "step": int(step)},
               tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, model: nn.Module, opt: torch.optim.Optimizer) -> int:
    """Restore ``model`` and ``opt`` in place (onto the model's device);
    returns the saved step."""
    dev = next(model.parameters()).device
    ck = torch.load(path, map_location=dev, weights_only=True)
    model.load_state_dict(ck["model"], strict=True)
    opt.load_state_dict(ck["optimizer"])
    return int(ck["step"])
