"""Training checkpoints: the model's ``state_dict`` (parameters and BN
running statistics), the optimizer's (moments, step counts, param groups
with their lr multipliers) and the step, in one ``torch.save`` file.

A training run writes ``step_{step:08d}.pt`` files into its work directory
(the JAX package's ``step_{step:08d}`` names); :func:`latest_checkpoint`
finds the newest, :func:`load_model_vars` restores the model alone for
inference, and :func:`load_jax_variables` warm-starts a model from a pickle
of the JAX package's variables (what its training tool's ``--init-from``
reads, and what ``cli/convert_checkpoint.py`` writes).
:func:`load_torch_state_dict` reads a reference (mmdet3d / mmcv) ``.pth``
for ``train/torch_map.py``."""
from __future__ import annotations

import os
import pickle
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..weights import from_jax_variables


def checkpoint_path(work_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(work_dir), f"step_{step:08d}.pt")


def save_checkpoint(path: str, model: nn.Module, opt: torch.optim.Optimizer, step: int) -> None:
    """Write atomically: a partial file never replaces a good one."""
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save({"model": model.state_dict(), "optimizer": opt.state_dict(), "step": int(step)},
               tmp)
    os.replace(tmp, path)


def latest_checkpoint(work_dir: str) -> Optional[str]:
    """The ``step_*.pt`` file of the highest step in ``work_dir``, or None."""
    if not os.path.isdir(work_dir):
        return None
    steps = sorted(f for f in os.listdir(work_dir)
                   if f.startswith("step_") and f.endswith(".pt"))
    return os.path.join(os.path.abspath(work_dir), steps[-1]) if steps else None


def load_checkpoint(path: str, model: nn.Module, opt: torch.optim.Optimizer) -> int:
    """Restore ``model`` and ``opt`` in place (onto the model's device);
    returns the saved step."""
    dev = next(model.parameters()).device
    ck = torch.load(path, map_location=dev, weights_only=True)
    model.load_state_dict(ck["model"], strict=True)
    opt.load_state_dict(ck["optimizer"])
    return int(ck["step"])


def load_model_vars(path: str, model: nn.Module) -> int:
    """Restore only ``model`` (strictly) from a training checkpoint, for
    inference; returns the saved step."""
    dev = next(model.parameters()).device
    ck = torch.load(path, map_location=dev, weights_only=True)
    model.load_state_dict(ck["model"], strict=True)
    return int(ck["step"])


def load_jax_variables(path: str, model: nn.Module) -> None:
    """Load a pickle of the JAX package's variables (``{"params": ...,
    "batch_stats": ...}`` as nested dicts of arrays) into ``model`` through
    ``weights.from_jax_variables``, strictly."""
    with open(path, "rb") as f:
        tree = pickle.load(f)
    model.load_state_dict(from_jax_variables(tree), strict=True)


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A reference ``.pth`` (mmcv's ``{"meta", "state_dict", ...}`` or a
    bare ``state_dict``) → ``{name: ndarray}``, read on the CPU with
    ``torch.load``'s default ``weights_only=True``. Raises, naming the file,
    on a file it refuses or one that holds no dict of tensors."""
    try:
        sd = torch.load(path, map_location="cpu")
    except Exception as e:
        raise ValueError(f"{path}: not a loadable state dict ({e})") from e
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if not isinstance(sd, dict) or not all(torch.is_tensor(v) for v in sd.values()):
        raise ValueError(f"{path}: holds no dict of tensors")
    return {k: v.detach().numpy() for k, v in sd.items()}
