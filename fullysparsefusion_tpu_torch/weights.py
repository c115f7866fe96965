"""Weights: seeded initialisation and the bridge from the JAX package's
variables.

The port's submodules carry the flax module names, so
:func:`from_jax_variables` is a walk over the variable tree plus per-leaf
layout transforms:

- Dense ``kernel [in, out]`` → Linear ``weight [out, in]``;
- attention's DenseGeneral ``query`` / ``key`` / ``value`` ``kernel [in,
  heads, head_dim]`` and ``out`` ``kernel [heads, head_dim, out]`` →
  Linear ``weight`` with the head axes flattened, ``bias [heads,
  head_dim]`` → ``[heads · head_dim]``;
- LayerNorm / BatchNorm ``scale`` → ``weight``, ``bias`` → ``bias``;
- BatchNorm ``batch_stats/{mean,var}`` → ``running_mean`` / ``running_var``;
- sparse-conv ``w [27, Cin, Cout]`` as is.

A JAX gradient tree has the structure of ``params``, so
``from_jax_variables({"params": grads})`` maps it, with the same layout
transforms, onto the names of ``model.named_parameters()``.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from .config import FSDConfig, FSFConfig
from .models.fsd import SingleStageFSD
from .models.fsf import FSF, ZeroInitMLP
from .models.layers import LayerNorm, MaskedBatchNorm
from .models.sparse_unet import _ConvBlock
from .models.two_stage import TwoStageFSD

# truncated-normal std correction of flax's variance_scaling("truncated_normal")
_TRUNC_STD = 0.87962566103423978


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def from_jax_variables(tree: Mapping) -> Dict[str, torch.Tensor]:
    """``{"params": ..., "batch_stats": ...}`` (nested dicts of arrays; either
    collection may be absent, and ``params`` may hold gradients) → a
    ``state_dict`` for the port's module of the same structure. Raises on
    any leaf it cannot map."""
    out: Dict[str, torch.Tensor] = {}
    for collection, sub in tree.items():
        for path, leaf in _flatten(sub):
            arr = np.asarray(leaf)
            mod, name = ".".join(path[:-1]), path[-1]
            if collection == "params" and name == "kernel" and arr.ndim == 2:
                key, val = f"{mod}.weight", arr.T
            elif collection == "params" and name == "kernel" and arr.ndim == 3:
                # DenseGeneral: contracted axes first, features last
                flat = (arr.reshape(-1, arr.shape[-1]) if path[-2] == "out"
                        else arr.reshape(arr.shape[0], -1))
                key, val = f"{mod}.weight", flat.T
            elif collection == "params" and name == "bias" and arr.ndim == 2:
                key, val = f"{mod}.bias", arr.reshape(-1)
            elif collection == "params" and name == "scale":
                key, val = f"{mod}.weight", arr
            elif collection == "params" and name in ("bias", "w"):
                key, val = f"{mod}.{name}", arr
            elif collection == "batch_stats" and name in ("mean", "var"):
                key, val = f"{mod}.running_{name}", arr
            else:
                raise KeyError(f"unmapped JAX variable {collection}/{'/'.join(path)}")
            if key in out:
                raise KeyError(f"two JAX variables map to {key}")
            out[key] = torch.from_numpy(np.array(val, dtype=np.float32))
    return out


def init_parameters(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise every parameter from ``generator`` with the JAX package's
    distributions: Dense and sparse-conv weights truncated normal with
    variance 1/fan_in, biases 0, norm scales 1 (statistics 0 / 1), and the
    enhancement MLP's last layer 0. Works on CPU tensors; move after."""

    def trunc(w: torch.Tensor, fan_in: int):
        std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)

    for m in model.modules():
        if isinstance(m, nn.Linear):
            trunc(m.weight, m.in_features)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, _ConvBlock):
            trunc(m.w, m.w.shape[0] * m.w.shape[1])
        elif isinstance(m, (LayerNorm, MaskedBatchNorm)):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
            if isinstance(m, MaskedBatchNorm):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
    for m in model.modules():
        if isinstance(m, ZeroInitMLP):
            last = getattr(m, f"Dense_{m.n - 1}")
            nn.init.zeros_(last.weight)
            nn.init.zeros_(last.bias)
    return model


def _build(model: nn.Module, seed: int, device, jax_variables: Optional[Mapping]):
    if jax_variables is None:
        init_parameters(model, torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(from_jax_variables(jax_variables), strict=True)
    return model.to(device).eval()


def build_fsf(cfg: FSFConfig, seed: int = 0, device="cuda",
              jax_variables: Optional[Mapping] = None) -> FSF:
    """An ``FSF`` in eval mode on ``device``, with weights from
    ``torch.Generator().manual_seed(seed)`` or, when given, the JAX
    package's variables (loaded with ``strict=True``)."""
    return _build(FSF(cfg), seed, device, jax_variables)


def build_fsd(cfg: FSDConfig, seed: int = 0, device="cuda",
              jax_variables: Optional[Mapping] = None) -> SingleStageFSD:
    """A LiDAR-only ``SingleStageFSD`` in eval mode on ``device``, with
    weights from ``torch.Generator().manual_seed(seed)`` or, when given, the
    JAX package's variables (loaded with ``strict=True``)."""
    return _build(SingleStageFSD(cfg), seed, device, jax_variables)


def build_two_stage_fsd(cfg: FSDConfig, seed: int = 0, device="cuda",
                        jax_variables: Optional[Mapping] = None) -> TwoStageFSD:
    """A ``TwoStageFSD`` (one task) in eval mode on ``device``, with
    weights from ``torch.Generator().manual_seed(seed)`` or, when given, the
    JAX package's variables (loaded with ``strict=True``)."""
    return _build(TwoStageFSD(cfg), seed, device, jax_variables)
