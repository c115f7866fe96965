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
- sparse-conv ``w [27, Cin, Cout]`` as is;
- 2D conv ``kernel`` and DCN ``w [kh, kw, Cin/groups, Cout]`` →
  ``weight [Cout, Cin/groups, kh, kw]`` (the DCN offset branch's
  ``conv_offset_w`` / ``_b`` onto its ``conv_offset`` conv), and the mask
  head's ``upsample_w [2, 2, Cin, Cout]`` / ``_b`` onto its
  ``ConvTranspose2d`` (``[Cin, Cout, 2, 2]``).

A JAX gradient tree has the structure of ``params``, so
``from_jax_variables({"params": grads})`` maps it, with the same layout
transforms, onto the names of ``model.named_parameters()``.
:func:`to_jax_variables` is the inverse: the port's module → the flax tree
(what ``train/torch_map.py`` walks to reach the reference's layout).
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .config import FSDConfig, FSFConfig
from .models.fsd import SingleStageFSD
from .models.fsf import FSF, ZeroInitMLP
from .models.htc import BN, HTC, DeformConvBlock
from .models.layers import LayerNorm, MaskedBatchNorm
from .models.sparse_unet import _ConvBlock
from .models.sst import MultiHeadDotProductAttention
from .models.two_stage import TwoStageFSD

# truncated-normal std correction of flax's variance_scaling("truncated_normal")
_TRUNC_STD = 0.87962566103423978


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


# HTC leaves that live on a submodule of the port's module:
# name -> (state_dict suffix, axes of the JAX array in the port's order)
_SUBMODULE_LEAVES = {
    "conv_offset_w": ("conv_offset.weight", (3, 2, 0, 1)),
    "conv_offset_b": ("conv_offset.bias", None),
    # ConvTranspose2d.weight [cin, cout, kh, kw]: the JAX head states
    # torch's transposed-conv semantics, so no kernel flip
    "upsample_w": ("upsample.weight", (2, 3, 0, 1)),
    "upsample_b": ("upsample.bias", None),
}


def jax_state_items(tree: Mapping) -> Iterator[Tuple[str, np.ndarray]]:
    """``(state_dict key, array in the port's layout)`` for every leaf of
    ``tree`` (see :func:`from_jax_variables`); the arrays are NumPy views of
    the leaves where the layout allows. Raises on a leaf it cannot map."""
    for collection, sub in tree.items():
        for path, leaf in _flatten(sub):
            arr = np.asarray(leaf)
            mod, name = ".".join(path[:-1]), path[-1]
            if collection == "params" and name in ("kernel", "w") and arr.ndim == 4:
                # conv [kh, kw, cin / groups, cout] → [cout, cin / groups, kh, kw]
                key, val = f"{mod}.weight", arr.transpose(3, 2, 0, 1)
            elif collection == "params" and name in _SUBMODULE_LEAVES:
                suffix, axes = _SUBMODULE_LEAVES[name]
                key, val = f"{mod}.{suffix}", arr if axes is None else arr.transpose(axes)
            elif collection == "params" and name == "kernel" and arr.ndim == 2:
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
            yield key, val


def from_jax_variables(tree: Mapping) -> Dict[str, torch.Tensor]:
    """``{"params": ..., "batch_stats": ...}`` (nested dicts of arrays; either
    collection may be absent, and ``params`` may hold gradients) → a
    ``state_dict`` for the port's module of the same structure. Raises on
    any leaf it cannot map."""
    out: Dict[str, torch.Tensor] = {}
    for key, val in jax_state_items(tree):
        if key in out:
            raise KeyError(f"two JAX variables map to {key}")
        out[key] = torch.from_numpy(np.array(val, dtype=np.float32))
    return out


def _np(t: torch.Tensor) -> np.ndarray:
    """A copy: the tree never aliases the module's storage."""
    return t.detach().to("cpu", torch.float32, copy=True).numpy()


def _jax_leaves(module: nn.Module, parent: Optional[nn.Module], path: Tuple[str, ...]):
    """``(collection, flax path, array)`` for the parameters and persistent
    buffers that ``module`` holds itself: the inverse of
    :func:`jax_state_items`' transforms."""
    own = dict(module.named_parameters(recurse=False))
    own.update((k, b) for k, b in module.named_buffers(recurse=False)
               if k not in module._non_persistent_buffers_set)
    if not own:
        return
    up, name = path[:-1], path[-1] if path else ""
    if isinstance(parent, DeformConvBlock) and name == "conv_offset":
        yield "params", up + ("conv_offset_w",), _np(own["weight"]).transpose(2, 3, 1, 0)
        yield "params", up + ("conv_offset_b",), _np(own["bias"])
    elif isinstance(module, nn.ConvTranspose2d):    # upsample_w [kh, kw, cin, cout]
        yield "params", up + (f"{name}_w",), _np(own["weight"]).transpose(2, 3, 0, 1)
        yield "params", up + (f"{name}_b",), _np(own["bias"])
    elif isinstance(module, DeformConvBlock):        # w [kh, kw, cin / g, cout]
        yield "params", path + ("w",), _np(own["weight"]).transpose(2, 3, 1, 0)
    elif isinstance(module, nn.Conv2d):             # kernel [kh, kw, cin / g, cout]
        yield "params", path + ("kernel",), _np(own["weight"]).transpose(2, 3, 1, 0)
        if module.bias is not None:
            yield "params", path + ("bias",), _np(own["bias"])
    elif isinstance(module, nn.Linear) and isinstance(parent, MultiHeadDotProductAttention):
        # DenseGeneral: [in, heads, head_dim] / [heads, head_dim, out]
        kernel, heads = _np(own["weight"]).T, parent.num_heads
        if name == "out":
            yield "params", path + ("kernel",), kernel.reshape(heads, -1, kernel.shape[1])
            yield "params", path + ("bias",), _np(own["bias"])
        else:
            yield "params", path + ("kernel",), kernel.reshape(kernel.shape[0], heads, -1)
            yield "params", path + ("bias",), _np(own["bias"]).reshape(heads, -1)
    elif isinstance(module, nn.Linear):
        yield "params", path + ("kernel",), _np(own["weight"]).T
        if module.bias is not None:
            yield "params", path + ("bias",), _np(own["bias"])
    elif isinstance(module, (LayerNorm, MaskedBatchNorm, BN)):
        yield "params", path + ("scale",), _np(own["weight"])
        yield "params", path + ("bias",), _np(own["bias"])
        if "running_mean" in own:
            yield "batch_stats", path + ("mean",), _np(own["running_mean"])
            yield "batch_stats", path + ("var",), _np(own["running_var"])
    elif isinstance(module, _ConvBlock):            # w [27, Cin, Cout] as is
        yield "params", path + ("w",), _np(own["w"])
    else:
        raise KeyError(f"no JAX layout for {type(module).__name__} at {'.'.join(path)}")


def to_jax_variables(model: nn.Module) -> Dict[str, Dict]:
    """The port's ``state_dict`` → ``{"params": ..., "batch_stats": ...}``
    as nested dicts of contiguous f32 NumPy arrays under the flax names and
    layouts: the inverse of :func:`from_jax_variables` (which loads the
    result back strictly and bitwise)."""
    tree: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    parents = {"": None}
    for name, module in model.named_modules():
        for child, _ in module.named_children():
            parents[f"{name}.{child}" if name else child] = module
        path = tuple(name.split(".")) if name else ()
        for col, leaf_path, arr in _jax_leaves(module, parents[name], path):
            node = tree[col]
            for p in leaf_path[:-1]:
                node = node.setdefault(p, {})
            if leaf_path[-1] in node:
                raise KeyError(f"two tensors map to {col}/{'/'.join(leaf_path)}")
            node[leaf_path[-1]] = np.ascontiguousarray(arr)
    return tree


def init_parameters(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise every parameter from ``generator`` with the JAX package's
    distributions: Dense, 2D-conv and sparse-conv weights truncated normal
    with variance 1/fan_in, DCN and transposed-conv weights normal with
    variance 2/fan_out, biases 0, norm scales 1 (statistics 0 / 1), and the
    enhancement MLP's last layer and the DCN offset branch 0. Works on CPU
    tensors; move after."""

    def trunc(w: torch.Tensor, fan_in: int):
        std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)

    def fan_out_normal(w: torch.Tensor, fan_out: int):
        nn.init.normal_(w, 0.0, math.sqrt(2.0 / fan_out), generator=generator)

    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            trunc(m.weight, m.weight[0].numel())
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.ConvTranspose2d):                 # [Cin, Cout, kh, kw]
            fan_out_normal(m.weight, m.weight[0].numel())
            nn.init.zeros_(m.bias)
        elif isinstance(m, DeformConvBlock):                    # [Cout, Cin/g, kh, kw]
            fan_out_normal(m.weight, m.weight.shape[0] * m.weight[0, 0].numel())
        elif isinstance(m, _ConvBlock):
            trunc(m.w, m.w.shape[0] * m.w.shape[1])
        elif isinstance(m, (LayerNorm, MaskedBatchNorm, BN)):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
            if isinstance(m, (MaskedBatchNorm, BN)):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
    for m in model.modules():
        if isinstance(m, ZeroInitMLP):
            last = getattr(m, f"Dense_{m.n - 1}")
            nn.init.zeros_(last.weight)
            nn.init.zeros_(last.bias)
        elif isinstance(m, DeformConvBlock):
            nn.init.zeros_(m.conv_offset.weight)
            nn.init.zeros_(m.conv_offset.bias)
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


def build_htc(seed: int = 0, device="cuda", jax_variables: Optional[Mapping] = None,
              **kw) -> HTC:
    """An ``HTC(**kw)`` in eval mode on ``device``, with weights from
    ``torch.Generator().manual_seed(seed)`` or, when given, the JAX
    package's variables (loaded with ``strict=True``)."""
    return _build(HTC(**kw), seed, device, jax_variables)
