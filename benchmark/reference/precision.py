"""The reference's precision, and the control one step below it.

The configuration states bf16 operands with f32 accumulation for the sparse
UNet's convolutions and f32 everywhere else, with TF32 off. The control
computes each of them one step lower, as a later change might: the UNet's
operands in fp8 (e4m3, one scale per tensor) and every dense layer's
operands in TF32 (10 stored mantissa bits). Both are emulated by rounding
the operands, so the control reads the same on any device. The benchmark's
own runs never switch it on.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

LOW = False  # True: the control's precision

_FP8_MAX = 448.0


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to TF32's 10 mantissa bits, to nearest, ties
    away from zero (as the tensor cores round their inputs)."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x1000) & ~0x1FFF
    return i.view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` through float8 e4m3 with one scale per tensor (its largest
    magnitude onto e4m3's largest), back in f32."""
    xf = x.float()
    amax = xf.abs().amax()
    scale = torch.where(amax > 0, amax / _FP8_MAX, torch.ones_like(amax))
    return (xf / scale).to(torch.float8_e4m3fn).float() * scale


def _straight_through(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``r`` in the forward, the identity's gradient in the backward."""
    return x + (r - x).detach()


def low_bf16(x: torch.Tensor) -> torch.Tensor:
    """A bf16 operand: as it is, or through fp8 in the control."""
    return _straight_through(x, round_fp8(x).to(x.dtype)) if LOW else x


def _tf32_linear(self: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    xl = _straight_through(x, round_tf32(x.float()).to(x.dtype))
    wl = _straight_through(self.weight, round_tf32(self.weight.float()))
    return F.linear(xl, wl, self.bias)


def lower_linears(model: nn.Module) -> nn.Module:
    """Every ``nn.Linear`` of ``model`` with TF32 operands (the control)."""
    for m in model.modules():
        if isinstance(m, nn.Linear):
            m.forward = _tf32_linear.__get__(m)
    return model
