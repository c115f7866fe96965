"""The yardstick: published peaks of one NVIDIA H100 and the work of the
sparse convolutions and dense layers, counted from the reference's pass over
a frame (frozen copies of the program's ``chip_smoke.py`` cost functions).

Work comes from the inputs, not from the program: a rulebook hit costs
``2 · Cin · Cout`` operations, a dense layer ``2 · in · out`` a row that
carries data, and each input byte is read once and each output byte written
once. A convolution counts its rulebook's hits whichever path runs it, the
gather kernels or the dense ``conv3d``, since both compute the same sums:
so a change of path moves the kernels' time and not the work."""
from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn

PEAK_BF16 = 989e12     # dense bf16 / fp16 tensor-core FLOP/s (SXM data sheet, 700 W)
PEAK_BYTES = 3.35e12   # HBM3 bytes/s


def gather_conv_cost(feats, rows, w):
    """K1's rulebook hits, FLOPs and bytes (each input read once, the output
    written once)."""
    n_src, cin = feats.shape
    k3, n_out = rows.shape
    cout = w.shape[2]
    hits = int((rows < n_src).sum())
    flop = 2.0 * hits * cin * cout
    byte = 2.0 * n_src * cin + 4.0 * k3 * n_out + 2.0 * k3 * cin * cout + 4.0 * n_out * cout
    return hits, flop, byte


def dw_per_tap_cost(feats, rows, g):
    """The weight gradient's hits, FLOPs and bytes: feats, rows and g read
    once, ``d_w [K³, Cin, Cout]`` f32 written once."""
    n_src, cin = feats.shape
    k3, n_out = rows.shape
    cout = g.shape[1]
    hits = int((rows < n_src).sum())
    flop = 2.0 * hits * cin * cout
    byte = 2.0 * n_src * cin + 4.0 * k3 * n_out + 2.0 * n_out * cout + 4.0 * k3 * cin * cout
    return hits, flop, byte


def bound_s(flop: float, byte: float, peak_flops: float = PEAK_BF16) -> float:
    """The least seconds that work of ``flop`` operations moving ``byte``
    bytes can take."""
    return max(flop / peak_flops, byte / PEAK_BYTES)


class WorkCount:
    """Counts the work of the reference's passes while it is attached.

    Sparse convolutions are reported by the reference itself (its
    ``sparse_conv.COUNTERS``); dense layers by hooks on every ``nn.Linear``,
    which count the rows that carry data: the valid rows where the
    enclosing ``MLP`` was given a validity mask, every row otherwise. In a
    training pass the caller sets ``backward`` once the forward has ended (the
    reference's ``train_step(mark=...)``); a dense layer's backward counts
    twice its forward. A dense-path convolution is told of in its forward
    only: in training its input gradient and weight gradient are counted
    there, as the gather path counts them in the backward.

    ``conv_fwd_s``, ``conv_bwd_s`` and ``dw_s`` are the least seconds of every
    sparse convolution's forward, input gradient and weight gradient."""

    def __init__(self, model: nn.Module, training: bool = False):
        from ..reference.models.layers import MLP
        from ..reference.ops import sparse_conv

        self.training = training
        self.backward = False
        self.conv_fwd_s = self.conv_bwd_s = self.dw_s = 0.0
        self.conv_flop = self.linear_flop = 0.0
        self._rows: List[int] = []
        self._sc = sparse_conv
        self._handles = []
        for m in model.modules():
            if isinstance(m, MLP):
                self._handles.append(m.register_forward_pre_hook(self._mlp_in, with_kwargs=True))
                self._handles.append(m.register_forward_hook(self._mlp_out))
            elif isinstance(m, nn.Linear):
                self._handles.append(m.register_forward_hook(self._linear))
        sparse_conv.COUNTERS.append(self._conv)

    def detach(self) -> None:
        for h in self._handles:
            h.remove()
        self._sc.COUNTERS.remove(self._conv)

    def _mlp_in(self, module, args, kwargs):
        valid = args[1] if len(args) > 1 else kwargs.get("valid")
        self._rows.append(-1 if valid is None else int(valid.sum()))

    def _mlp_out(self, module, args, out):
        self._rows.pop()

    def _linear(self, module, args, out):
        x = args[0]
        rows = x.numel() // x.shape[-1]
        if self._rows and self._rows[-1] >= 0:
            rows = min(rows, self._rows[-1])
        flop = 2.0 * rows * module.in_features * module.out_features
        self.linear_flop += flop * (3.0 if self.training else 1.0)

    def _conv(self, kind, feats, rows, w):
        if kind == "dw_per_tap":
            _, flop, byte = dw_per_tap_cost(feats, rows, w)
            self.dw_s += bound_s(flop, byte)
            self.conv_flop += flop
            return
        _, flop, byte = gather_conv_cost(feats, rows, w)
        self.conv_flop += flop
        if kind == "gather_conv" and self.backward:
            self.conv_bwd_s += bound_s(flop, byte)
            return
        self.conv_fwd_s += bound_s(flop, byte)
        if kind == "dense_conv" and self.training:   # conv3d's autograd: d_input, d_w
            _, dw_flop, dw_byte = dw_per_tap_cost(feats, rows, feats.new_empty((0, w.shape[2])))
            self.conv_bwd_s += bound_s(flop, byte)
            self.dw_s += bound_s(dw_flop, dw_byte)
            self.conv_flop += flop + dw_flop

    def mark(self, phase: str) -> None:
        """The reference train step's ``mark``: what follows "forward" is
        the backward."""
        self.backward = phase == "forward"

    def totals(self) -> Dict[str, float]:
        return dict(conv_fwd_s=self.conv_fwd_s, conv_bwd_s=self.conv_bwd_s, dw_s=self.dw_s,
                    flop=self.conv_flop + self.linear_flop)
