"""Sparse 3D UNet — the segmentor backbone (port of ``models/sparse_unet.py``).

Encoder stage 0 is submanifold only; stages ≥ 1 start with a strided conv
that makes a coarser active set. The decoder merges each stage with its
encoder skip (concat + submanifold convs) and inverse-convs onto the next
finer active set. Every conv is conv → BN → ReLU, and activations are cast to
bf16 between convs, as in the JAX package. A stage whose occupancy reaches
``dense_min_occupancy`` runs its submanifold convs (and a strided conv that
reads from it) through the dense conv3d path; every other conv goes through
the gather-conv kernel.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.sparse_conv import (
    ConvPlan, SparseTensor, build_subm_rulebook, mirror_rows, plan_rulebook, sparse_conv3d,
    sparse_conv3d_dense, sparse_inverse_conv3d, subm_conv_apply, subm_conv_dense,
    use_dense_conv,
)
from .layers import MaskedBatchNorm


class SubmRulebook:
    """A stage's submanifold rulebook rows; their K1 plan is made at the
    first gather conv that uses them and shared by the stage's other convs
    (a dense stage never makes it). Likewise the mirrored rows and their
    plan, which every backward conv of the stage gathers through, are made
    at the first backward and shared."""

    def __init__(self, st: SparseTensor):
        self.rows = build_subm_rulebook(st)
        self.n_src = st.capacity
        self._plan: Optional[ConvPlan] = None
        self._mirror: Optional[Tuple[torch.Tensor, ConvPlan]] = None

    @property
    def plan(self) -> ConvPlan:
        if self._plan is None:
            self._plan = plan_rulebook(self.rows, self.n_src)
        return self._plan

    def mirror(self) -> Tuple[torch.Tensor, ConvPlan]:
        if self._mirror is None:
            self._mirror = mirror_rows(self.rows, self.n_src)
        return self._mirror


class _ConvBlock(nn.Module):
    """Weight ``w [27, Cin, Cout]`` + BN + ReLU; the subclasses pick the conv."""

    def __init__(self, cin: int, cout: int, kernel_size=(3, 3, 3)):
        super().__init__()
        self.kernel_size = tuple(kernel_size)
        k3 = kernel_size[0] * kernel_size[1] * kernel_size[2]
        self.w = nn.Parameter(torch.zeros(k3, cin, cout))
        self.MaskedBatchNorm_0 = MaskedBatchNorm(cout)
        self.cout = cout

    def _finish(self, out: SparseTensor) -> SparseTensor:
        y = F.relu(self.MaskedBatchNorm_0(out.feats, out.valid)) * out.valid[:, None].float()
        return out.replace(feats=y.to(torch.bfloat16))


class SubMBlock(_ConvBlock):
    """Submanifold conv through the stage's shared rulebook and its plan."""

    def __init__(self, cin, cout, dense_min_occupancy=0.15, **kw):
        super().__init__(cin, cout, **kw)
        self.dense_min_occupancy = dense_min_occupancy

    def forward(self, st: SparseTensor, rulebook: "SubmRulebook") -> SparseTensor:
        if use_dense_conv(st, self.cout, self.dense_min_occupancy):
            y = subm_conv_dense(st, self.w, self.kernel_size)
        else:
            y = subm_conv_apply(st.feats, st.valid, rulebook.rows, self.w, rulebook.plan,
                                rulebook.mirror)
        return self._finish(st.replace(feats=y))


class DownBlock(_ConvBlock):
    def __init__(self, cin, cout, padding, out_capacity, stride=(2, 2, 2),
                 dense_min_occupancy=0.15, **kw):
        super().__init__(cin, cout, **kw)
        self.padding = tuple(padding)
        self.stride = tuple(stride)
        self.out_capacity = out_capacity
        self.dense_min_occupancy = dense_min_occupancy

    def forward(self, st: SparseTensor) -> SparseTensor:
        conv = (sparse_conv3d_dense if use_dense_conv(st, self.cout, self.dense_min_occupancy)
                else sparse_conv3d)
        out = conv(st, self.w, self.kernel_size, self.stride, self.padding, self.out_capacity)
        return self._finish(out)


class UpBlock(_ConvBlock):
    def __init__(self, cin, cout, padding, stride=(2, 2, 2), **kw):
        super().__init__(cin, cout, **kw)
        self.padding = tuple(padding)
        self.stride = tuple(stride)

    def forward(self, st: SparseTensor, target: SparseTensor) -> SparseTensor:
        out = sparse_inverse_conv3d(st, target, self.w, self.kernel_size, self.stride,
                                    self.padding)
        return self._finish(out)


class SparseUNet(nn.Module):
    """Encoder-decoder sparse UNet returning f32 features on the input set."""

    def __init__(self, in_channels: int, in_capacity: int, base_channels: int = 64,
                 output_channels: int = 128,
                 encoder_channels: Sequence[Sequence[int]] = (
                     (128,), (128, 128, 128), (128, 128, 128), (256, 256, 256), (512, 512, 512)),
                 encoder_strided_paddings: Sequence[Tuple[int, int, int]] = (
                     (1, 1, 1), (1, 1, 1), (1, 1, 0), (1, 1, 1)),
                 decoder_channels: Sequence[Sequence[int]] = (
                     (512, 512, 256), (256, 256, 128), (128, 128, 128), (128, 128, 128)),
                 stage_capacity_divisors: Sequence[int] = (1, 1, 2, 4, 8),
                 stage_capacities: Optional[Sequence[int]] = None,
                 dense_min_occupancy: float = 0.15):
        super().__init__()
        self.encoder_channels = [tuple(w) for w in encoder_channels]
        self.decoder_channels = [tuple(w) for w in decoder_channels]
        self.paddings = [tuple(p) for p in encoder_strided_paddings]
        occ = dict(dense_min_occupancy=dense_min_occupancy)
        self.conv_input = SubMBlock(in_channels, base_channels, **occ)
        d = base_channels
        stage_out: List[int] = []
        for i, widths in enumerate(self.encoder_channels):
            for j, c in enumerate(widths):
                if i > 0 and j == 0:
                    out_cap = (int(stage_capacities[i]) if stage_capacities is not None
                               else max(128, in_capacity // stage_capacity_divisors[i]))
                    setattr(self, f"enc{i}_down",
                            DownBlock(d, c, self.paddings[i - 1], out_cap, **occ))
                else:
                    setattr(self, f"enc{i}_subm{j}", SubMBlock(d, c, **occ))
                d = c
            stage_out.append(d)
        n_stages = len(self.encoder_channels)
        x_dim = stage_out[-1]
        for dd in range(n_stages - 1):
            enc_stage = n_stages - 1 - dd
            widths = self.decoder_channels[dd]
            y = x_dim + stage_out[enc_stage]
            for j, c in enumerate(widths[:-1]):
                setattr(self, f"dec{dd}_subm{j}", SubMBlock(y, c, **occ))
                y = c
            setattr(self, f"dec{dd}_up",
                    UpBlock(y, widths[-1], self.paddings[enc_stage - 1]))
            x_dim = widths[-1]
        self.conv_out = SubMBlock(x_dim + stage_out[0], output_channels, **occ)

    def forward(self, st: SparseTensor) -> torch.Tensor:
        rulebooks = [SubmRulebook(st)]
        st = self.conv_input(st, rulebooks[0])
        skips = []
        n_stages = len(self.encoder_channels)
        for i, widths in enumerate(self.encoder_channels):
            for j in range(len(widths)):
                if i > 0 and j == 0:
                    st = getattr(self, f"enc{i}_down")(st)
                    rulebooks.append(SubmRulebook(st))
                else:
                    st = getattr(self, f"enc{i}_subm{j}")(st, rulebooks[i])
            skips.append(st)

        x = skips[-1]
        for d in range(n_stages - 1):
            enc_stage = n_stages - 1 - d
            y = x.replace(feats=torch.cat([x.feats, skips[enc_stage].feats], dim=1))
            for j in range(len(self.decoder_channels[d]) - 1):
                y = getattr(self, f"dec{d}_subm{j}")(y, rulebooks[enc_stage])
            x = getattr(self, f"dec{d}_up")(y, skips[enc_stage - 1])

        merged = x.replace(feats=torch.cat([x.feats, skips[0].feats], dim=1))
        return self.conv_out(merged, rulebooks[0]).feats.float()
