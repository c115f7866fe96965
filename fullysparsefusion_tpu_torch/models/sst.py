"""SST, the single-stride sparse transformer backbone (port of
``models/sst.py``).

voxel features → Dense + in-window position embedding → N blocks of
pre-LN multi-head attention inside windows + FFN, alternating the regular
and the half-shifted window partition. Tokens live in padded
[windows_cap, max_tokens, C] tensors with masks (``ops/window.py``). The
modules follow flax's defaults: LayerNorm ε 1e-6, the tanh ``gelu``, and
masked logits set to the dtype's lowest finite value (a window with no
valid token gets a uniform softmax, not NaN).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.window import flat_to_window, window_partition, window_position_embedding, window_to_flat
from .layers import LayerNorm


class MultiHeadDotProductAttention(nn.Module):
    """flax's ``MultiHeadDotProductAttention`` (self-attention, biased):
    ``query`` / ``key`` / ``value`` / ``out`` projections, queries scaled by
    1/√head_dim, softmax in f32."""

    def __init__(self, dim: int, num_heads: int, qkv_features: int):
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Linear(dim, qkv_features)
        self.key = nn.Linear(dim, qkv_features)
        self.value = nn.Linear(dim, qkv_features)
        self.out = nn.Linear(qkv_features, dim)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x [W, T, C], mask [W, T] (keys a query may attend to)."""
        w, t, _ = x.shape
        heads = (self.query(x), self.key(x), self.value(x))
        q, k, v = (h.reshape(w, t, self.num_heads, -1) for h in heads)
        q = q / math.sqrt(q.shape[-1])
        logits = torch.einsum("wqhd,wkhd->whqk", q, k)
        logits = logits.masked_fill(~mask[:, None, None, :], torch.finfo(logits.dtype).min)
        y = torch.einsum("whqk,wkhd->wqhd", torch.softmax(logits, dim=-1), v)
        return self.out(y.reshape(w, t, -1))


class WindowAttentionBlock(nn.Module):
    """Pre-LN window MHA + FFN over padded window tokens; padding slots
    stay as they came in."""

    def __init__(self, dim: int = 128, num_heads: int = 8, ffn_dim: int = 256):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(dim, eps=1e-6)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(dim, num_heads, dim)
        self.LayerNorm_1 = LayerNorm(dim, eps=1e-6)
        self.Dense_0 = nn.Linear(dim, ffn_dim)
        self.Dense_1 = nn.Linear(ffn_dim, dim)

    def forward(self, tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """tokens [W, T, C], mask [W, T]."""
        m = mask[..., None].to(tokens.dtype)
        y = self.MultiHeadDotProductAttention_0(self.LayerNorm_0(tokens), mask)
        tokens = tokens + y * m
        z = self.Dense_1(F.gelu(self.Dense_0(self.LayerNorm_1(tokens)), approximate="tanh"))
        return tokens + z * m


class SSTBackbone(nn.Module):
    """Shifted-window sparse transformer over active voxels: voxel features
    [cap, C_in] + coords [cap, 3] → per-voxel features [cap, dim] on the
    same active set (invalid rows 0)."""

    def __init__(self, in_dim: int, dim: int = 128, num_blocks: int = 4, num_heads: int = 8,
                 sparse_shape: Tuple[int, int, int] = (512, 512, 1),
                 window_shape: Tuple[int, int, int] = (16, 16, 1), max_tokens: int = 128,
                 windows_cap: int = 1024):
        super().__init__()
        self.dim, self.num_blocks = dim, num_blocks
        self.sparse_shape, self.window_shape = tuple(sparse_shape), tuple(window_shape)
        self.max_tokens, self.windows_cap = max_tokens, windows_cap
        self.Dense_0 = nn.Linear(in_dim, dim)
        for i in range(num_blocks):
            setattr(self, f"block_{i}", WindowAttentionBlock(dim, num_heads, dim * 2))

    def partitions(self, coords, batch, valid):
        """The regular and the shifted ``WindowPartition``."""
        return [window_partition(coords, batch, valid, self.sparse_shape, self.window_shape,
                                 shift, self.windows_cap) for shift in (False, True)]

    def forward(self, feats, coords, batch, valid) -> torch.Tensor:
        vmask = valid[:, None].to(feats.dtype)
        x = self.Dense_0(feats)
        x = (x + window_position_embedding(coords, None, self.window_shape, self.dim)) * vmask
        parts = self.partitions(coords, batch, valid)
        for i in range(self.num_blocks):
            part = parts[i % 2]
            tokens, mask = flat_to_window(x, part, valid, self.max_tokens)
            tokens = getattr(self, f"block_{i}")(tokens, mask)
            x = window_to_flat(tokens, part, valid, self.max_tokens) * vmask
        return x
