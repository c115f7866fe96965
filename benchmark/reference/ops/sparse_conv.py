"""Sparse 3D convolution: active voxels in a fixed-capacity ``SparseTensor``,
rulebooks of per-tap source rows, and the gather convolution that sums
``feats[rows[k]] @ w[k]`` over the 27 taps, with its backward (port of
``ops/sparse_conv.py``).

Weight layout ``w[kz*K*K + ky*K + kx, Cin, Cout]``, cross-correlation:
``out[p] = Σ_k in[p·s − pad + k] @ w[k]``. Rulebook rows are ``[27, n_out]``
int32 with a miss pointing at ``n_src`` (the zero row). Any exact lookup
gives the JAX package's rows, because active sets hold unique coordinates;
here it is one ``searchsorted`` over the sorted active keys.

Frozen copy of the program's module for the benchmark's reference: the
gather convolution and its weight gradient are the plain arithmetic
(:func:`gather_conv_plain`, :func:`dw_per_tap_plain`), with the program's
scatter-free backward around them. The dense path keeps PyTorch's autograd
of ``conv3d``.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, replace
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import precision
from .segment import INVALID_KEY, unique_keys_sorted
from .voxelize import linearize_coords

_KEY_SENTINEL = torch.iinfo(torch.int64).max


@dataclass
class SparseTensor:
    """Fixed-capacity active-voxel set; coords (x, y, z) int32 in [0, dims),
    invalid rows carry arbitrary coords and are masked by ``valid``."""

    feats: torch.Tensor   # [cap, C]
    coords: torch.Tensor  # [cap, 3] i32
    batch: torch.Tensor   # [cap] i32
    valid: torch.Tensor   # [cap] bool
    dims: Tuple[int, int, int]
    batch_size: int = 0

    @property
    def capacity(self) -> int:
        return self.feats.shape[0]

    def replace(self, **kw) -> "SparseTensor":
        return replace(self, **kw)


# ---------------------------------------------------------------------------
# The gather convolution, plain
# ---------------------------------------------------------------------------


def gather_conv_plain(feats: torch.Tensor, rows: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``Σ_k feats_z[rows[k]] @ w[k]`` → [n_out, Cout] f32: bf16 operands
    widened to f32 (their products are exact in f32) and summed per tap in
    f32."""
    n_src, cin = feats.shape
    f_z = torch.cat([feats, feats.new_zeros(1, cin)]).float()
    wf = w.float()
    out = torch.zeros(rows.shape[1], w.shape[2], dtype=torch.float32, device=feats.device)
    for k in range(rows.shape[0]):
        out += f_z[rows[k].long()] @ wf[k]
    return out


class ConvPlan(NamedTuple):
    """A rulebook's hit masks and mask-sorted order. The plain arithmetic
    reads neither; the rulebooks keep them so that the code around them
    stays the program's."""

    masks: torch.Tensor  # [n_out] i32: bit k set iff rows[k, r] hits
    order: torch.Tensor  # [n_out] i32: rows stably sorted by mask


def plan_rulebook(rows: torch.Tensor, n_src: int) -> ConvPlan:
    k3 = rows.shape[0]
    taps = torch.arange(k3, dtype=torch.int32, device=rows.device)[:, None]
    masks = torch.where(rows < n_src, 1 << taps, 0).sum(0, dtype=torch.int32)
    order = torch.sort(masks, stable=True).indices.to(torch.int32)
    return ConvPlan(masks=masks, order=order)


def gather_conv(feats: torch.Tensor, rows: torch.Tensor, w: torch.Tensor,
                plan: Optional[ConvPlan] = None) -> torch.Tensor:
    """The gather convolution in plain arithmetic (:func:`gather_conv_plain`);
    each call is reported to :data:`COUNTERS` for the work count."""
    for hook in COUNTERS:
        hook("gather_conv", feats, rows, w)
    return gather_conv_plain(feats, rows, w)


def dw_per_tap_plain(feats: torch.Tensor, rows: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Weight gradient of a gather conv, ``d_w[k] = f_z[rows[k]]ᵀ @ g``, bf16
    operands widened to f32."""
    n_src, cin = feats.shape
    f_z = torch.cat([feats, feats.new_zeros(1, cin)]).float()
    gf = g.float()
    return torch.stack([f_z[rows[k].long()].T @ gf for k in range(rows.shape[0])])


def dw_per_tap(feats: torch.Tensor, rows: torch.Tensor, g: torch.Tensor,
               plan: Optional[ConvPlan] = None) -> torch.Tensor:
    for hook in COUNTERS:
        hook("dw_per_tap", feats, rows, g)
    return dw_per_tap_plain(feats, rows, g)


# callables (kind, feats, rows, w_or_g) told of every gather convolution;
# the benchmark's work count appends one while it counts
COUNTERS: list = []


# ---------------------------------------------------------------------------
# Rulebooks
# ---------------------------------------------------------------------------


def _linearize64(coords: torch.Tensor, batch: torch.Tensor, dims) -> torch.Tensor:
    nx, ny, nz = dims
    c = coords.long()
    return ((batch.long() * nz + c[..., 2]) * ny + c[..., 1]) * nx + c[..., 0]


def kernel_offsets(kernel_size: Tuple[int, int, int]):
    """(kx, ky, kz) per tap in spconv order (z-major flat index)."""
    kx, ky, kz = kernel_size
    return [(x, y, z) for z in range(kz) for y in range(ky) for x in range(kx)]


def neighbor_rows(coords, batch, valid, dims, q_coords, q_batch, q_valid) -> torch.Tensor:
    """Row of the active set (coords, batch, valid) at each query cell;
    misses (empty cell, invalid query, outside the grid) → capacity."""
    cap = coords.shape[0]
    keys = torch.where(valid, _linearize64(coords, batch, dims),
                       torch.full((cap,), _KEY_SENTINEL, dtype=torch.int64, device=coords.device))
    sorted_keys, perm = torch.sort(keys)
    dims_t = torch.tensor(dims, dtype=q_coords.dtype, device=q_coords.device)
    ok = q_valid & ((q_coords >= 0) & (q_coords < dims_t)).all(dim=-1)
    qk = torch.where(ok, _linearize64(q_coords, q_batch, dims), torch.full_like(ok, -1, dtype=torch.int64))
    pos = torch.searchsorted(sorted_keys, qk.reshape(-1)).reshape(qk.shape).clamp_(max=cap - 1)
    hit = ok & (sorted_keys[pos] == qk)
    return torch.where(hit, perm[pos].to(torch.int32), torch.full_like(pos, cap, dtype=torch.int32))


def build_subm_rulebook(st: SparseTensor, kernel_size=(3, 3, 3)) -> torch.Tensor:
    """Submanifold rulebook rows [K³, cap] int32 (miss → cap)."""
    center = tuple(k // 2 for k in kernel_size)
    offs = torch.tensor([[o[a] - center[a] for a in range(3)] for o in kernel_offsets(kernel_size)],
                        dtype=torch.int32, device=st.coords.device)
    k3 = offs.shape[0]
    q = st.coords[None, :, :] + offs[:, None, :]
    return neighbor_rows(st.coords, st.batch, st.valid, st.dims, q,
                         st.batch.expand(k3, -1), st.valid.expand(k3, -1))


def conv_out_dim(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def downsample_coords(st: SparseTensor, kernel_size, stride, padding, out_capacity):
    """spconv output active set of a strided conv: y is active iff some
    active x and tap k give x = y·s − p + k. Returns (coords [out_cap, 3],
    batch, valid, out_dims) in ascending key order."""
    out_dims = tuple(conv_out_dim(st.dims[a], kernel_size[a], stride[a], padding[a]) for a in range(3))
    nx, ny, nz = out_dims
    if max(st.batch_size, 1) * nx * ny * nz >= 2**31:
        raise ValueError("output grid too large for int32 keys")
    n_cand = [int(np.ceil(kernel_size[a] / stride[a])) for a in range(3)]
    cand_keys, cand_valid = [], []
    for deltas in itertools.product(*(range(c) for c in n_cand)):
        q_axes, ok = [], st.valid
        for a in range(3):
            num = st.coords[:, a] + padding[a]
            q = num // stride[a] - deltas[a]
            k = num - q * stride[a]
            ok = ok & (k >= 0) & (k < kernel_size[a]) & (q >= 0)
            q_axes.append(q)
        q = torch.stack(q_axes, dim=-1)
        ok = ok & (q[:, 0] < nx) & (q[:, 1] < ny) & (q[:, 2] < nz)
        cand_keys.append(torch.where(ok, linearize_coords(q, st.batch, out_dims),
                                     torch.full_like(ok, INVALID_KEY, dtype=torch.int32)))
        cand_valid.append(ok)
    uniq, seg_valid, _ = unique_keys_sorted(torch.cat(cand_keys), torch.cat(cand_valid), out_capacity)
    safe = torch.where(seg_valid, uniq, torch.zeros_like(uniq))
    x = safe % nx
    rest = safe // nx
    y = rest % ny
    rest = rest // ny
    z = rest % nz
    bb = rest // nz
    return torch.stack([x, y, z], dim=-1).to(torch.int32), bb.to(torch.int32), seg_valid, out_dims


def pair_query_rows(coords, batch, valid, tgt_coords, tgt_batch, tgt_valid, tgt_dims,
                    kernel_size, stride, padding, mode: str) -> torch.Tensor:
    """Per-tap rows [K³, n] between a strided conv's two active sets.

    mode 'mul': query coord·s − pad + o_k (fine set looked up from coarse
    queries); 'div': (coord + pad − o_k)/s with exact division (coarse set
    looked up from fine queries). Misses → target capacity.
    """
    offs = torch.tensor(kernel_offsets(kernel_size), dtype=torch.int32, device=coords.device)
    k3 = offs.shape[0]
    sv = torch.tensor(stride, dtype=torch.int32, device=coords.device)
    pv = torch.tensor(padding, dtype=torch.int32, device=coords.device)
    if mode == "mul":
        q = coords[None, :, :] * sv - pv + offs[:, None, :]
        ok = valid.expand(k3, -1)
    elif mode == "div":
        num = coords[None, :, :] + pv - offs[:, None, :]
        q = torch.div(num, sv, rounding_mode="floor")
        ok = valid[None, :] & (num - q * sv == 0).all(dim=-1)
    else:
        raise ValueError(mode)
    return neighbor_rows(tgt_coords, tgt_batch, tgt_valid, tgt_dims, q, batch.expand(k3, -1), ok)


# ---------------------------------------------------------------------------
# Convolutions
# ---------------------------------------------------------------------------


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return precision.low_bf16(x).to(torch.bfloat16).contiguous()


# a conv's backward rulebook: rows [K³, n_in] into its output rows, and K1's plan of them
BwdRows = Callable[[], Tuple[torch.Tensor, ConvPlan]]


class GatherConvFunction(torch.autograd.Function):
    """``gather_conv(feats, rows, w) · out_valid`` with the scatter-free
    backward of the JAX package's ``_subm_conv_core`` / ``_pair_conv_core``:

    * ``g`` is masked by ``out_valid`` and cast to bf16;
    * ``d_feats = gather_conv(g, *bwd_rows(), wᵀ)`` (K1 with the transposed
      weights, contiguous), masked by ``in_valid`` unless it is None
      (submanifold), returned in the input's dtype;
    * ``d_w = dw_per_tap(feats, rows, g)`` through the forward plan, f32.

    ``bwd_rows`` makes the backward rulebook and its plan on the first
    backward only, so a forward without gradient never pays for it.
    """

    @staticmethod
    def forward(ctx, feats, w, rows, plan: ConvPlan, out_valid, in_valid,
                bwd_rows: BwdRows):
        f16, w16 = _bf16(feats), _bf16(w)
        out = gather_conv(f16, rows, w16, plan)
        out = out * out_valid[:, None].to(out.dtype)
        ctx.save_for_backward(f16, w16, rows, plan.masks, plan.order, out_valid, in_valid)
        ctx.feats_dtype, ctx.w_dtype, ctx.bwd_rows = feats.dtype, w.dtype, bwd_rows
        return out

    @staticmethod
    def backward(ctx, g):
        f16, w16, rows, masks, order, out_valid, in_valid = ctx.saved_tensors
        g16 = _bf16(g * out_valid[:, None].to(g.dtype))
        d_feats = d_w = None
        if ctx.needs_input_grad[0]:
            b_rows, b_plan = ctx.bwd_rows()
            d_feats = gather_conv(g16, b_rows, w16.transpose(1, 2).contiguous(), b_plan)
            if in_valid is not None:
                d_feats = d_feats * in_valid[:, None].to(d_feats.dtype)
            d_feats = d_feats.to(ctx.feats_dtype)
        if ctx.needs_input_grad[1]:
            d_w = dw_per_tap(f16, rows, g16, ConvPlan(masks=masks, order=order)).to(ctx.w_dtype)
        return d_feats, d_w, None, None, None, None, None


def mirror_rows(rows: torch.Tensor, n_src: int) -> Tuple[torch.Tensor, ConvPlan]:
    """A submanifold rulebook's mirrored rows ``rows.flip(0)`` (the tap set
    is symmetric, o_{K³−1−k} = −o_k) and their K1 plan: the rulebook of the
    submanifold conv's input gradient."""
    m = rows.flip(0).contiguous()
    return m, plan_rulebook(m, n_src)


def subm_conv_apply(feats, valid, rows, w, plan: ConvPlan,
                    bwd_rows: Optional[BwdRows] = None) -> torch.Tensor:
    """Submanifold conv through a prebuilt rulebook and its plan: bf16
    operands, f32 accumulation, output masked by validity. ``bwd_rows``
    gives the mirrored rulebook and plan (a stage shares one); by default
    the backward makes them."""
    if bwd_rows is None:
        def bwd_rows():
            return mirror_rows(rows, rows.shape[1])
    return GatherConvFunction.apply(feats, w, rows, plan, valid, None, bwd_rows)


def sparse_conv3d(st: SparseTensor, w, kernel_size, stride, padding, out_capacity) -> SparseTensor:
    """Strided sparse conv generating a new active set: out[y] = Σ_k in[y·s − p + k] @ w[k]."""
    out_coords, out_batch, out_valid, out_dims = downsample_coords(
        st, kernel_size, stride, padding, out_capacity)
    rows = pair_query_rows(out_coords, out_batch, out_valid, st.coords, st.batch, st.valid,
                           st.dims, kernel_size, stride, padding, "mul")

    def bwd_rows():   # input x ← output (x + p − o_k) / s
        r = pair_query_rows(st.coords, st.batch, st.valid, out_coords, out_batch, out_valid,
                            out_dims, kernel_size, stride, padding, "div")
        return r, plan_rulebook(r, out_capacity)

    out = GatherConvFunction.apply(st.feats, w, rows, plan_rulebook(rows, st.capacity),
                                   out_valid, st.valid, bwd_rows)
    return SparseTensor(feats=out, coords=out_coords, batch=out_batch, valid=out_valid,
                        dims=out_dims, batch_size=st.batch_size)


def sparse_inverse_conv3d(st: SparseTensor, target: SparseTensor, w, kernel_size, stride,
                          padding) -> SparseTensor:
    """Inverse conv onto a recorded finer active set: target t receives
    from coarse y where t = y·s − p + k."""
    rows = pair_query_rows(target.coords, target.batch, target.valid, st.coords, st.batch,
                           st.valid, st.dims, kernel_size, stride, padding, "div")

    def bwd_rows():   # coarse y ← fine y·s − p + o_k
        r = pair_query_rows(st.coords, st.batch, st.valid, target.coords, target.batch,
                            target.valid, target.dims, kernel_size, stride, padding, "mul")
        return r, plan_rulebook(r, target.capacity)

    out = GatherConvFunction.apply(st.feats, w, rows, plan_rulebook(rows, st.capacity),
                                   target.valid, st.valid, bwd_rows)
    return target.replace(feats=out)


# dense path: at deep stages the active set fills much of a small grid;
# scattering to a dense grid and running conv3d computes the same sums


# dense activation budget: B·X·Y·Z·C elements
DENSE_CONV_MAX_ELEMS = 192 * 1024 * 1024


def use_dense_conv(st: SparseTensor, cout: int, min_occupancy: float = 0.15) -> bool:
    """Dense path when capacity / cells ≥ ``min_occupancy`` (Python floats,
    as the JAX package computes it) and the dense grid fits the budget."""
    nx, ny, nz = st.dims
    if st.batch_size <= 0:
        return False
    cells = st.batch_size * nx * ny * nz
    occ = st.capacity / cells
    elems = cells * max(st.feats.shape[-1], cout)
    return occ >= min_occupancy and elems <= DENSE_CONV_MAX_ELEMS


def _to_dense(st: SparseTensor) -> torch.Tensor:
    """[B, C, Z, Y, X] grid holding the valid rows' features."""
    nx, ny, nz = st.dims
    cells = st.batch_size * nx * ny * nz
    c = st.feats.shape[-1]
    keys = torch.where(st.valid, _linearize64(st.coords, st.batch, st.dims).clamp(0, cells - 1),
                       torch.full_like(st.valid, cells, dtype=torch.int64))
    dense = st.feats.new_zeros(cells + 1, c)
    dense[keys] = st.feats * st.valid[:, None].to(st.feats.dtype)
    return dense[:cells].reshape(st.batch_size, nz, ny, nx, c).permute(0, 4, 1, 2, 3)


def _dense_conv(dense, w, kernel_size, stride, padding) -> torch.Tensor:
    """bf16 conv3d (bf16 in and out, as the JAX package), widened to f32;
    returns [B, Cout, Z', Y', X']."""
    kx, ky, kz = kernel_size
    cin, cout = w.shape[1], w.shape[2]
    kern = w.reshape(kz, ky, kx, cin, cout).permute(4, 3, 0, 1, 2)
    out = F.conv3d(precision.low_bf16(dense).to(torch.bfloat16),
                   precision.low_bf16(kern).to(torch.bfloat16),
                   stride=(stride[2], stride[1], stride[0]),
                   padding=(padding[2], padding[1], padding[0]))
    return out.float()


def _from_dense(dense, coords, batch, valid, dims) -> torch.Tensor:
    b, c = dense.shape[:2]
    flat = dense.permute(0, 2, 3, 4, 1).reshape(-1, c)
    keys = _linearize64(coords, batch, dims).clamp(0, flat.shape[0] - 1)
    return flat[keys] * valid[:, None].to(flat.dtype)


def subm_conv_dense(st: SparseTensor, w, kernel_size=(3, 3, 3)) -> torch.Tensor:
    """Submanifold conv via dense scatter → conv3d → gather back."""
    pad = tuple(k // 2 for k in kernel_size)
    for hook in COUNTERS:
        hook("dense_conv", st.feats, build_subm_rulebook(st, kernel_size), w)
    out = _dense_conv(_to_dense(st), w, kernel_size, (1, 1, 1), pad)
    return _from_dense(out, st.coords, st.batch, st.valid, st.dims)


def sparse_conv3d_dense(st: SparseTensor, w, kernel_size, stride, padding,
                        out_capacity) -> SparseTensor:
    """Strided sparse conv via the dense path (same output active set)."""
    out_coords, out_batch, out_valid, out_dims = downsample_coords(
        st, kernel_size, stride, padding, out_capacity)
    for hook in COUNTERS:
        hook("dense_conv", st.feats, pair_query_rows(
            out_coords, out_batch, out_valid, st.coords, st.batch, st.valid, st.dims,
            kernel_size, stride, padding, "mul"), w)
    out = _dense_conv(_to_dense(st), w, kernel_size, stride, padding)
    y = _from_dense(out, out_coords, out_batch, out_valid, out_dims)
    return SparseTensor(feats=y, coords=out_coords, batch=out_batch, valid=out_valid,
                        dims=out_dims, batch_size=st.batch_size)
