"""Sparse 3D convolution: active voxels in a fixed-capacity ``SparseTensor``,
rulebooks of per-tap source rows, and the gather convolution that sums
``feats[rows[k]] @ w[k]`` over the 27 taps, with its backward (port of
``ops/sparse_conv.py``).

Weight layout ``w[kz*K*K + ky*K + kx, Cin, Cout]``, cross-correlation:
``out[p] = Σ_k in[p·s − pad + k] @ w[k]``. Rulebook rows are ``[27, n_out]``
int32 with a miss pointing at ``n_src`` (the zero row). Any exact lookup
gives the JAX package's rows, because active sets hold unique coordinates;
here it is one ``searchsorted`` over the sorted active keys.

:func:`gather_conv` is the K1 kernel's wrapper, through the op
``fsf::gather_conv`` (``ops/library.py``): CUDA tensors launch
``csrc/gather_conv.cu``, CPU tensors run :func:`gather_conv_plain`. The kernel
takes a rulebook's :class:`ConvPlan` (each output row's hit mask and the rows
sorted by it), made once per rulebook by :func:`plan_rulebook` and shared by
every conv that uses the rulebook.

The gather-path convs are ``torch.autograd.Function``s with the JAX
package's scatter-free backward: the input gradient is K1 again, through
the mirrored rulebook ``rows.flip(0)`` (submanifold) or the inverse-query
rows of :func:`pair_query_rows` (strided: 'div', inverse: 'mul'), with the
weights transposed; the weight gradient is :func:`dw_per_tap`
(``csrc/gather_conv_dw.cu`` on the card). The dense path keeps PyTorch's
autograd of ``conv3d``.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, replace
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import library  # noqa: F401 (registers the fsf ops)
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
# K1: the gather convolution
# ---------------------------------------------------------------------------


def gather_conv_plain(feats: torch.Tensor, rows: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`gather_conv`: bf16 operands widened to f32
    (their products are exact in f32) and summed per tap in f32."""
    n_src, cin = feats.shape
    f_z = torch.cat([feats, feats.new_zeros(1, cin)]).float()
    wf = w.float()
    out = torch.zeros(rows.shape[1], w.shape[2], dtype=torch.float32, device=feats.device)
    for k in range(rows.shape[0]):
        out += f_z[rows[k].long()] @ wf[k]
    return out


# output rows per block of the kernel: a tile of the plan's order
TILE_ROWS = 128


class ConvPlan(NamedTuple):
    """What the K1 kernel needs of a rulebook beyond its rows."""

    masks: torch.Tensor  # [n_out] i32: bit k set iff rows[k, r] hits
    order: torch.Tensor  # [n_out] i32: rows stably sorted by mask


def _check_plan(what: str, plan: ConvPlan, n_out: int, device) -> None:
    for t in plan:
        if t.dtype != torch.int32 or t.shape != (n_out,) or t.device != device:
            raise ValueError(f"{what}: plan masks and order must be int32 [n_out] on the device")


def plan_rulebook(rows: torch.Tensor, n_src: int) -> ConvPlan:
    """Hit masks and mask-sorted order of a rulebook ``rows [K³, n_out]``
    (miss → ``n_src``). Sorting by mask puts rows that hit the same taps in
    the same tile of ``TILE_ROWS``, so a tile skips every tap none of its
    rows hits; rows with no hit (capacity padding) sort first, into tiles
    that do no tap at all. Torch glue, made once per rulebook; it keeps no
    tensor between calls, so a trace (``torch.export``) leaves nothing
    behind for a later call."""
    k3 = rows.shape[0]
    if k3 > 31:
        raise ValueError(f"plan_rulebook: at most 31 taps fit an int32 mask, got {k3}")
    plan_rulebook.calls += 1
    taps = torch.arange(k3, dtype=torch.int32, device=rows.device)[:, None]
    masks = torch.where(rows < n_src, 1 << taps, 0).sum(0, dtype=torch.int32)
    order = torch.sort(masks, stable=True).indices.to(torch.int32)
    return ConvPlan(masks=masks, order=order)


plan_rulebook.calls = 0


def gather_conv(feats: torch.Tensor, rows: torch.Tensor, w: torch.Tensor,
                plan: Optional[ConvPlan] = None) -> torch.Tensor:
    """``Σ_k feats_z[rows[k]] @ w[k]`` → [n_out, Cout] f32.

    feats [n_src, Cin] bf16, rows [K³, n_out] i32 (miss → n_src), w [K³,
    Cin, Cout] bf16; ``plan`` is ``plan_rulebook(rows, n_src)``, made here
    when not given. The op ``fsf::gather_conv``: on a CUDA tensor it
    launches the gather-conv kernel (Cin and Cout multiples of 8, contiguous
    inputs, feats and w 16-byte aligned); on a CPU tensor it runs
    :func:`gather_conv_plain`. The caller masks by out-validity.
    """
    if feats.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError("gather_conv takes bf16 feats and w")
    if rows.dtype != torch.int32:
        raise TypeError("gather_conv takes int32 rows")
    if feats.dim() != 2 or rows.dim() != 2 or w.dim() != 3:
        raise ValueError("gather_conv: feats [n, Cin], rows [K3, n_out], w [K3, Cin, Cout]")
    k3, n_out = rows.shape
    n_src, cin = feats.shape
    if w.shape[0] != k3 or w.shape[1] != cin:
        raise ValueError(f"gather_conv: w {tuple(w.shape)} does not match rows/feats")
    cout = w.shape[2]
    if feats.device.type not in ("cpu", "cuda") or rows.device != feats.device \
            or w.device != feats.device:
        raise ValueError("gather_conv: all tensors on one CUDA device (or the CPU)")
    if feats.device.type == "cuda" and (cin % 8 or cout % 8):
        raise ValueError(f"gather_conv kernel needs Cin, Cout % 8 == 0, got {cin}, {cout}")
    if plan is None:
        plan = plan_rulebook(rows, n_src)
    _check_plan("gather_conv", plan, n_out, feats.device)
    return torch.ops.fsf.gather_conv(feats, rows, w, plan.order, plan.masks)


# counted by the op's CUDA implementation (ops/library.py), one per launch
gather_conv.launches = 0


def dw_per_tap_plain(feats: torch.Tensor, rows: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`dw_per_tap`: bf16 operands widened to f32,
    then per tap a gather and a matmul, ``f_z[rows[k]]ᵀ @ g``."""
    n_src, cin = feats.shape
    f_z = torch.cat([feats, feats.new_zeros(1, cin)]).float()
    gf = g.float()
    return torch.stack([f_z[rows[k].long()].T @ gf for k in range(rows.shape[0])])


# the dw kernel's block: 128 Cin (two warpgroups) x dw_tile_n(cout) Cout of one tap
DW_TILE_M = 128


def dw_tile_n(cout: int) -> int:
    """Cout tile of the dw kernel's block: the narrowest of 64 / 128 / 256
    that covers Cout (256 past it)."""
    return 256 if cout > 128 else (128 if cout > 64 else 64)


def dw_chunk_slots(cin: int, cout: int, sms: int, k3: int) -> int:
    """Chunk slots of the dw kernel's grid: as many blocks as fit on the
    card at once (two an SM at a Cout tile of 64 or 128, one at 256, as the
    kernel's ``Ring<BN>::BLOCKS_PER_SM`` sizes its shared memory) for every
    (Cin tile, Cout tile) block of a chunk, so the chunks run in one wave;
    at least one slot per tap."""
    bn = dw_tile_n(cout)
    blocks = -(-cin // DW_TILE_M) * -(-cout // bn)
    return max(k3, sms * (2 if bn <= 128 else 1) // blocks)


class DwWork(NamedTuple):
    """The dw kernel's work list: views of one int32 buffer, in the layout
    of ``csrc/gather_conv_dw.cu``'s ``WorkList``."""

    tile_mask: torch.Tensor   # [tiles]: OR of the masks of each TILE_ROWS rows of order
    tap_tiles: torch.Tensor   # [K³]: hit tiles of each tap
    tiles: torch.Tensor       # [K³·tiles]: tap 0's hit tiles ascending, then tap 1's, …; -1 after
    chunks: torch.Tensor      # [n_chunks, 3]: (tap, first position in tiles, tiles); 0s past the end
    tap_chunks: torch.Tensor  # [K³, 2]: each tap's first chunk and its number of chunks
    buf: torch.Tensor         # the int32 buffer that the fields above view, in that order


def dw_work_size(n_out: int, k3: int, n_chunks: int) -> int:
    """Length of the int32 buffer of :class:`DwWork`."""
    n_tiles = -(-n_out // TILE_ROWS)
    return n_tiles + k3 + k3 * n_tiles + 3 * n_chunks + 2 * k3


def _dw_views(buf: torch.Tensor, n_out: int, k3: int, n_chunks: int) -> DwWork:
    n_tiles = -(-n_out // TILE_ROWS)
    t_mask, t_tiles, t_list, t_chunks, t_tap_chunks = torch.split(
        buf, (n_tiles, k3, k3 * n_tiles, 3 * n_chunks, 2 * k3))
    return DwWork(t_mask, t_tiles, t_list, t_chunks.view(n_chunks, 3), t_tap_chunks.view(k3, 2),
                  buf)


def dw_work_list_plain(masks: torch.Tensor, order: torch.Tensor, k3: int,
                       n_chunks: int) -> torch.Tensor:
    """Plain version of the work-list kernels: :func:`dw_work_list`'s buffer
    from a plan's ``masks`` and ``order``, in torch glue."""
    dev = order.device
    n_out = order.shape[0]
    n_tiles = -(-n_out // TILE_ROWS)
    work = _dw_views(torch.empty(dw_work_size(n_out, k3, n_chunks), dtype=torch.int32,
                                 device=dev), n_out, k3, n_chunks)
    m = F.pad(masks[order.long()], (0, n_tiles * TILE_ROWS - n_out))
    m = m.view(n_tiles, TILE_ROWS)
    while m.shape[1] > 1:                           # OR over each tile, by halves
        h = m.shape[1] // 2
        m = m[:, :h] | m[:, h:]
    work.tile_mask.copy_(m[:, 0])
    taps = torch.arange(k3, device=dev, dtype=torch.int32)
    hit = ((work.tile_mask[None, :] >> taps[:, None]) & 1).bool()    # [K³, tiles]
    cnt = hit.sum(1)
    work.tap_tiles.copy_(cnt)
    flat = hit.flatten()
    slot = torch.where(flat, torch.cumsum(flat, 0) - 1, flat.numel())  # misses: a spare slot
    ids = torch.arange(n_tiles, device=dev, dtype=torch.int32).repeat(k3)
    tiles = torch.full((flat.numel() + 1,), -1, dtype=torch.int32, device=dev)
    work.tiles.copy_(tiles.scatter_(0, slot, ids)[:-1])
    # the least per in [1, tiles + 1] whose chunks fit the slots
    pers = torch.arange(1, n_tiles + 2, device=dev)
    need = ((cnt[None, :] + pers[:, None] - 1) // pers[:, None]).sum(1)
    per = pers[torch.argmax((need <= n_chunks).int())]
    n_ck = (cnt + per - 1) // per
    ends = torch.cumsum(n_ck, 0)
    first = ends - n_ck
    j = torch.arange(n_chunks, device=dev)
    tap = torch.searchsorted(ends, j, right=True).clamp(max=k3 - 1)
    c = j - first[tap]
    rows = torch.stack([tap, (torch.cumsum(cnt, 0) - cnt)[tap] + c * per,
                        torch.minimum(per, cnt[tap] - c * per)], 1)
    work.chunks.copy_(torch.where((j < ends[-1])[:, None], rows, 0))
    work.tap_chunks.copy_(torch.stack([first, n_ck], 1))
    return work.buf


def dw_work_list(plan: ConvPlan, k3: int, n_chunks: int) -> DwWork:
    """For each tap, the tiles of ``TILE_ROWS`` rows of ``plan.order`` in
    which some row hits it (by the OR of the tile's masks), cut into chunks
    of ``per`` tiles (a tap's last chunk shorter), ``per`` the least length
    that keeps the chunks within ``n_chunks`` (≥ K³) slots. The op
    ``fsf::dw_work_list``: on a CUDA plan it launches the dw kernel's list
    kernels, on a CPU plan it runs :func:`dw_work_list_plain`. Nothing is
    read back to the host."""
    n_out = plan.order.shape[0]
    if not 1 <= k3 <= 31 or n_chunks < k3:
        raise ValueError(f"dw_work_list: 1 <= K3 <= 31 and n_chunks >= K3, got {k3}, {n_chunks}")
    if plan.order.device.type not in ("cpu", "cuda"):
        raise ValueError("dw_work_list: a plan on a CUDA device (or the CPU)")
    _check_plan("dw_work_list", plan, n_out, plan.order.device)
    buf = torch.ops.fsf.dw_work_list(plan.masks, plan.order, k3, n_chunks)
    return _dw_views(buf, n_out, k3, n_chunks)


def dw_per_tap(feats: torch.Tensor, rows: torch.Tensor, g: torch.Tensor,
               plan: Optional[ConvPlan] = None) -> torch.Tensor:
    """Weight gradient of a gather conv: ``d_w[k] = Σ_r feats_z[rows[k, r]]ᵀ ⊗
    g[r]`` → [K³, Cin, Cout] f32.

    feats [n_src, Cin] bf16 (the forward's input), rows [K³, n_out] i32 (the
    forward's rulebook, miss → n_src), g [n_out, Cout] bf16 (the output's
    gradient, masked by validity); ``plan`` is the forward rulebook's
    ``plan_rulebook(rows, n_src)``, made here when not given. The work list
    of :func:`dw_work_list`, then the op ``fsf::gather_conv_dw`` over it: on
    a CUDA tensor the ``gather_conv_dw`` kernels (the product, the chunks'
    sum; Cin and Cout multiples of 8, contiguous inputs) with a scratch of
    ``dw_chunk_slots(…) · Cin · Cout`` f32 for the chunks' partial sums
    (17.3 MB at 128 × 128 on an H100); on a CPU tensor
    :func:`dw_per_tap_plain`, which reads neither plan nor list."""
    if feats.dtype != torch.bfloat16 or g.dtype != torch.bfloat16:
        raise TypeError("dw_per_tap takes bf16 feats and g")
    if rows.dtype != torch.int32:
        raise TypeError("dw_per_tap takes int32 rows")
    if feats.dim() != 2 or rows.dim() != 2 or g.dim() != 2 or g.shape[0] != rows.shape[1]:
        raise ValueError("dw_per_tap: feats [n, Cin], rows [K3, n_out], g [n_out, Cout]")
    k3, n_out = rows.shape
    n_src, cin = feats.shape
    cout = g.shape[1]
    dev = feats.device
    if dev.type not in ("cpu", "cuda") or rows.device != dev or g.device != dev:
        raise ValueError("dw_per_tap: all tensors on one CUDA device (or the CPU)")
    if dev.type == "cuda" and (cin % 8 or cout % 8):
        raise ValueError(f"dw_per_tap kernel needs Cin, Cout % 8 == 0, got {cin}, {cout}")
    if not 1 <= k3 <= 31:
        raise ValueError(f"dw_per_tap kernel takes 1 <= K3 <= 31 taps, got {k3}")
    if plan is None:
        plan = plan_rulebook(rows, n_src)
    _check_plan("dw_per_tap", plan, n_out, dev)
    # a CPU list feeds only the plain version, which ignores it: the least slots
    sms = torch.cuda.get_device_properties(dev).multi_processor_count if dev.type == "cuda" else 0
    n_chunks = dw_chunk_slots(cin, cout, sms, k3)
    work = dw_work_list(plan, k3, n_chunks)
    return torch.ops.fsf.gather_conv_dw(feats, rows, g, plan.order, work.buf, n_chunks)


# counted by the op's CUDA implementation (ops/library.py), one per launch
dw_per_tap.launches = 0


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
    return x.to(torch.bfloat16).contiguous()


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
    out = F.conv3d(dense.to(torch.bfloat16), kern.to(torch.bfloat16),
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
    out = _dense_conv(_to_dense(st), w, kernel_size, (1, 1, 1), pad)
    return _from_dense(out, st.coords, st.batch, st.valid, st.dims)


def sparse_conv3d_dense(st: SparseTensor, w, kernel_size, stride, padding,
                        out_capacity) -> SparseTensor:
    """Strided sparse conv via the dense path (same output active set)."""
    out_coords, out_batch, out_valid, out_dims = downsample_coords(
        st, kernel_size, stride, padding, out_capacity)
    out = _dense_conv(_to_dense(st), w, kernel_size, stride, padding)
    y = _from_dense(out, out_coords, out_batch, out_valid, out_dims)
    return SparseTensor(feats=y, coords=out_coords, batch=out_batch, valid=out_valid,
                        dims=out_dims, batch_size=st.batch_size)
