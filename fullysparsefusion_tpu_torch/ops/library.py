"""The port's CUDA kernels as ``torch.library`` custom ops, namespace ``fsf``.

One op per C entry point of ``kernels.KERNELS``, each with an implementation
per device and a fake one:

====================  =====================================  ==========================
op                    CUDA (``csrc/``)                       CPU (plain version)
====================  =====================================  ==========================
``fsf::gather_conv``  ``gather_conv.cu`` (K1)                ``sparse_conv.gather_conv_plain``
``fsf::dw_work_list`` ``gather_conv_dw.cu`` (its list)       ``sparse_conv.dw_work_list_plain``
``fsf::gather_conv_dw`` ``gather_conv_dw.cu``                ``sparse_conv.dw_per_tap_plain``
``fsf::ccl_roots``    ``ccl.cu`` (K2)                        ``ccl.ccl_roots_plain``
``fsf::nms_keep``     ``nms.cu`` (K3)                        ``nms.nms_keep_plain``
``fsf::segment_sum``  ``segment.cu``                         ``segment.segment_sum_plain``
====================  =====================================  ==========================

``fsf::segment_sum`` adds each segment's rows in ascending row order, from 0,
in f32, on both devices: the kernel equals the plain version bitwise. Its
gradient (``register_autograd``) is the gather of the output's gradient by
segment id, 0 for the trash rows.

The dispatcher picks the implementation by the inputs' device: a CUDA
tensor runs the kernel, a CPU tensor the plain version, and nothing else
is registered. The fake implementations give each output's shape and dtype,
so ``torch.export`` traces through the ops and an exported program calls
them. The public wrappers (``sparse_conv.gather_conv`` / ``dw_per_tap`` /
``dw_work_list``, ``ccl.ccl_roots``, ``nms.nms_keep``) check dtypes, shapes
and devices and call these ops; the checks that need storage (contiguity,
16-byte alignment) are here, in the CUDA implementations, which also count
each launch on the wrapper's ``.launches``, so an exported program's
launches count too. ``segment.segment_sum`` / ``segment_mean`` and
``SegmentInfo.sum`` / ``mean`` call ``fsf::segment_sum``, whose CUDA
implementation checks the dtypes (f32 rows, int32 CSR) and counts on
``segment.segment_sum.launches``.

This module imports no model code: a serving process imports it alone to
load and run an exported ``.pt2`` (it also registers the containers of
``utils.containers`` as pytree nodes, the exported programs' inputs).
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from .. import kernels
from ..utils import containers  # noqa: F401 (the containers as pytree nodes)
from . import ccl, nms, segment, sparse_conv


def kernel_launches() -> Dict[str, int]:
    """The kernels' launch counters (each CUDA implementation counts its
    launches on its wrapper)."""
    return {"gather_conv": sparse_conv.gather_conv.launches, "ccl_roots": ccl.ccl_roots.launches,
            "nms_keep": nms.nms_keep.launches, "dw_per_tap": sparse_conv.dw_per_tap.launches,
            "segment_sum": segment.segment_sum.launches}


def launches_since(before: Dict[str, int]) -> Dict[str, int]:
    now = kernel_launches()
    return {k: now[k] - before[k] for k in now}


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _contiguous(what: str, *ts: torch.Tensor) -> None:
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{what}: inputs must be contiguous")


# ---------------------------------------------------------------------------
# K1: the gather convolution
# ---------------------------------------------------------------------------


@torch.library.custom_op("fsf::gather_conv", mutates_args=(), device_types="cpu")
def gather_conv(feats: torch.Tensor, rows: torch.Tensor, w: torch.Tensor, order: torch.Tensor,
                masks: torch.Tensor) -> torch.Tensor:
    """``Σ_k feats_z[rows[k]] @ w[k]`` → [n_out, Cout] f32 (the plan's
    ``order`` and ``masks`` are the kernel's; the plain version needs
    neither)."""
    return sparse_conv.gather_conv_plain(feats, rows, w)


@gather_conv.register_kernel("cuda")
def _gather_conv_cuda(feats, rows, w, order, masks):
    _contiguous("gather_conv", feats, rows, w, order, masks)
    if feats.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("gather_conv: feats and w must be 16-byte aligned")
    (n_src, cin), (k3, n_out), cout = feats.shape, rows.shape, w.shape[2]
    out = torch.empty(n_out, cout, dtype=torch.float32, device=feats.device)
    kernels.launch("gather_conv", feats.data_ptr(), n_src, cin, rows.data_ptr(), n_out, k3,
                   w.data_ptr(), cout, order.data_ptr(), masks.data_ptr(), out.data_ptr(),
                   _stream(feats))
    sparse_conv.gather_conv.launches += 1
    return out


@gather_conv.register_fake
def _gather_conv_fake(feats, rows, w, order, masks):
    return feats.new_empty(rows.shape[1], w.shape[2], dtype=torch.float32)


# ---------------------------------------------------------------------------
# dw_per_tap: the gather convolution's weight gradient, and its work list
# ---------------------------------------------------------------------------


@torch.library.custom_op("fsf::dw_work_list", mutates_args=(), device_types="cpu")
def dw_work_list(masks: torch.Tensor, order: torch.Tensor, k3: int,
                 n_chunks: int) -> torch.Tensor:
    """The dw kernel's work list of a rulebook's plan, as the int32 buffer
    that ``sparse_conv.DwWork`` views."""
    return sparse_conv.dw_work_list_plain(masks, order, k3, n_chunks)


@dw_work_list.register_kernel("cuda")
def _dw_work_list_cuda(masks, order, k3, n_chunks):
    _contiguous("dw_work_list", masks, order)
    n_out = order.shape[0]
    buf = torch.empty(sparse_conv.dw_work_size(n_out, k3, n_chunks), dtype=torch.int32,
                      device=order.device)
    kernels.launch("gather_conv_dw_list", masks.data_ptr(), order.data_ptr(), n_out, k3,
                   n_chunks, buf.data_ptr(), _stream(order))
    return buf


@dw_work_list.register_fake
def _dw_work_list_fake(masks, order, k3, n_chunks):
    return order.new_empty(sparse_conv.dw_work_size(order.shape[0], k3, n_chunks))


@torch.library.custom_op("fsf::gather_conv_dw", mutates_args=(), device_types="cpu")
def gather_conv_dw(feats: torch.Tensor, rows: torch.Tensor, g: torch.Tensor,
                   order: torch.Tensor, work: torch.Tensor, n_chunks: int) -> torch.Tensor:
    """``d_w[k] = f_z[rows[k]]ᵀ @ g`` → [K³, Cin, Cout] f32 over the work
    list ``work`` of ``n_chunks`` slots (the plain version needs neither it
    nor ``order``)."""
    return sparse_conv.dw_per_tap_plain(feats, rows, g)


@gather_conv_dw.register_kernel("cuda")
def _gather_conv_dw_cuda(feats, rows, g, order, work, n_chunks):
    _contiguous("dw_per_tap", feats, rows, g, order, work)
    if feats.data_ptr() % 16 or g.data_ptr() % 16:
        raise ValueError("dw_per_tap: feats and g must be 16-byte aligned")
    (n_src, cin), (k3, n_out), cout = feats.shape, rows.shape, g.shape[1]
    part = torch.empty(n_chunks, cin, cout, dtype=torch.float32, device=feats.device)
    out = torch.empty(k3, cin, cout, dtype=torch.float32, device=feats.device)
    kernels.launch("gather_conv_dw", feats.data_ptr(), n_src, cin, rows.data_ptr(), n_out, k3,
                   g.data_ptr(), cout, order.data_ptr(), n_chunks, sparse_conv.dw_tile_n(cout),
                   work.data_ptr(), part.data_ptr(), out.data_ptr(), _stream(feats))
    sparse_conv.dw_per_tap.launches += 1
    return out


@gather_conv_dw.register_fake
def _gather_conv_dw_fake(feats, rows, g, order, work, n_chunks):
    return feats.new_empty(rows.shape[0], feats.shape[1], g.shape[1], dtype=torch.float32)


# ---------------------------------------------------------------------------
# K2: connected-component roots
# ---------------------------------------------------------------------------


@torch.library.custom_op("fsf::ccl_roots", mutates_args=(), device_types="cpu")
def ccl_roots(xy: torch.Tensor, batch: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Each node's component minimum (-1 invalid) → [G, N] i32."""
    return ccl.ccl_roots_plain(xy, batch, valid)


@ccl_roots.register_kernel("cuda")
def _ccl_roots_cuda(xy, batch, valid):
    _contiguous("ccl_roots", xy, batch, valid)
    g, n = valid.shape
    # scratch of the adjacency pass: bits[g, i, w], bit b set iff 32 w + b > i
    # is adjacent to i
    bits = torch.empty(g, n, (n + 31) // 32, dtype=torch.int32, device=xy.device)
    # union-find's parent[] where it does not fit in shared memory; apart from
    # roots, so that only a node's own thread writes its root
    parent = torch.empty(g, n, dtype=torch.int32, device=xy.device)
    roots = torch.empty(g, n, dtype=torch.int32, device=xy.device)
    kernels.launch("ccl", xy.data_ptr(), batch.data_ptr(), valid.data_ptr(), g, n,
                   bits.data_ptr(), parent.data_ptr(), roots.data_ptr(), _stream(xy))
    ccl.ccl_roots.launches += 1
    return roots


@ccl_roots.register_fake
def _ccl_roots_fake(xy, batch, valid):
    return batch.new_empty(valid.shape)


# ---------------------------------------------------------------------------
# K3: the greedy NMS scan
# ---------------------------------------------------------------------------


@torch.library.custom_op("fsf::nms_keep", mutates_args=(), device_types="cpu")
def nms_keep(iou: torch.Tensor, order: torch.Tensor, valid_sorted: torch.Tensor,
             iou_thr: float) -> torch.Tensor:
    """Greedy NMS keep masks in each class's sorted order → [C, N] bool."""
    return nms.nms_keep_plain(iou, order, valid_sorted, iou_thr)


@nms_keep.register_kernel("cuda")
def _nms_keep_cuda(iou, order, valid_sorted, iou_thr):
    _contiguous("nms_keep", iou, order, valid_sorted)
    c, n = order.shape
    words = (n + 63) // 64
    # scratch of the bitmask pass: mask[c, i, w], 64 later rows per word
    mask = torch.empty(c, 64 * words, words, dtype=torch.int64, device=iou.device)
    keep = torch.empty(c, n, dtype=torch.bool, device=iou.device)
    kernels.launch("nms", iou.data_ptr(), order.data_ptr(), valid_sorted.data_ptr(), c, n,
                   float(iou_thr), mask.data_ptr(), keep.data_ptr(), _stream(iou))
    nms.nms_keep.launches += 1
    return keep


@nms_keep.register_fake
def _nms_keep_fake(iou, order, valid_sorted, iou_thr):
    return valid_sorted.new_empty(order.shape)


# ---------------------------------------------------------------------------
# Sorted segment sum
# ---------------------------------------------------------------------------


@torch.library.custom_op("fsf::segment_sum", mutates_args=(), device_types="cpu")
def segment_sum(feat: torch.Tensor, seg_id: torch.Tensor, order: torch.Tensor,
                offsets: torch.Tensor) -> torch.Tensor:
    """Rows of ``feat`` summed by ``seg_id`` → [capacity, ...], capacity =
    ``len(offsets) - 1``, the trash id ``capacity`` dropped (the CSR
    ``order`` / ``offsets`` is the kernel's; the plain version needs
    neither)."""
    return segment.segment_sum_plain(feat, seg_id, offsets.shape[0] - 1)


@segment_sum.register_kernel("cuda")
def _segment_sum_cuda(feat, seg_id, order, offsets):
    if feat.dtype != torch.float32 or order.dtype != torch.int32 \
            or offsets.dtype != torch.int32:
        raise TypeError("segment_sum takes f32 feat and int32 order and offsets on a CUDA "
                        f"tensor, not {feat.dtype}, {order.dtype}, {offsets.dtype}")
    _contiguous("segment_sum", order, offsets)
    n, cap = feat.shape[0], offsets.shape[0] - 1
    width = math.prod(feat.shape[1:])
    rows = feat.reshape(n, width)
    if width > 1 and rows.stride(1) != 1:
        rows = rows.contiguous()
    out = torch.empty((cap,) + feat.shape[1:], dtype=torch.float32, device=feat.device)
    if out.numel():
        kernels.launch("segment_sum", rows.data_ptr(), rows.stride(0), width, order.data_ptr(),
                       offsets.data_ptr(), cap, out.data_ptr(), _stream(feat))
        segment.segment_sum.launches += 1
    return out


@segment_sum.register_fake
def _segment_sum_fake(feat, seg_id, order, offsets):
    return feat.new_empty((offsets.shape[0] - 1,) + feat.shape[1:])


def _segment_sum_setup(ctx, inputs, output):
    ctx.save_for_backward(inputs[1])


def _segment_sum_backward(ctx, grad):
    (seg_id,) = ctx.saved_tensors
    padded = torch.cat([grad, grad.new_zeros((1,) + grad.shape[1:])])
    return padded[seg_id.long()], None, None, None


segment_sum.register_autograd(_segment_sum_backward, setup_context=_segment_sum_setup)
