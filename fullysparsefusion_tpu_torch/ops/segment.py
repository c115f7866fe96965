"""Fixed-capacity segment (group-by) operations.

``unique_segments(keys, valid, capacity)`` sorts the masked int32 keys once
and gives each element a compact segment id in ``[0, capacity)``, in
ascending key order; invalid elements and overflow segments go to the trash
segment ``capacity``, which no reduction returns. Same contract as the JAX
package's ``ops/segment.py``.

Sums and means go through the op ``fsf::segment_sum`` (``ops/library.py``):
on a CUDA tensor the kernel of ``csrc/segment.cu``, on a CPU tensor
:func:`segment_sum_plain`. Both add each segment's rows in ascending row
order, from 0, in f32, so the two agree bitwise and a repeat is bitwise. The
kernel reads the segments as CSR: ``order``, the rows stably sorted by
segment id (the trash rows last, never read), and ``offsets``, where segment
``s`` is ``order[offsets[s]:offsets[s + 1]]``. ``unique_segments`` keeps both
from its own sort (:meth:`SegmentInfo.sum` / :meth:`SegmentInfo.mean`);
:func:`segment_sum` / :func:`segment_mean` take bare ids and make them with
one stable sort. Neither reads anything back to the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

# Sentinel for "no key" — sorts to the end.
INVALID_KEY = torch.iinfo(torch.int32).max


@dataclass
class SegmentInfo:
    """seg_id [N] i32 (``capacity`` = trash), unique_keys [capacity] i32
    (INVALID_KEY for unused slots), counts [capacity] i32, num_segments []
    i32 (may exceed capacity), seg_valid [capacity] bool; the CSR of
    ``seg_id`` that :meth:`sum` and :meth:`mean` read: order [N] i32 and
    offsets [capacity + 1] i32."""

    seg_id: torch.Tensor
    unique_keys: torch.Tensor
    counts: torch.Tensor
    num_segments: torch.Tensor
    seg_valid: torch.Tensor
    order: torch.Tensor
    offsets: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.unique_keys.shape[0]

    def sum(self, feat: torch.Tensor) -> torch.Tensor:
        """Sum-reduce rows of ``feat`` by segment → [capacity, ...]."""
        return torch.ops.fsf.segment_sum(feat, self.seg_id, self.order, self.offsets)

    def mean(self, feat: torch.Tensor) -> torch.Tensor:
        """Mean-reduce rows of ``feat`` by segment (empty segments → 0)."""
        return _mean(self.sum(feat), self.counts)


def _boundaries(ks: torch.Tensor) -> torch.Tensor:
    """First element of each run of equal valid keys in a sorted vector."""
    ok = ks != INVALID_KEY
    first = torch.empty_like(ok)
    first[:1] = ok[:1]
    first[1:] = (ks[1:] != ks[:-1]) & ok[1:]
    return first


def unique_segments(keys: torch.Tensor, valid: torch.Tensor, capacity: int) -> SegmentInfo:
    """Compact group-by over int32 keys with a fixed segment capacity —
    ``torch.unique(keys[valid], return_inverse=True, return_counts=True)``
    with fixed output shapes."""
    n = keys.shape[0]
    masked = torch.where(valid, keys.to(torch.int32),
                         torch.full_like(keys, INVALID_KEY, dtype=torch.int32))
    ks, order = torch.sort(masked, stable=True)
    first = _boundaries(ks)
    ranks = torch.cumsum(first.to(torch.int32), 0, dtype=torch.int32) - 1
    num_segments = first.sum(dtype=torch.int32)
    seg_sorted = torch.where((ks != INVALID_KEY) & (ranks < capacity), ranks,
                             torch.full_like(ranks, capacity))
    seg_id = torch.empty(n, dtype=torch.int32, device=keys.device)
    seg_id[order] = seg_sorted
    offsets = _offsets(seg_sorted, capacity)
    unique_keys = torch.full((capacity + 1,), INVALID_KEY, dtype=torch.int32,
                             device=keys.device)
    unique_keys[seg_sorted.long()] = ks
    unique_keys = unique_keys[:capacity]
    counts = torch.bincount(seg_id.long(), minlength=capacity + 1)[:capacity]
    return SegmentInfo(
        seg_id=seg_id,
        unique_keys=unique_keys,
        counts=counts.to(torch.int32),
        num_segments=num_segments,
        seg_valid=unique_keys != INVALID_KEY,
        order=order.to(torch.int32),
        offsets=offsets,
    )


def unique_keys_sorted(keys: torch.Tensor, valid: torch.Tensor, capacity: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Ascending unique keys only: (unique_keys [capacity] i32, seg_valid
    [capacity] bool, num_segments [] i32); overflow past ``capacity`` drops
    the highest keys."""
    masked = torch.where(valid, keys.to(torch.int32),
                         torch.full_like(keys, INVALID_KEY, dtype=torch.int32))
    ks = torch.sort(masked).values
    first = _boundaries(ks)
    incl = torch.cumsum(first.to(torch.int32), 0, dtype=torch.int32)
    num_segments = incl[-1]
    ranks = incl - 1
    slot = torch.where(first & (ranks < capacity), ranks,
                       torch.full_like(ranks, capacity))
    unique_keys = torch.full((capacity + 1,), INVALID_KEY, dtype=torch.int32,
                             device=keys.device)
    unique_keys[slot.long()] = ks
    unique_keys = unique_keys[:capacity]
    return unique_keys, unique_keys != INVALID_KEY, num_segments


def _expand_index(seg_id: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
    idx = seg_id.long()
    return idx.view((-1,) + (1,) * (feat.dim() - 1)).expand_as(feat)


def _counts(seg_id: torch.Tensor, capacity: int) -> torch.Tensor:
    return torch.bincount(seg_id.long(), minlength=capacity + 1)[:capacity]


def _offsets(sorted_ids: torch.Tensor, capacity: int) -> torch.Tensor:
    """[capacity + 1] i32: where each segment's run starts in ascending
    int32 ids (the last entry: where the trash run starts)."""
    bounds = torch.arange(capacity + 1, dtype=torch.int32, device=sorted_ids.device)
    return torch.searchsorted(sorted_ids, bounds, out_int32=True)


def _csr(seg_id: torch.Tensor, capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(order [N] i32, offsets [capacity + 1] i32) of ids in ``[0,
    capacity]``: one stable sort."""
    ids, order = torch.sort(seg_id.to(torch.int32), stable=True)
    return order.to(torch.int32), _offsets(ids, capacity)


def segment_sum_plain(feat: torch.Tensor, seg_id: torch.Tensor, capacity: int) -> torch.Tensor:
    """Plain version of ``fsf::segment_sum``: ``index_add_`` into ``capacity +
    1`` rows, the trash row dropped. On the CPU it adds the rows one by one
    in row order, so each segment's sum runs in ascending row order from 0,
    whatever the thread count (``index_put_(accumulate=True)`` adds with
    atomics from several threads past 32,768 elements)."""
    out = feat.new_zeros((capacity + 1,) + feat.shape[1:])
    return out.index_add_(0, seg_id.long(), feat)[:capacity]


def segment_sum(feat: torch.Tensor, seg_id: torch.Tensor, capacity: int) -> torch.Tensor:
    """Sum-reduce rows of ``feat`` by segment id; returns [capacity, ...].
    Each segment's rows are added in ascending row order, from 0, so a
    request run twice gives bitwise the same output. Takes f32 on a CUDA
    tensor (and raises on other dtypes there)."""
    return torch.ops.fsf.segment_sum(feat, seg_id, *_csr(seg_id, capacity))


# counted by the op's CUDA implementation (ops/library.py), one per launch
segment_sum.launches = 0


def _mean(sums: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    denom = torch.clamp(counts.to(sums.dtype), min=1)
    return sums / denom.view((-1,) + (1,) * (sums.dim() - 1))


def segment_mean(feat: torch.Tensor, seg_id: torch.Tensor, capacity: int,
                 counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean-reduce rows of ``feat`` by segment id (empty segments → 0)."""
    if counts is None:
        counts = _counts(seg_id, capacity)
    return _mean(segment_sum(feat, seg_id, capacity), counts)


def _segment_extreme(feat, seg_id, capacity, empty_value, reduce):
    fill = float("-inf") if reduce == "amax" else float("inf")
    out = feat.new_full((capacity + 1,) + feat.shape[1:], fill)
    out.scatter_reduce_(0, _expand_index(seg_id, feat), feat, reduce=reduce,
                        include_self=True)
    out = out[:capacity]
    nonempty = (_counts(seg_id, capacity) > 0).view(
        (-1,) + (1,) * (feat.dim() - 1))
    return torch.where(nonempty, out, torch.full_like(out, empty_value))


def segment_max(feat: torch.Tensor, seg_id: torch.Tensor, capacity: int,
                empty_value: float = 0.0) -> torch.Tensor:
    """Max-reduce rows of ``feat`` by segment id (empty segments → empty_value)."""
    return _segment_extreme(feat, seg_id, capacity, empty_value, "amax")


def segment_min(feat: torch.Tensor, seg_id: torch.Tensor, capacity: int,
                empty_value: float = 0.0) -> torch.Tensor:
    """Min-reduce rows of ``feat`` by segment id (empty segments → empty_value)."""
    return _segment_extreme(feat, seg_id, capacity, empty_value, "amin")


def ingroup_indices(group_ids: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per-element running index within its group (0..k-1) in element
    order; invalid elements get -1."""
    n = group_ids.shape[0]
    masked = torch.where(valid, group_ids.to(torch.int32),
                         torch.full_like(group_ids, INVALID_KEY, dtype=torch.int32))
    gs, order = torch.sort(masked, stable=True)
    first = torch.ones_like(gs, dtype=torch.bool)
    first[1:] = gs[1:] != gs[:-1]
    pos = torch.arange(n, dtype=torch.int32, device=group_ids.device)
    start = torch.cummax(torch.where(first, pos, torch.zeros_like(pos)), 0).values
    inner = torch.empty(n, dtype=torch.int32, device=group_ids.device)
    inner[order] = pos - start
    return torch.where(valid, inner, torch.full_like(inner, -1))


# registers the fsf ops; last, since the op library's modules import names of
# this one
from . import library  # noqa: E402,F401
