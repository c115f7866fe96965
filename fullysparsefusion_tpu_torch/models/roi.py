"""RoI point pooling + FullySparseBboxHead (port of ``models/roi.py``).

Each point keeps its ``rois_per_point`` lowest-index containing RoIs
(enlarged, rotated); memberships are compacted to a fixed capacity with
13-dim geometry per (point, RoI) pair, and ``dropped`` counts the
memberships lost to the per-point cap. Two ways to find them:

- :func:`extract_roi_points` tests every point against every RoI, in RoI
  chunks so the peak is [N, chunk, 3] (the two-stage FSD's pooling);
- :func:`extract_roi_points_grid` rasterizes RoIs onto a coarse BEV cell
  grid (each cell keeps its ``cands_per_cell`` lowest-index covering RoIs)
  and tests each point against its own cell's candidates (FSF's
  refinement).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.geometry import gravity_center, rotate_points_z
from ..ops.segment import segment_max
from ..utils.gather import masked_gather
from .vfe import SIRLayer


class RoiPoints(NamedTuple):
    point_idx: torch.Tensor   # [R] row into the point set
    roi_idx: torch.Tensor     # [R] roi index
    geometry: torch.Tensor    # [R, 13]
    valid: torch.Tensor       # [R]
    # memberships dropped because a point sat inside more than
    # ``rois_per_point`` RoIs, [] i32 (the grid path's RoIs past
    # ``cands_per_cell`` per cell are not counted)
    dropped: torch.Tensor


def _topk_lowest(score: torch.Tensor, k: int, neg: int):
    """The k largest scores of each row (score = −roi index, so the lowest
    roi indices) and their columns: ([N, k] scores, [N, k] columns)."""
    s, cols = torch.sort(score, dim=1, descending=True, stable=True)
    return s[:, :k], cols[:, :k]


def _finalize_pairs(xyz, rois, member_ok, top_idx, extra, capacity, rois_per_point,
                    n_inside) -> RoiPoints:
    sel, sel_valid = masked_gather(member_ok.reshape(-1), capacity)
    point_idx = torch.div(sel, rois_per_point, rounding_mode="floor").long()
    roi_idx = top_idx.reshape(-1)[sel.long()]
    roi_idx = torch.where(sel_valid, roi_idx, torch.zeros_like(roi_idx)).long()
    p = xyz[point_idx]
    r = rois[roi_idx]
    relw = p - gravity_center(r)
    loc = rotate_points_z(relw, -r[:, 6])
    he = (r[:, 3:6] + extra) * 0.5
    ho = r[:, 3:6] * 0.5
    in_margin = (loc.abs() > ho).any(dim=1).to(p.dtype)
    geometry = torch.cat([loc, he - loc, he + loc, in_margin[:, None], relw], dim=1)
    return RoiPoints(
        point_idx=point_idx.to(torch.int32),
        roi_idx=roi_idx.to(torch.int32),
        geometry=geometry * sel_valid[:, None].to(p.dtype),
        valid=sel_valid,
        dropped=(n_inside - member_ok.sum()).to(torch.int32),
    )


def extract_roi_points(xyz, point_batch, point_valid, rois, roi_batch, roi_valid,
                       extra_wlh: Tuple[float, float, float], capacity: int,
                       rois_per_point: int = 2, roi_chunk: int = 64) -> RoiPoints:
    """Membership of points in enlarged rotated RoIs by the all-pairs test,
    ``roi_chunk`` RoIs at a time with a running per-point top
    ``rois_per_point`` (lowest RoI index first), compacted to ``capacity``
    pairs. The pairs equal the JAX package's ``lax.scan`` row for row."""
    q, n = rois.shape[0], xyz.shape[0]
    k = rois_per_point
    extra = torch.tensor(extra_wlh, dtype=xyz.dtype, device=xyz.device)
    # score = −roi index where inside, else ``neg``: the k largest are the
    # k lowest containing indices
    neg = -q - roi_chunk - 1
    top = torch.full((n, k), neg, dtype=torch.int64, device=xyz.device)
    n_inside = torch.zeros((), dtype=torch.int64, device=xyz.device)
    for base in range(0, q, roi_chunk):
        rc = rois[base:base + roi_chunk]
        half = (rc[:, 3:6] + extra) * 0.5
        local = rotate_points_z(xyz[:, None, :] - gravity_center(rc)[None], -rc[None, :, 6])
        inside = (local.abs() <= half[None]).all(dim=-1)
        inside &= point_valid[:, None] & roi_valid[None, base:base + roi_chunk]
        inside &= point_batch[:, None] == roi_batch[None, base:base + roi_chunk]
        n_inside += inside.sum()
        gidx = torch.arange(base, base + rc.shape[0], device=xyz.device)
        score = torch.where(inside, -gidx[None, :], torch.full_like(gidx, neg)[None, :])
        top = torch.topk(torch.cat([top, score], dim=1), k, dim=1).values
    member_ok = top > neg
    top_idx = torch.where(member_ok, -top, torch.zeros_like(top))
    return _finalize_pairs(xyz, rois, member_ok, top_idx, extra, capacity, k, n_inside)


def _roi_grid_raster(rois, roi_batch, roi_valid, extra, nx, ny, batch_size, cell, window,
                     cands_per_cell, bev_lo):
    """Per-cell candidate parameter table [ncells + 1, kc·9]: each
    candidate's (x, y, z, dx, dy, dz, cos yaw, sin yaw, roi index), padded
    with roi index q (no candidate)."""
    q = rois.shape[0]
    dev = rois.device
    ncells = batch_size * nx * ny
    kc = cands_per_cell
    ctr = gravity_center(rois)
    half = (rois[:, 3:6] + extra) * 0.5
    rad = torch.hypot(half[:, 0], half[:, 1])
    ccx = torch.floor((ctr[:, 0] - bev_lo[0]) / cell).to(torch.int32)
    ccy = torch.floor((ctr[:, 1] - bev_lo[1]) / cell).to(torch.int32)
    oi = torch.arange(window, dtype=torch.int32, device=dev) - window // 2
    ox, oy = torch.meshgrid(oi, oi, indexing="ij")
    gx = ccx[:, None] + ox.reshape(-1)[None]
    gy = ccy[:, None] + oy.reshape(-1)[None]
    in_grid = (gx >= 0) & (gx < nx) & (gy >= 0) & (gy < ny)
    cwx = bev_lo[0] + (gx.to(rois.dtype) + 0.5) * cell
    cwy = bev_lo[1] + (gy.to(rois.dtype) + 0.5) * cell
    margin = rad[:, None] + cell * 0.7072
    near = ((cwx - ctr[:, None, 0]).abs() <= margin) & ((cwy - ctr[:, None, 1]).abs() <= margin)
    pair_ok = in_grid & near & roi_valid[:, None]
    cell_id = (roi_batch[:, None].to(torch.int64) * ny + gy) * nx + gx
    # rank within each cell by roi index: sort (cell, roi) pairs
    roi_of = torch.arange(q, device=dev)[:, None].expand_as(cell_id)
    key = torch.where(pair_ok, cell_id * q + roi_of,
                      torch.full_like(cell_id, torch.iinfo(torch.int64).max)).reshape(-1)
    ks = torch.sort(key).values
    ok_s = ks != torch.iinfo(torch.int64).max
    cell_s = torch.div(ks, q, rounding_mode="floor")
    roi_s = ks - cell_s * q
    first = torch.empty_like(ok_s)
    first[:1] = ok_s[:1]
    first[1:] = (cell_s[1:] != cell_s[:-1]) & ok_s[1:]
    pos = torch.arange(ks.shape[0], device=dev)
    start = torch.cummax(torch.where(first, pos, torch.zeros_like(pos)), 0).values
    rank = pos - start
    keep = ok_s & (rank < kc)
    slot = torch.where(keep, cell_s * kc + rank, torch.full_like(rank, ncells * kc))
    table = torch.full((ncells * kc + 1,), q, dtype=torch.int64, device=dev)
    table[slot[keep]] = roi_s[keep]
    aug = torch.cat([
        rois[:, :6].float(), torch.cos(rois[:, 6:7]).float(), torch.sin(rois[:, 6:7]).float(),
        torch.arange(q, dtype=torch.float32, device=dev)[:, None],
    ], dim=1)
    aug = torch.cat([aug, torch.full((1, 9), float(q), device=dev)])
    ptab = aug[table.clamp(0, q)][: ncells * kc].reshape(ncells, kc * 9)
    return torch.cat([ptab, aug[q:].repeat(1, kc)])


def _roi_grid_lookup(xyz, point_batch, point_valid, ptab, q, extra, nx, ny, batch_size, cell,
                     cands_per_cell, k, bev_lo):
    """Per-point candidate test + k lowest-index containing RoIs →
    (member_ok [N, k], top_idx [N, k], inside count [])."""
    ncells = batch_size * nx * ny
    kc = cands_per_cell
    pcx = torch.floor((xyz[:, 0] - bev_lo[0]) / cell).to(torch.int32)
    pcy = torch.floor((xyz[:, 1] - bev_lo[1]) / cell).to(torch.int32)
    p_in = point_valid & (pcx >= 0) & (pcx < nx) & (pcy >= 0) & (pcy < ny)
    pcell = (point_batch * ny + pcy) * nx + pcx
    pcell = torch.where(p_in, pcell, torch.full_like(pcell, ncells))
    r = ptab[pcell.long()].reshape(xyz.shape[0], kc, 9)
    cand = r[..., 8].to(torch.int32)
    cand_ok = (cand < q) & p_in[:, None]
    safe = cand.clamp(0, q - 1)
    rel_x = xyz[:, None, 0] - r[..., 0]
    rel_y = xyz[:, None, 1] - r[..., 1]
    rel_z = xyz[:, None, 2] - (r[..., 2] + r[..., 5] * 0.5)
    cy, sy = r[..., 6], r[..., 7]
    loc_x = rel_x * cy + rel_y * sy
    loc_y = -rel_x * sy + rel_y * cy
    half = (r[..., 3:6] + extra) * 0.5
    inside = ((loc_x.abs() <= half[..., 0]) & (loc_y.abs() <= half[..., 1])
              & (rel_z.abs() <= half[..., 2]) & cand_ok)
    neg = -q - 2
    score = torch.where(inside, -safe, torch.full_like(safe, neg))
    top_scores, cols = _topk_lowest(score, k, neg)
    return top_scores > neg, torch.gather(safe, 1, cols), inside.sum()


def extract_roi_points_grid(xyz, point_batch, point_valid, rois, roi_batch, roi_valid,
                            extra_wlh: Tuple[float, float, float], capacity: int,
                            rois_per_point: int = 2, batch_size: int = 1,
                            bev_lo=(-54.0, -54.0), bev_hi=(54.0, 54.0), cell: float = 2.0,
                            window: int = 11, cands_per_cell: int = 8) -> RoiPoints:
    """Spatial-hash RoI membership with a fixed pair capacity."""
    if rois_per_point > cands_per_cell:
        raise ValueError("rois_per_point cannot exceed cands_per_cell")
    extra = torch.tensor(extra_wlh, dtype=xyz.dtype, device=xyz.device)
    nx = int(np.ceil((bev_hi[0] - bev_lo[0]) / cell))
    ny = int(np.ceil((bev_hi[1] - bev_lo[1]) / cell))
    ptab = _roi_grid_raster(rois, roi_batch, roi_valid, extra, nx, ny, batch_size, cell,
                            window, cands_per_cell, bev_lo)
    member_ok, top_idx, n_inside = _roi_grid_lookup(
        xyz, point_batch, point_valid, ptab, rois.shape[0], extra, nx, ny, batch_size, cell,
        cands_per_cell, rois_per_point, bev_lo)
    return _finalize_pairs(xyz, rois, member_ok, top_idx, extra, capacity, rois_per_point,
                           n_inside)


class FullySparseBboxHead(nn.Module):
    """SIR blocks over RoI groups → per-RoI features; block input is
    cat(point channels, running feats, geometry / 10), rel features the
    13-dim geometry."""

    def __init__(self, point_dim: int, feat_dim: int, num_blocks: int = 3,
                 feat_channels: Sequence[Sequence[int]] = ((128, 128),) * 3,
                 rel_mlp_hidden: Sequence[Sequence[int]] = ((16, 32),) * 3,
                 xyz_normalizer=(20.0, 20.0, 4.0)):
        super().__init__()
        self.num_blocks = num_blocks
        self.xyz_normalizer = tuple(xyz_normalizer)
        d = feat_dim
        for i in range(num_blocks):
            layer = SIRLayer(point_dim + d + 13, 13, feat_channels[i], rel_mlp_hidden[i])
            setattr(self, f"SIRLayer_{i}", layer)
            d = layer.out_point_dim
        self.out_dim = sum(sum(c) for c in feat_channels[:num_blocks])

    def forward(self, points, feats, geometry, roi_idx, valid, num_rois: int):
        seg_id = torch.where(valid, roi_idx, torch.full_like(roi_idx, num_rois))
        norm = torch.tensor(self.xyz_normalizer, dtype=points.dtype, device=points.device)
        pts = torch.cat([points[:, :3] / norm, points[:, 3:]], dim=1)
        out_feats = feats
        clusters = []
        for i in range(self.num_blocks):
            out_feats, c = getattr(self, f"SIRLayer_{i}")(
                torch.cat([pts, out_feats, geometry / 10.0], dim=1), geometry, seg_id, num_rois,
                valid)
            clusters.append(c)
        roi_feats = torch.cat(clusters, dim=1)
        nonempty = segment_max(valid.float(), seg_id, num_rois) > 0
        return roi_feats * nonempty[:, None], nonempty
