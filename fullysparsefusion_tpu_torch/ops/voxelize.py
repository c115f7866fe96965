"""Dynamic voxelization with fixed capacities: a floor-div into voxel
coords plus a fixed-capacity group-by (port of ``ops/voxelize.py``)."""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from .segment import SegmentInfo, unique_segments


def voxel_coords(xyz: torch.Tensor, voxel_size: Sequence[float],
                 pc_range: Sequence[float]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-point integer voxel coords (x, y, z) and in-range mask:
    ``floor((p - range_min) / voxel_size)``, range [min, max), with the
    division as the JAX package's compiled graph does it: XLA folds a
    division by the constant voxel size into a product with its reciprocal
    in the same dtype. The two differ for points exactly on a voxel edge,
    which float16 sweeps (Argoverse 2's) put there."""
    vs = torch.tensor(voxel_size, dtype=xyz.dtype, device=xyz.device)
    lo = torch.tensor(pc_range[:3], dtype=xyz.dtype, device=xyz.device)
    hi = torch.tensor(pc_range[3:6], dtype=xyz.dtype, device=xyz.device)
    coords = torch.floor((xyz - lo) * (1.0 / vs)).to(torch.int32)
    in_range = ((xyz >= lo) & (xyz < hi)).all(dim=-1)
    return coords, in_range


def grid_dims(voxel_size: Sequence[float], pc_range: Sequence[float]) -> Tuple[int, int, int]:
    """Static (nx, ny, nz) grid extents."""
    return tuple(
        int(round((pc_range[i + 3] - pc_range[i]) / voxel_size[i])) for i in range(3)
    )


def linearize_coords(coords_xyz: torch.Tensor, batch_idx: torch.Tensor,
                     dims_xyz: Tuple[int, int, int]) -> torch.Tensor:
    """(batch, z, y, x) → one int32 key, row-major in (b, z, y, x). Keys
    stay below 2³¹ for the grids used here (checked for one sample; callers
    with large batches check ``batch · cells``)."""
    nx, ny, nz = dims_xyz
    if nx * ny * nz >= 2**31:
        raise ValueError("voxel grid too large for int32 keys")
    x, y, z = coords_xyz[..., 0], coords_xyz[..., 1], coords_xyz[..., 2]
    return ((batch_idx.to(torch.int32) * nz + z) * ny + y) * nx + x


def delinearize_coords(keys: torch.Tensor, dims_xyz: Tuple[int, int, int]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of linearize_coords for non-negative keys → (coords [N, 3], batch [N])."""
    nx, ny, nz = dims_xyz
    x = keys % nx
    rest = keys // nx
    y = rest % ny
    rest = rest // ny
    z = rest % nz
    b = rest // nz
    return torch.stack([x, y, z], dim=-1), b


def voxelize_points(xyz, batch_idx, valid, voxel_size, pc_range, capacity
                    ) -> Tuple[SegmentInfo, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Group points into voxels with a fixed capacity.

    Returns (seg, per-point coords, voxel batch [capacity], voxel coords
    [capacity, 3]); unused slots decode key 0.
    """
    coords, in_range = voxel_coords(xyz, voxel_size, pc_range)
    ok = valid & in_range
    dims = grid_dims(voxel_size, pc_range)
    keys = linearize_coords(coords, batch_idx, dims)
    seg = unique_segments(keys, ok, capacity)
    safe_keys = torch.where(seg.seg_valid, seg.unique_keys,
                            torch.zeros_like(seg.unique_keys))
    vox_coords, vox_batch = delinearize_coords(safe_keys, dims)
    return seg, coords, vox_batch, vox_coords


def voxel_downsample(data: Dict[str, torch.Tensor], xyz, batch_idx, valid, voxel_size, pc_range,
                     capacity: int) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
    """Voxel-grid dedup by mean (FSD's pre-voxelize): every array of ``data``
    mean-reduced per voxel. Returns (reduced dict, voxel batch [capacity],
    voxel valid [capacity])."""
    seg, _, vox_batch, _ = voxelize_points(xyz, batch_idx, valid, voxel_size, pc_range, capacity)
    out = {k: seg.mean(v) for k, v in data.items()}
    return out, vox_batch, seg.seg_valid
