"""Box geometry (port of the inference part of ``ops/geometry.py``).

Boxes are ``[x, y, z_bottom, dx, dy, dz, yaw(, vx, vy)]`` with the origin at
the bottom center. The rotated BEV IoU clips one quad by the other's four
half-planes (Sutherland–Hodgman) in fixed 16-slot buffers, as the JAX
package does, so the float operations happen in the same order.
"""
from __future__ import annotations

import torch


def gravity_center(boxes: torch.Tensor) -> torch.Tensor:
    """[N, 7+] bottom-origin boxes → [N, 3] gravity centers."""
    return torch.stack([boxes[..., 0], boxes[..., 1], boxes[..., 2] + boxes[..., 5] * 0.5], dim=-1)


def enlarge_boxes(boxes: torch.Tensor, extra_wlh, extra_height: float = 0.0) -> torch.Tensor:
    """Grow dims by ``extra_wlh`` keeping the gravity center fixed; the
    height grows by ``extra_height`` more, downwards and upwards alike."""
    extra = torch.as_tensor(extra_wlh, dtype=boxes.dtype, device=boxes.device)
    dims = boxes[..., 3:6] + extra
    z = boxes[..., 2] - extra[..., 2] * 0.5 - extra_height * 0.5
    dz = dims[..., 2] + extra_height
    return torch.cat([boxes[..., :2], z[..., None], dims[..., :2], dz[..., None], boxes[..., 6:]],
                     dim=-1)


def rotate_points_z(points: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rotate [..., 3] (or [..., 2]) points by ``angle`` around +z."""
    c, s = torch.cos(angle), torch.sin(angle)
    x = points[..., 0] * c - points[..., 1] * s
    y = points[..., 0] * s + points[..., 1] * c
    if points.shape[-1] == 2:
        return torch.stack([x, y], dim=-1)
    return torch.stack([x, y, points[..., 2].expand_as(x)], dim=-1)


def points_in_boxes(points: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """[N, M] bool: point i inside rotated box j (bounds inclusive, 1e-6 slack)."""
    rel = points[:, None, :] - gravity_center(boxes)[None, :, :]
    local = rotate_points_z(rel, -boxes[None, :, 6])
    return (local.abs() <= boxes[None, :, 3:6] * 0.5 + 1e-6).all(dim=-1)


def box_corners_bev(boxes: torch.Tensor) -> torch.Tensor:
    """[N, 7+] → [N, 4, 2] BEV corner polygons (counter-clockwise)."""
    dx, dy = boxes[..., 3], boxes[..., 4]
    sx = torch.stack([dx, dx, -dx, -dx], dim=-1) * 0.5
    sy = torch.stack([-dy, dy, dy, -dy], dim=-1) * 0.5
    rot = rotate_points_z(torch.stack([sx, sy], dim=-1), boxes[..., None, 6])
    return rot + boxes[..., None, :2]


def _polygon_area(pts, n_valid, cap):
    idx = torch.arange(cap, device=pts.device)
    valid = idx < n_valid[..., None]
    wrap = (idx + 1) == n_valid[..., None]
    x, y = pts[..., 0], pts[..., 1]
    xn = torch.where(wrap, x[..., :1], torch.roll(x, -1, dims=-1))
    yn = torch.where(wrap, y[..., :1], torch.roll(y, -1, dims=-1))
    cross = x * yn - xn * y
    return (0.5 * torch.where(valid, cross, torch.zeros_like(cross)).sum(-1)).abs()


def _clip_by_halfplane(pts, n_valid, a, b, c, cap):
    """Clip polygon (pts [..., cap, 2], n_valid) by a·x + b·y + c ≥ 0."""
    idx = torch.arange(cap, device=pts.device)
    wrap = (idx + 1) == n_valid[..., None]
    d = a[..., None] * pts[..., 0] + b[..., None] * pts[..., 1] + c[..., None]
    d_n = torch.where(wrap, d[..., :1], torch.roll(d, -1, dims=-1))
    p_n = torch.where(wrap[..., None], pts[..., :1, :], torch.roll(pts, -1, dims=-2))
    inside = d >= 0
    inside_n = d_n >= 0
    den = d - d_n
    t = d / torch.where(den.abs() < 1e-12, torch.full_like(den, 1e-12), den)
    inter = pts + t[..., None] * (p_n - pts)
    valid_edge = idx < n_valid[..., None]
    emit_cur = inside & valid_edge
    emit_int = (inside != inside_n) & valid_edge
    out_count = emit_cur.to(torch.int64) + emit_int.to(torch.int64)
    # exclusive prefix sum over the cap slots as cap - 1 adds: CUDA's scan
    # along this short innermost dim was the slowest kernel of a whole
    # request (tools/profile_torch_request.py)
    offs = torch.zeros_like(out_count)
    for i in range(1, cap):
        offs[..., i] = offs[..., i - 1] + out_count[..., i - 1]
    new_n = offs[..., -1] + out_count[..., -1]
    tgt_cur = torch.where(emit_cur, offs, torch.full_like(offs, cap - 1))
    tgt_int = torch.where(emit_int, offs + emit_cur.to(torch.int64), torch.full_like(offs, cap - 1))
    out = torch.zeros_like(pts)
    zero = torch.zeros_like(pts)
    out.scatter_add_(-2, tgt_cur[..., None].expand_as(pts),
                     torch.where(emit_cur[..., None], pts, zero))
    out.scatter_add_(-2, tgt_int[..., None].expand_as(pts),
                     torch.where(emit_int[..., None], inter, zero))
    # slot cap-1 collects masked writes; it is never read (≤ 8 vertices)
    return out, new_n.clamp(max=cap - 1)


def rotated_rect_intersection_area(c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """Intersection area of BEV rectangles given as [..., 4, 2] ccw quads."""
    cap = 16
    pts = torch.cat([c1, c1.new_zeros(c1.shape[:-2] + (cap - 4, 2))], dim=-2)
    n = torch.full(c1.shape[:-2], 4, dtype=torch.int64, device=c1.device)
    for i in range(4):
        p = c2[..., i, :]
        q = c2[..., (i + 1) % 4, :]
        a = q[..., 1] - p[..., 1]
        b = p[..., 0] - q[..., 0]
        cc = -(a * p[..., 0] + b * p[..., 1])
        pts, n = _clip_by_halfplane(pts, n, -a, -b, -cc, cap)
    return _polygon_area(pts, n, cap)


def _ensure_ccw(corners: torch.Tensor) -> torch.Tensor:
    x, y = corners[..., 0], corners[..., 1]
    area2 = (x * torch.roll(y, -1, dims=-1) - torch.roll(x, -1, dims=-1) * y).sum(-1)
    return torch.where((area2 < 0)[..., None, None], corners.flip(-2), corners)


def boxes_iou_bev(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Rotated BEV IoU matrix [N, M]."""
    c1 = _ensure_ccw(box_corners_bev(boxes1))
    c2 = _ensure_ccw(box_corners_bev(boxes2))
    n, m = boxes1.shape[0], boxes2.shape[0]
    inter = rotated_rect_intersection_area(c1[:, None].expand(n, m, 4, 2),
                                           c2[None, :].expand(n, m, 4, 2))
    a1 = boxes1[:, 3] * boxes1[:, 4]
    a2 = boxes2[:, 3] * boxes2[:, 4]
    union = a1[:, None] + a2[None, :] - inter
    return inter / union.clamp(min=1e-8)
