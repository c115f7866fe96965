"""Box geometry (port of ``ops/geometry.py``: the rotated IoU of decode,
the box membership, corners and 2D IoU of the assigners and losses).

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


def boxes_iou_3d(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """3D IoU matrix [N, M]: the rotated BEV intersection times the height
    overlap, over the union of the volumes."""
    c1 = _ensure_ccw(box_corners_bev(boxes1))
    c2 = _ensure_ccw(box_corners_bev(boxes2))
    n, m = boxes1.shape[0], boxes2.shape[0]
    inter_bev = rotated_rect_intersection_area(c1[:, None].expand(n, m, 4, 2),
                                               c2[None, :].expand(n, m, 4, 2))
    z1lo, z1hi = boxes1[:, 2], boxes1[:, 2] + boxes1[:, 5]
    z2lo, z2hi = boxes2[:, 2], boxes2[:, 2] + boxes2[:, 5]
    zov = (torch.minimum(z1hi[:, None], z2hi[None, :])
           - torch.maximum(z1lo[:, None], z2lo[None, :])).clamp(min=0.0)
    inter = inter_bev * zov
    v1 = boxes1[:, 3] * boxes1[:, 4] * boxes1[:, 5]
    v2 = boxes2[:, 3] * boxes2[:, 4] * boxes2[:, 5]
    union = v1[:, None] + v2[None, :] - inter
    return inter / union.clamp(min=1e-8)


def points_box_assignment(points: torch.Tensor, boxes: torch.Tensor,
                          boxes_valid: torch.Tensor) -> torch.Tensor:
    """Per-point index of the lowest-index valid box containing it, -1 if none."""
    inside = points_in_boxes(points, boxes) & boxes_valid[None, :]
    return _first_hit(inside)


def points_box_assignment_batched(points, point_batch, boxes, box_batch,
                                  boxes_valid) -> torch.Tensor:
    """:func:`points_box_assignment` restricted to the point's batch element."""
    inside = (points_in_boxes(points, boxes) & boxes_valid[None, :]
              & (point_batch[:, None] == box_batch[None, :]))
    return _first_hit(inside)


def _first_hit(inside: torch.Tensor) -> torch.Tensor:
    """Lowest column set in each row of [N, M] bool, -1 for none."""
    m = inside.shape[1]
    idx = torch.arange(m + 1, dtype=torch.int32, device=inside.device)
    # a column of "no hit" at m keeps the reduction defined for M = 0
    hits = torch.cat([inside, inside.new_ones(inside.shape[0], 1)], dim=1)
    first = torch.where(hits, idx, torch.full_like(idx, m)).amin(dim=1)
    return torch.where(first == m, torch.full_like(first, -1), first)


def corners_3d(boxes: torch.Tensor) -> torch.Tensor:
    """[N, 7+] → [N, 8, 3] corners: the bottom 4 then the top 4, ccw in BEV."""
    bev = box_corners_bev(boxes)
    z0 = boxes[..., 2:3, None].expand(bev.shape[:-1] + (1,))
    z1 = (boxes[..., 2:3] + boxes[..., 5:6])[..., None].expand(bev.shape[:-1] + (1,))
    return torch.cat([torch.cat([bev, z0], -1), torch.cat([bev, z1], -1)], dim=-2)


def axis_aligned_iou_2d(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """IoU matrix [N, M] of xyxy 2D boxes."""
    x1 = torch.maximum(boxes1[:, None, 0], boxes2[None, :, 0])
    y1 = torch.maximum(boxes1[:, None, 1], boxes2[None, :, 1])
    x2 = torch.minimum(boxes1[:, None, 2], boxes2[None, :, 2])
    y2 = torch.minimum(boxes1[:, None, 3], boxes2[None, :, 3])
    inter = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    a1 = (boxes1[:, 2] - boxes1[:, 0]) * (boxes1[:, 3] - boxes1[:, 1])
    a2 = (boxes2[:, 2] - boxes2[:, 0]) * (boxes2[:, 3] - boxes2[:, 1])
    return inter / (a1[:, None] + a2[None, :] - inter).clamp(min=1e-8)


def hull_canvas_aabb(pts: torch.Tensor, img_w: float, img_h: float):
    """Axis-aligned box of conv(pts) ∩ [0, W] × [0, H] for [G, N, 2] points,
    exactly: the extremes lie among the points inside the canvas, the
    crossings of every point pair's segment with the four border lines, and
    the canvas corners inside some point triangle. Returns (bboxes [G, 4]
    xyxy, nonempty [G])."""
    g, n, _ = pts.shape
    dev, dt = pts.device, pts.dtype
    cands = [pts]
    valids = [(pts[..., 0] >= 0) & (pts[..., 0] <= img_w)
              & (pts[..., 1] >= 0) & (pts[..., 1] <= img_h)]
    ii, jj = torch.triu_indices(n, n, offset=1, device=dev)
    a, b = pts[:, ii], pts[:, jj]
    d = b - a
    for axis, c, lo, hi in ((0, 0.0, 0.0, img_h), (0, float(img_w), 0.0, img_h),
                            (1, 0.0, 0.0, img_w), (1, float(img_h), 0.0, img_w)):
        other = 1 - axis
        denom = d[..., axis]
        small = denom.abs() < 1e-9
        t = (c - a[..., axis]) / torch.where(small, torch.full_like(denom, 1e-9), denom)
        p_other = a[..., other] + t * d[..., other]
        ok = (t >= 0.0) & (t <= 1.0) & ~small & (p_other >= lo) & (p_other <= hi)
        pt = torch.stack([torch.full_like(p_other, c), p_other], dim=-1)
        cands.append(pt.flip(-1) if axis == 1 else pt)
        valids.append(ok)
    corners = torch.tensor([[0.0, 0.0], [img_w, 0.0], [0.0, img_h], [img_w, img_h]],
                           dtype=dt, device=dev)
    ar = torch.arange(n, device=dev)
    ti, tj, tk = torch.meshgrid(ar, ar, ar, indexing="ij")
    ti, tj, tk = ti.reshape(-1), tj.reshape(-1), tk.reshape(-1)
    tri_ok = (ti < tj) & (tj < tk)
    pa, pb, pc = pts[:, ti], pts[:, tj], pts[:, tk]

    def cross(o, u, v):
        return ((u[..., 0] - o[..., 0]) * (v[..., 1] - o[..., 1])
                - (u[..., 1] - o[..., 1]) * (v[..., 0] - o[..., 0]))

    q = corners[None, :, None, :]
    s1 = cross(pa[:, None], pb[:, None], q)
    s2 = cross(pb[:, None], pc[:, None], q)
    s3 = cross(pc[:, None], pa[:, None], q)
    eps = 1e-6
    in_tri = (((s1 >= -eps) & (s2 >= -eps) & (s3 >= -eps))
              | ((s1 <= eps) & (s2 <= eps) & (s3 <= eps)))
    cands.append(corners[None].expand(g, 4, 2))
    valids.append((in_tri & tri_ok[None, None, :]).any(dim=-1))
    allc = torch.cat(cands, dim=1)
    allv = torch.cat(valids, dim=1)
    big = torch.full_like(allc[..., 0], 1e9)
    x1 = torch.where(allv, allc[..., 0], big).amin(dim=1)
    y1 = torch.where(allv, allc[..., 1], big).amin(dim=1)
    x2 = torch.where(allv, allc[..., 0], -big).amax(dim=1)
    y2 = torch.where(allv, allc[..., 1], -big).amax(dim=1)
    nonempty = allv.any(dim=1)
    bboxes = torch.stack([x1, y1, x2, y2], dim=1)
    return torch.where(nonempty[:, None], bboxes, torch.zeros_like(bboxes)), nonempty
