"""Debug visualization dumps (the port's copy of the JAX package's
``utils/visualize.py``), gated on a ``vis_dir`` the way the reference gates
its hooks (frustum_assigner.py:171-232 dumps 2D assignment overlays,
frustum_cluster_head.py:325-366 dumps frustum crops when ``vis_dir`` is
set): ``cli/train.py --vis-dir`` and ``cli/test.py --vis-dir``.

Host-side numpy + matplotlib (Agg) only; callers pass arrays on the host.
matplotlib is optional: without it the dumps raise ``ImportError``, and
nothing else needs it.

Color discipline: marks use a fixed categorical assignment (GT = blue,
predictions = orange, foreground votes = aqua), never cycled by rank, with
identity additionally carried by linestyle (GT solid, predictions dashed) so
the dump stays readable without color. Cluster membership cycles the 8-slot
categorical palette; cluster identity is also carried by spatial grouping
(clusters are disjoint by construction). Text stays in neutral ink. The hex
values are a pre-validated dark-surface categorical palette (lightness band,
chroma floor, CVD-pair separation checked).
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

# dark-surface palette (validated instance; see module docstring)
SURFACE = "#1a1a19"
INK = "#ffffff"
INK_2 = "#c3c2b7"
GT_COLOR = "#3987e5"       # categorical slot 1 (blue)
PRED_COLOR = "#d95926"     # slot 2 (orange)
FG_COLOR = "#199e70"       # slot 3 (aqua)
CATEGORICAL = (
    "#3987e5", "#d95926", "#199e70", "#c98500",
    "#d55181", "#008300", "#9085e9", "#e66767",
)


def _agg_plt():
    try:
        import matplotlib
    except ImportError as e:  # optional: only the debug dumps need it
        raise ImportError("debug visualization needs matplotlib") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def bev_corners(boxes: np.ndarray) -> np.ndarray:
    """[N, 7+] boxes (x y z dx dy dz yaw ...) → [N, 4, 2] BEV corners."""
    boxes = np.asarray(boxes, np.float32)
    if boxes.size == 0:
        return np.zeros((0, 4, 2), np.float32)
    boxes = boxes.reshape(-1, boxes.shape[-1])
    cx, cy = boxes[:, 0], boxes[:, 1]
    dx, dy, yaw = boxes[:, 3] / 2, boxes[:, 4] / 2, boxes[:, 6]
    local = np.stack(
        [np.stack([sx * dx, sy * dy], -1)
         for sx, sy in ((-1, -1), (-1, 1), (1, 1), (1, -1))], axis=1
    )  # [N, 4, 2]
    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)  # [N,2,2]
    return np.einsum("nij,nkj->nki", rot, local) + np.stack([cx, cy], -1)[:, None]


def _draw_boxes(ax, boxes, color, linestyle, label, scores=None):
    corners = bev_corners(boxes)
    for i, quad in enumerate(corners):
        ax.plot(
            np.r_[quad[:, 0], quad[0, 0]], np.r_[quad[:, 1], quad[0, 1]],
            color=color, linestyle=linestyle, linewidth=1.0,
            label=label if i == 0 else None,
        )
        # heading tick from center to front-edge midpoint
        cx, cy = quad[:, 0].mean(), quad[:, 1].mean()
        fx, fy = quad[2:4, 0].mean(), quad[2:4, 1].mean()
        ax.plot([cx, fx], [cy, fy], color=color, linestyle=linestyle,
                linewidth=0.8)
    if scores is not None and len(corners):
        # selective direct labels: only the 5 highest-scoring predictions
        top = np.argsort(np.asarray(scores))[::-1][:5]
        for i in top:
            q = corners[i]
            ax.text(q[:, 0].mean(), q[:, 1].max() + 0.5,
                    f"{float(scores[i]):.2f}", color=INK_2, fontsize=6,
                    ha="center")


def dump_bev(
    path: str,
    points: np.ndarray,                      # [N, >=3]
    point_valid: Optional[np.ndarray] = None,
    gt_boxes: Optional[np.ndarray] = None,   # [G, 7+]
    pred_boxes: Optional[np.ndarray] = None,
    pred_scores: Optional[np.ndarray] = None,
    cluster_labels: Optional[np.ndarray] = None,  # [N] int, -1 = none
    fg_mask: Optional[np.ndarray] = None,    # [N] bool (vote/seg foreground)
    extent: Optional[float] = None,
    title: Optional[str] = None,
) -> str:
    """Bird's-eye-view scene dump: points, GT vs predicted boxes, optional
    cluster membership / foreground coloring. Returns the written path."""
    plt = _agg_plt()
    points = np.asarray(points)
    if point_valid is not None:
        points = points[np.asarray(point_valid, bool)]
        if cluster_labels is not None:
            cluster_labels = np.asarray(cluster_labels)[np.asarray(point_valid, bool)]
        if fg_mask is not None:
            fg_mask = np.asarray(fg_mask, bool)[np.asarray(point_valid, bool)]

    fig, ax = plt.subplots(figsize=(8, 8), dpi=130)
    fig.patch.set_facecolor(SURFACE)
    ax.set_facecolor(SURFACE)
    ax.scatter(points[:, 0], points[:, 1], s=0.3, c=INK_2, alpha=0.35,
               linewidths=0, label="points")
    if fg_mask is not None and fg_mask.any():
        ax.scatter(points[fg_mask, 0], points[fg_mask, 1], s=0.8, c=FG_COLOR,
                   alpha=0.9, linewidths=0, label="foreground")
    if cluster_labels is not None:
        lab = np.asarray(cluster_labels)
        m = lab >= 0
        if m.any():
            colors = [CATEGORICAL[int(l) % len(CATEGORICAL)] for l in lab[m]]
            ax.scatter(points[m, 0], points[m, 1], s=1.2, c=colors,
                       linewidths=0, label="clusters")
    if gt_boxes is not None and len(np.atleast_2d(gt_boxes)):
        _draw_boxes(ax, np.atleast_2d(gt_boxes), GT_COLOR, "-", "GT")
    if pred_boxes is not None and len(np.atleast_2d(pred_boxes)):
        _draw_boxes(ax, np.atleast_2d(pred_boxes), PRED_COLOR, "--", "pred",
                    scores=pred_scores)

    if extent:
        ax.set_xlim(-extent, extent)
        ax.set_ylim(-extent, extent)
    ax.set_aspect("equal")
    ax.tick_params(colors=INK_2, labelsize=7)
    for sp in ax.spines.values():
        sp.set_color(INK_2)
        sp.set_linewidth(0.5)
    ax.grid(color=INK_2, alpha=0.12, linewidth=0.5)
    if title:
        ax.set_title(title, color=INK, fontsize=9)
    leg = ax.legend(loc="upper right", fontsize=7, facecolor=SURFACE,
                    edgecolor=INK_2, framealpha=0.8)
    for t in leg.get_texts():
        t.set_color(INK)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path, bbox_inches="tight", facecolor=SURFACE)
    plt.close(fig)
    return path


def dump_camera_assignment(
    path: str,
    mask_plane: np.ndarray,                  # [H, W] uint8/uint16 instance ids
    boxes2d: Optional[np.ndarray] = None,    # [Q, 4] xyxy (mask pixel coords)
    boxes2d_gt: Optional[np.ndarray] = None,
    title: Optional[str] = None,
) -> str:
    """2D instance-mask + box-assignment overlay for one camera (counterpart
    of the reference's frustum_assigner debug images). Accepts raw id planes
    or packed id|score<<8 uint16 textures (low byte = id), either one [H, W]
    plane or channel-last per-class planes [H, W, cls] (instance ids are
    global across classes — anno row + 1 — so a max over classes merges)."""
    plt = _agg_plt()
    ids = (np.asarray(mask_plane).astype(np.uint16) & 0xFF).astype(np.int32)
    if ids.ndim == 3:
        ids = ids.max(axis=-1)
    h, w = ids.shape
    rgb = np.zeros((h, w, 3), np.float32)
    surf = np.array([int(SURFACE[i:i + 2], 16) for i in (1, 3, 5)]) / 255.0
    rgb[:] = surf
    for inst in np.unique(ids):
        if inst == 0:
            continue
        c = CATEGORICAL[(int(inst) - 1) % len(CATEGORICAL)]
        col = np.array([int(c[i:i + 2], 16) for i in (1, 3, 5)]) / 255.0
        rgb[ids == inst] = 0.25 * surf + 0.75 * col

    fig, ax = plt.subplots(figsize=(8, 8 * h / max(w, 1)), dpi=130)
    fig.patch.set_facecolor(SURFACE)
    ax.imshow(rgb, interpolation="nearest")
    for bxs, color, ls, lbl in (
        (boxes2d_gt, GT_COLOR, "-", "GT 2D"),
        (boxes2d, PRED_COLOR, "--", "query 2D"),
    ):
        if bxs is None:
            continue
        for i, (x0, y0, x1, y1) in enumerate(np.atleast_2d(bxs)):
            ax.plot([x0, x1, x1, x0, x0], [y0, y0, y1, y1, y0], color=color,
                    linestyle=ls, linewidth=1.0,
                    label=lbl if i == 0 else None)
    ax.axis("off")
    if title:
        ax.set_title(title, color=INK, fontsize=9)
    handles, labels = ax.get_legend_handles_labels()
    if handles:
        leg = ax.legend(loc="upper right", fontsize=7, facecolor=SURFACE,
                        edgecolor=INK_2, framealpha=0.8)
        for t in leg.get_texts():
            t.set_color(INK)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path, bbox_inches="tight", facecolor=SURFACE)
    plt.close(fig)
    return path
