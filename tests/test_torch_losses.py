"""The port's training geometry, losses, coder, assigners, segmentor targets
and loss, and cluster-head loss against the JAX package's, on the same
inputs drawn with numpy: random scenes and the edges (empty GT, all-invalid
queries, ties between boxes, predictions and distances).

Tolerances: integer and bool outputs (assignments, labels, masks) are equal;
f32 outputs of the same operations on the same f32 inputs agree within
1e-5 relative (``F32_TOL``: sums, norms and transcendental functions in
another order or library), except the projected 2D boxes, which divide by
depth and are compared within 1e-5 of the canvas size.

``test_torch_losses_cluster_head.py`` and ``test_torch_losses_geometry.py``
hold more tests of this module's helpers and fixtures, at its tolerances, in
files of at most five tests, so that xdist's ``--dist loadfile`` (files with
more tests first) queues them behind ``tests/test_train.py``, the Tier-1
run's longest file.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullysparsefusion_tpu.core import assigners as ja
from fullysparsefusion_tpu.core import losses as jl
from fullysparsefusion_tpu.core.coders import BasePointBBoxCoder as JCoder
from fullysparsefusion_tpu.ops import geometry as jg
from fullysparsefusion_tpu.utils.containers import GroundTruth as JGT
from fullysparsefusion_tpu_torch import synthetic as S
from fullysparsefusion_tpu_torch.core import assigners as ta
from fullysparsefusion_tpu_torch.core import losses as tl
from fullysparsefusion_tpu_torch.core.coders import BasePointBBoxCoder
from fullysparsefusion_tpu_torch.ops import geometry as tg
from fullysparsefusion_tpu_torch.utils.containers import GroundTruth
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)

F32_TOL = 1e-5
IMG_W, IMG_H = 96, 64


def _t(x):
    return torch.from_numpy(np.array(x))


def _eq(got, ref):
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(ref))


def _close(got, ref, tol=F32_TOL, scale=None):
    ref = np.asarray(ref, np.float32)
    atol = tol * (scale if scale is not None else max(1.0, float(np.abs(ref).max(initial=0))))
    np.testing.assert_allclose(got.detach().float().numpy(), ref, rtol=tol, atol=atol)


def _gt_arrays(seed, batch=2, m=8, n_valid=(5, 3), extent=10.0):
    """Padded GT [B, M, 10] with ``n_valid[b]`` boxes per sample; the second
    box of sample 0 is a shifted copy of the first, so the two overlap."""
    rng = np.random.default_rng(seed)
    boxes = np.zeros((batch, m, 10), np.float32)
    labels = np.full((batch, m), -1, np.int32)
    valid = np.zeros((batch, m), bool)
    for b in range(batch):
        k = n_valid[b]
        boxes[b, :k, :2] = rng.uniform(-extent, extent, (k, 2))
        boxes[b, :k, 2] = rng.uniform(-1.5, -0.5, k)
        boxes[b, :k, 3:6] = rng.uniform(1.5, 4.0, (k, 3))
        boxes[b, :k, 6] = rng.uniform(-np.pi, np.pi, k)
        boxes[b, :k, 7:9] = rng.normal(0, 1, (k, 2))
        boxes[b, :k, 9] = rng.random(k) > 0.3
        labels[b, :k] = rng.integers(0, 10, k)
        valid[b, :k] = True
    if n_valid[0] >= 2:
        boxes[0, 1] = boxes[0, 0]
        boxes[0, 1, :2] += 0.4
        labels[0, 1] = labels[0, 0]
    return boxes, labels, valid


def _gts(arrays):
    boxes, labels, valid = arrays
    return (JGT(boxes=jnp.asarray(boxes), labels=jnp.asarray(labels), valid=jnp.asarray(valid)),
            GroundTruth(_t(boxes), _t(labels), _t(valid)))


def _queries(seed, gt_boxes, q=64, batch=2):
    """Query centers: half near GT centers (inside), half uniform clutter."""
    rng = np.random.default_rng(seed)
    flat = gt_boxes.reshape(-1, 10)
    src = flat[rng.integers(0, len(flat), q)]
    xyz = np.where(rng.random((q, 1)) < 0.5,
                   src[:, :3] + np.array([0, 0, 1.0]) * src[:, 5:6] / 2
                   + rng.normal(0, 0.3, (q, 3)),
                   rng.uniform(-10, 10, (q, 3))).astype(np.float32)
    qb = rng.integers(0, batch, q).astype(np.int32)
    qv = rng.random(q) > 0.15
    return xyz, qb, qv


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_valid", [(5, 3), (0, 0)])
def test_points_box_assignment_exact(n_valid):
    boxes, labels, valid = _gt_arrays(0, n_valid=n_valid)
    xyz, qb, _ = _queries(1, boxes if n_valid[0] else _gt_arrays(0)[0], q=200)
    flat, fvalid = boxes.reshape(-1, 10)[:, :7], valid.reshape(-1)
    bb = np.repeat(np.arange(2, dtype=np.int32), 8)
    _eq(tg.points_box_assignment(_t(xyz), _t(flat), _t(fvalid)),
        jg.points_box_assignment(jnp.asarray(xyz), jnp.asarray(flat), jnp.asarray(fvalid)))
    got = tg.points_box_assignment_batched(_t(xyz), _t(qb), _t(flat), _t(bb), _t(fvalid))
    _eq(got, jg.points_box_assignment_batched(*map(jnp.asarray, (xyz, qb, flat, bb, fvalid))))
    if n_valid[0]:
        # the overlapping pair: a point in both boxes takes the lower index
        both = tg.points_in_boxes(_t(xyz), _t(flat))[:, :2].all(1) & (_t(qb) == 0)
        assert both.any() and (got[both] == 0).all()
    else:
        assert (got == -1).all()


def test_corners_and_iou_2d_match_jax():
    boxes = _gt_arrays(2)[0].reshape(-1, 10)
    _close(tg.corners_3d(_t(boxes[:, :7])), jg.corners_3d(jnp.asarray(boxes[:, :7])))
    rng = np.random.default_rng(3)
    a = np.sort(rng.uniform(0, 100, (30, 2, 2)), axis=1).transpose(0, 2, 1).reshape(30, 4)
    b = np.sort(rng.uniform(0, 100, (20, 2, 2)), axis=1).transpose(0, 2, 1).reshape(20, 4)
    b[:3] = a[:3]                                   # exact duplicates: IoU 1
    a, b = a[:, [0, 2, 1, 3]].astype(np.float32), b[:, [0, 2, 1, 3]].astype(np.float32)
    got = tg.axis_aligned_iou_2d(_t(a), _t(b))
    _close(got, jg.axis_aligned_iou_2d(jnp.asarray(a), jnp.asarray(b)))
    assert torch.allclose(got.diagonal()[:3], torch.ones(3))


# ---------------------------------------------------------------------------
# losses and coder
# ---------------------------------------------------------------------------


def test_losses_match_jax():
    rng = np.random.default_rng(5)
    logits = (rng.normal(0, 3, (50, 11))).astype(np.float32)
    onehot = (rng.random((50, 11)) < 0.2).astype(np.float32)
    _close(tl.sigmoid_focal_loss(_t(logits), _t(onehot), 4.0, 0.25),
           jl.sigmoid_focal_loss(jnp.asarray(logits), jnp.asarray(onehot), 4.0, 0.25))
    labels = rng.integers(-2, 13, 50).astype(np.int32)   # out of range: clipped
    cw = rng.uniform(0.1, 1.0, 11).astype(np.float32)
    _close(tl.softmax_ce_loss(_t(logits), _t(labels), _t(cw)),
           jl.softmax_ce_loss(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(cw)))
    _close(tl.softmax_ce_loss(_t(logits), _t(labels)),
           jl.softmax_ce_loss(jnp.asarray(logits), jnp.asarray(labels)))
    _close(tl.l1_loss(_t(logits), _t(onehot)), jl.l1_loss(jnp.asarray(logits), onehot))
    w = rng.random(11).astype(np.float32)
    for avg in (0.0, 0.5, 7.0):
        _close(tl.weighted_reduce(_t(logits), _t(w), torch.tensor(avg)),
               jl.weighted_reduce(jnp.asarray(logits), jnp.asarray(w), jnp.float32(avg)))


@pytest.mark.parametrize("code_size", [10, 8])
def test_coder_encode_decode_match_jax(code_size):
    boxes = _gt_arrays(6)[0].reshape(-1, 10)[:5]
    base = np.random.default_rng(6).normal(0, 2, (5, 3)).astype(np.float32)
    jc, tc = JCoder(code_size), BasePointBBoxCoder(code_size)
    enc = tc.encode(_t(boxes), _t(base))
    _close(enc, jc.encode(jnp.asarray(boxes), jnp.asarray(base)))
    _close(tc.decode(enc, _t(base)), jc.decode(jc.encode(jnp.asarray(boxes),
                                                         jnp.asarray(base)), jnp.asarray(base)))
    reg = enc.clone().requires_grad_(True)
    tc.decode(reg, _t(base), detach_yaw=True)[:, 6].sum().backward()
    assert float(reg.grad.abs().sum()) == 0.0


# ---------------------------------------------------------------------------
# assigners
# ---------------------------------------------------------------------------


def _lidar2img():
    return S.make_camera_arrays(*_gt_arrays(0), img_h=IMG_H, img_w=IMG_W)["lidar2img"]


def test_max_iou_assign_2d_matches_jax_with_ties():
    rng = np.random.default_rng(9)
    p, gf = 40, 24
    gt2d = np.concatenate([rng.uniform(0, 60, (gf, 2)), np.zeros((gf, 2))], 1)
    gt2d[:, 2:] = gt2d[:, :2] + rng.uniform(5, 30, (gf, 2))
    pred = gt2d[rng.integers(0, gf, p)] + rng.normal(0, 3, (p, 4))
    pred[:4] = gt2d[:4]                              # exact matches
    pred[4] = pred[5] = gt2d[6]                      # two predictions tie for one GT
    gt2d[8] = gt2d[9]                                # two GTs tie for one prediction
    pred[7] = gt2d[8]
    args = [pred.astype(np.float32), rng.integers(0, 2, p).astype(np.int32),
            rng.integers(0, 2, p).astype(np.int32), rng.random(p) > 0.1,
            gt2d.astype(np.float32), rng.integers(0, 2, gf).astype(np.int32),
            rng.integers(0, 2, gf).astype(np.int32), rng.random(gf) > 0.1,
            rng.permutation(gf).astype(np.int32)]
    args[1][:8], args[2][:8] = 0, 0
    args[5][:10], args[6][:10] = 0, 0
    for low in (True, False):
        got = ta.max_iou_assign_2d(*map(_t, args), match_low_quality=low)
        _eq(got, ja.max_iou_assign_2d(*map(jnp.asarray, args), match_low_quality=low))
        assert (got >= 0).sum() >= 4
    # every query invalid: nothing is assigned
    args[3][:] = False
    assert (ta.max_iou_assign_2d(*map(_t, args)) == -1).all()


def test_assign_by_dist_matches_jax_with_ties():
    arrays = _gt_arrays(10)
    jgt, tgt = _gts(arrays)
    xyz, qb, qv = _queries(11, arrays[0])
    logits = np.random.default_rng(12).normal(size=(len(xyz), 10)).astype(np.float32)
    # two GTs at one center and one class: the lower index wins
    flat = arrays[0].reshape(-1, 10)
    xyz[0, :2], qb[0], qv[0] = flat[0, :2] + 0.2, 0, True
    logits[0, arrays[1][0, 0]] = 9.0
    md = (1.0, 1.0, 2.0, 4.0, 0.5, 0.5, 0.5, 0.5, 0.5, 0.0)
    got = ta.assign_by_dist(_t(xyz), _t(logits), _t(qb), _t(qv), tgt, md)
    _eq(got, ja.assign_by_dist(jnp.asarray(xyz), jnp.asarray(logits), jnp.asarray(qb),
                               jnp.asarray(qv), jgt, md))
    assert int(got[0]) == 0


@pytest.mark.parametrize("case", ["scene", "empty_gt", "invalid_queries"])
def test_hybrid_assign_matches_jax(case):
    arrays = _gt_arrays(13, n_valid=(0, 0) if case == "empty_gt" else (5, 3))
    jgt, tgt = _gts(arrays)
    noaug = (arrays[0] + np.float32(0.1), arrays[1], arrays[2])
    jna, tna = _gts(noaug)
    xyz, qb, qv = _queries(14, _gt_arrays(13)[0])
    if case == "invalid_queries":
        qv[:] = False
    q = len(xyz)
    rng = np.random.default_rng(15)
    preds_2d = np.zeros((q, 9), np.float32)
    preds_2d[:, :2] = rng.uniform(0, 60, (q, 2))
    preds_2d[:, 2:4] = preds_2d[:, :2] + rng.uniform(3, 30, (q, 2))
    preds_2d[:, 6] = rng.integers(0, 2, q)
    preds_2d[:, 8] = rng.random(q) > 0.3
    logits = rng.normal(size=(q, 10)).astype(np.float32)
    l2i = _lidar2img()
    md = (1.0, 1.0, 2.0, 4.0, 0.5, 0.5, 0.5, 0.5, 0.5, 0.0)
    for kw in (dict(), dict(max_dist_per_class=md), dict(restrict_3d_to_noaug=True)):
        tkw = dict(kw, query_logits=_t(logits)) if kw.get("max_dist_per_class") else kw
        jkw = dict(kw, query_logits=jnp.asarray(logits)) if kw.get("max_dist_per_class") else kw
        got = ta.hybrid_assign(_t(xyz), _t(qb), _t(qv), _t(preds_2d), tgt, tna, _t(l2i),
                               IMG_W, IMG_H, **tkw)
        ref = ja.hybrid_assign(jnp.asarray(xyz), jnp.asarray(qb), jnp.asarray(qv),
                               jnp.asarray(preds_2d), jgt, jna, jnp.asarray(l2i), IMG_W, IMG_H,
                               **jkw)
        _eq(got, ref)
        if case == "scene":
            assert (got >= 0).any()
        else:
            assert (got == -1).all()


# ---------------------------------------------------------------------------
# segmentor and cluster-head losses on the same inputs
# ---------------------------------------------------------------------------
