"""The port's CBGS (``data/cbgs.py``), GT paste (``data/gt_sampling.py``) and
test-time augmentation (``data/tta.py``) against the JAX package.

CBGS indices and pasted samples are held bitwise from the same generator
state; ``invert_boxes`` to 1e-6; the TTA union bitwise for the same
detector; the union's rotated-NMS fusion (``tta.fuse_union``, the port's
``multiclass_nms_bev``, K3's plain version on the CPU) against the JAX
package's ``multiclass_nms_bev`` on the same union: labels, validity and
order exact, boxes and scores 1e-6.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fullysparsefusion_tpu.data import cbgs as jcbgs
from fullysparsefusion_tpu.data import gt_sampling as jgs
from fullysparsefusion_tpu.data import tta as jtta
from fullysparsefusion_tpu.ops.nms import multiclass_nms_bev as j_multiclass_nms_bev
from fullysparsefusion_tpu_torch.data import cbgs as tcbgs
from fullysparsefusion_tpu_torch.data import gt_sampling as tgs
from fullysparsefusion_tpu_torch.data import tta as ttta
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)
from test_torch_data_nuscenes import assert_same
from test_torch_fsf import FAST_COMPILE


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_class_balanced_indices_match_jax(seed):
    rng = np.random.default_rng(100 + seed)
    sample_classes = [list(rng.choice(10, rng.integers(0, 4), replace=False))
                      for _ in range(40)]
    sample_classes[3] = []
    extra = {1: 0.5, 4: 1.25} if seed == 7 else None
    a = jcbgs.class_balanced_indices(sample_classes, 10, np.random.default_rng(seed), extra)
    b = tcbgs.class_balanced_indices(sample_classes, 10, np.random.default_rng(seed), extra)
    assert_same(b, a)
    assert len(a) >= 40


def _scene(rng, n_pts=3000, n_boxes=6, dim=9):
    boxes = np.zeros((n_boxes, 9), np.float32)
    boxes[:, :2] = rng.uniform(-20, 20, (n_boxes, 2))
    boxes[:, 2] = -1.5
    boxes[:, 3:6] = rng.uniform(1.0, 4.0, (n_boxes, 3))
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, n_boxes)
    boxes[:, 7:9] = rng.normal(size=(n_boxes, 2))
    pts = rng.uniform(-22, 22, (n_pts, dim)).astype(np.float32)
    pts[:, 2] = rng.uniform(-1.6, 2.5, n_pts)
    for b in boxes:  # points inside each box
        local = rng.uniform(-0.45, 0.45, (60, 3)) * b[3:6]
        c, s = np.cos(b[6]), np.sin(b[6])
        xyz = np.stack([local[:, 0] * c - local[:, 1] * s + b[0],
                        local[:, 0] * s + local[:, 1] * c + b[1], local[:, 2] + b[2] + b[5] / 2], 1)
        pts = np.concatenate([pts, np.concatenate([xyz, rng.random((60, dim - 3))], 1)
                              .astype(np.float32)])
    return dict(points=pts, gt_boxes=boxes, gt_labels=rng.integers(0, 10, n_boxes).astype(np.int32))


def test_gt_database_and_paste_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    samples = [_scene(rng) for _ in range(4)]
    samples[1]["gt_labels"][0] = -1
    paths = [str(tmp_path / n) for n in ("jax.pkl", "port.pkl")]
    counts = [m.build_gt_database(samples, tuple(str(c) for c in range(10)), p, min_points=5)
              for m, p in zip((jgs, tgs), paths)]
    assert counts[0] == counts[1] and sum(counts[0].values()) > 10
    dbs = []
    for p in paths:
        with open(p, "rb") as f:
            dbs.append(pickle.load(f))
    assert_same(dbs[1], dbs[0])
    xyz, box = samples[0]["points"][:, :3], samples[0]["gt_boxes"][2]
    assert_same(tgs._points_in_box_np(xyz, box), jgs._points_in_box_np(xyz, box))
    boxes = samples[0]["gt_boxes"]
    for j in range(len(boxes)):
        assert tgs._bev_overlap(boxes[j], boxes[:j]) == jgs._bev_overlap(boxes[j], boxes[:j])
    budget = {0: 2, 3: 3, 5: 1, 7: 4}
    samplers = [m.GTPasteSampler(db_path=paths[0], max_per_class=budget, seed=3)
                for m in (jgs, tgs)]
    pasted_any = False
    for k in range(3):
        s = _scene(np.random.default_rng(50 + k), dim=8 if k == 2 else 9)
        s["no_aug_gt_boxes"] = s["gt_boxes"][:, :7].copy() if k == 1 else s["gt_boxes"].copy()
        a, b = samplers[0](dict(s)), samplers[1](dict(s))
        assert_same(b, a)
        pasted_any |= len(a["gt_boxes"]) > len(s["gt_boxes"])
    assert pasted_any


def test_tta_grid_and_invert_boxes_match_jax():
    kw = dict(scales=(0.95, 1.05), rotations=(0.0, 0.3), flip_horizontal=True,
              flip_vertical=False)
    jg, tg = jtta.tta_grid(**kw), ttta.tta_grid(**kw)
    assert [tuple(vars(v).values()) for v in tg] == [tuple(vars(v).values()) for v in jg]
    assert len(ttta.tta_grid()) == 4
    rng = np.random.default_rng(1)
    boxes = np.concatenate([rng.uniform(-30, 30, (50, 3)), rng.uniform(0.5, 4, (50, 3)),
                            rng.uniform(-np.pi, np.pi, (50, 1)), rng.normal(size=(50, 2))],
                           1).astype(np.float32)
    for jv, tv in zip(jg + jtta.tta_grid(), tg + ttta.tta_grid()):
        np.testing.assert_allclose(ttta.invert_boxes(boxes, tv), jtta.invert_boxes(boxes, jv),
                                   rtol=1e-6, atol=1e-6)
        tp = tv.to_params()
        assert (tp.rotation, tp.scale, tp.flip_x, tp.flip_y) == (tv.rotation, tv.scale,
                                                                  tv.flip_x, tv.flip_y)


def _detector(n_out=120):
    """A deterministic stand-in for the model: boxes at points of the cloud,
    so each variant's detections move with its transform."""
    def infer(points):
        idx = np.argsort(points[:, 0] + 0.37 * points[:, 1])[:n_out]
        p = points[idx]
        boxes = np.concatenate([p[:, :3], np.tile([[4.0, 1.9, 1.6]], (n_out, 1)),
                                np.arctan2(p[:, 1:2], p[:, 0:1]), p[:, 3:5]], 1)
        scores = (np.abs(np.sin(p[:, 0] * 13.0)) * 0.9 + 0.05).astype(np.float32)
        return boxes.astype(np.float32), scores, (idx % 10).astype(np.int32)
    return infer


def test_run_tta_union_and_fused_nms_match_jax():
    rng = np.random.default_rng(2)
    points = rng.uniform(-25, 25, (600, 6)).astype(np.float32)
    variants = (ttta.tta_grid(), jtta.tta_grid())
    tu = ttta.run_tta(points, variants[0], _detector())
    ju = jtta.run_tta(points, variants[1], _detector())
    for a, b in zip(tu, ju):
        assert_same(a, b)
    boxes, scores, labels = tu
    assert len(boxes) == 4 * 120
    res = ttta.fuse_union(boxes, scores, labels, 10, 0.35, 0.01, 200, device="cpu")
    smat = np.zeros((len(boxes), 10), np.float32)
    smat[np.arange(len(boxes)), labels] = scores
    ref = jax.jit(j_multiclass_nms_bev, static_argnums=(3, 4, 5)).lower(
        jnp.asarray(boxes), jnp.asarray(smat), jnp.ones(len(boxes), bool), 0.35, 0.01, 200
    ).compile(compiler_options=FAST_COMPILE)(
        jnp.asarray(boxes), jnp.asarray(smat), jnp.ones(len(boxes), bool))
    valid = np.asarray(ref.valid)
    assert_same(res.valid.numpy(), valid)
    np.testing.assert_array_equal(res.labels.numpy()[valid], np.asarray(ref.labels)[valid])
    np.testing.assert_allclose(res.boxes.numpy()[valid], np.asarray(ref.boxes)[valid],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(res.scores.numpy()[valid], np.asarray(ref.scores)[valid],
                               rtol=1e-6, atol=1e-6)
    assert 20 < valid.sum() < len(boxes)
    empty = ttta.run_tta(points, variants[0], lambda p: (np.zeros((0, 9), np.float32),
                                                         np.zeros(0, np.float32),
                                                         np.zeros(0, np.int32)))
    assert [a.shape for a in empty] == [(0, 9), (0,), (0,)]
