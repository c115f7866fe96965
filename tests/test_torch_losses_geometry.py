"""Points in boxes and their projection, the segmentor's targets and loss and
the hull canvas against the JAX package on the CPU: tests of
``test_torch_losses.py``, at its tolerances. A file of at most five tests,
so that xdist's ``--dist loadfile`` (files with more tests first) queues it
behind ``tests/test_train.py``, the run's longest file.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from fullysparsefusion_tpu.config import VoteSegmentorConfig as JSegConfig
from fullysparsefusion_tpu.core import assigners as ja
from fullysparsefusion_tpu.models import segmentor as jseg
from fullysparsefusion_tpu.ops import geometry as jg
from fullysparsefusion_tpu.utils.containers import PointBatch as JPB
from fullysparsefusion_tpu_torch import synthetic as S
from fullysparsefusion_tpu_torch.config import VoteSegmentorConfig
from fullysparsefusion_tpu_torch.core import assigners as ta
from fullysparsefusion_tpu_torch.models import segmentor as tseg
from fullysparsefusion_tpu_torch.ops import geometry as tg
from fullysparsefusion_tpu_torch.utils.containers import PointBatch
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)
from test_torch_losses import IMG_H, IMG_W, _close, _eq, _gt_arrays, _gts, _lidar2img, _queries, _t


def test_hull_canvas_aabb_matches_jax():
    rng = np.random.default_rng(4)
    pts = rng.uniform(-60, 160, (40, 8, 2)).astype(np.float32)
    pts[:5] = rng.uniform(300, 400, (5, 8, 2))      # off the canvas: empty
    got, ne = tg.hull_canvas_aabb(_t(pts), 100.0, 80.0)
    ref, rne = jg.hull_canvas_aabb(jnp.asarray(pts), 100.0, 80.0)
    _eq(ne, rne)
    _close(got, ref, scale=100.0)
    assert not ne[:5].any() and ne[5:].any()


@pytest.mark.parametrize("n_valid", [(5, 3), (0, 2), (0, 0)])
def test_point_in_box_and_projection_match_jax(n_valid):
    arrays = _gt_arrays(7, n_valid=n_valid)
    jgt, tgt = _gts(arrays)
    for a, b in zip(ta.flatten_gt(tgt), ja.flatten_gt(jgt)):
        _eq(a, b)
    xyz, qb, qv = _queries(8, _gt_arrays(7)[0])
    for eh in (0.0, 0.5):
        _eq(ta.assign_point_in_box(_t(xyz), _t(qb), _t(qv), tgt, eh),
            ja.assign_point_in_box(jnp.asarray(xyz), jnp.asarray(qb), jnp.asarray(qv), jgt, eh))
    l2i = _lidar2img()
    got = ta.build_gt_boxes_2d(tgt, _t(l2i), IMG_W, IMG_H)
    ref = ja.build_gt_boxes_2d(jgt, jnp.asarray(l2i), IMG_W, IMG_H)
    for i in (1, 2, 3, 4):
        _eq(got[i], ref[i])
    _close(got[0], ref[0], scale=IMG_W)
    if n_valid[0]:
        assert got[3].any()


def test_segmentor_targets_and_loss_match_jax():
    sc = S.make_scene_arrays(seed=3, n_cap=1400)
    jgt, tgt = _gts((sc["gt_boxes"], sc["gt_labels"], sc["gt_valid"]))
    jpb = JPB(points=jnp.asarray(sc["points"]), batch_idx=jnp.asarray(sc["batch_idx"]),
              valid=jnp.asarray(sc["valid"]))
    tpb = PointBatch(_t(sc["points"]), _t(sc["batch_idx"]), _t(sc["valid"]))
    got = tseg.segmentor_targets(tpb, tgt, 10)
    ref = jseg.segmentor_targets(jpb, jgt, 10)
    _eq(got[0], ref[0]), _close(got[1], ref[1]), _eq(got[2], ref[2])
    assert int(got[2].sum()) > 100 and (got[0] == 10).any()
    rng = np.random.default_rng(16)
    n = sc["points"].shape[0]
    out = dict(seg_logits=rng.normal(0, 2, (n, 11)).astype(np.float32),
               vote_preds=rng.normal(0, 1, (n, 33)).astype(np.float32),
               valid=sc["valid"] & (rng.random(n) > 0.05))
    for cfg_kw in (dict(), dict(bg_class_weight=0.5, seg_loss_weight=3.0, vote_loss_weight=2.0)):
        tl_ = tseg.segmentor_loss({k: _t(v) for k, v in out.items()}, *got,
                                  VoteSegmentorConfig(**cfg_kw))
        jl_ = jseg.segmentor_loss({k: jnp.asarray(v) for k, v in out.items()}, *ref,
                                  JSegConfig(**cfg_kw))
        assert set(tl_) == set(jl_)
        for k in jl_:
            _close(tl_[k], jl_[k])
