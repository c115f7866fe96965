"""The parts of the port's LiDAR-only FSD against the JAX package's on the
CPU, on inputs drawn with numpy, without compiling a model: the task label
tables and the per-task GT remap, the multi-task head loss and decode, the
IoU branch in both label modes (with the corner loss), ``boxes_iou_3d``,
the activation table, FPS / ball grouping / the hybrid per-group
clustering and the one-problem CCL; ``build_fsd`` loading a JAX variable
tree with ``strict=True``; the FSD train step at world size 1 (gloo, in
this process) against ``train_step``; a detection weight of 0.

Tolerances: integer and bool outputs (labels, masks, cluster ids, picks)
are equal; f32 outputs of the same operations on the same f32 inputs agree
within ``F32_TOL`` 1e-5 relative to max(1, |ref|) (sums, norms and
transcendental functions in another order or library), gradients of the
head within ``F32_TOL`` of the largest entry.

``test_torch_fsd_parts_heads.py`` and ``test_torch_fsd_parts_clusters.py``
hold more tests of this module's helpers and fixtures, at its tolerances, in
files of at most five tests, so that xdist's ``--dist loadfile`` (files with
more tests first) queues them behind ``tests/test_train.py``, the Tier-1
run's longest file.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullysparsefusion_tpu.config import NUSC_CLASS_NAMES, NUSC_GROUPS
from fullysparsefusion_tpu.config import HeadConfig as JHeadConfig
from fullysparsefusion_tpu.models import fsd as jfsd
from fullysparsefusion_tpu.models import heads as jh
from fullysparsefusion_tpu.models.layers import get_activation as j_get_activation
from fullysparsefusion_tpu.ops import ccl as jccl
from fullysparsefusion_tpu.ops import fps as jfps
from fullysparsefusion_tpu.ops import geometry as jg
from fullysparsefusion_tpu.ops import nms as jnms
from fullysparsefusion_tpu.ops import pallas_kernels
from fullysparsefusion_tpu.utils.containers import PointBatch as JPB
from fullysparsefusion_tpu_torch import synthetic as S
from fullysparsefusion_tpu_torch.config import HeadConfig, tiny_fsd_config
from fullysparsefusion_tpu_torch.models import heads as th
from fullysparsefusion_tpu_torch.models.layers import get_activation
from fullysparsefusion_tpu_torch.ops import ccl, fps, geometry
from fullysparsefusion_tpu_torch.parallel import train as T
from fullysparsefusion_tpu_torch.synthetic import ccl_problem_arrays
from fullysparsefusion_tpu_torch.weights import build_fsd
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)
from test_torch_kernels import _boxes
from test_torch_losses import _close, _eq, _gt_arrays, _gts, _queries, _t

F32_TOL = 1e-5
# the tiny multi-task head: six tasks of the nuScenes groups, 2-layer attrs
HEAD_KW = dict(in_channel=32, shared_mlp_dims=(32, 32), cls_hidden_dim=16,
               common_attrs=(("center", 3, 2, 16), ("dim", 3, 2, 16), ("rot", 2, 2, 16),
                             ("vel", 2, 2, 16)), max_num=40, score_thr=0.3)


# ---------------------------------------------------------------------------
# task tables, multi-task loss and decode
# ---------------------------------------------------------------------------


def _task_gt(seed, m=12):
    """GT with labels over all ten classes, -1 labels on valid boxes and
    invalid boxes with real labels."""
    boxes, labels, valid = _gt_arrays(seed, m=m, n_valid=(9, 7))
    rng = np.random.default_rng(seed + 1)
    labels[valid] = rng.integers(0, 10, int(valid.sum()))
    labels[0, 2] = -1                          # a valid box without a class
    valid[1, 1] = False                        # an invalid box with a class
    labels[1, 8] = 3                           # padding with a class, invalid
    return boxes, labels, valid


@pytest.mark.parametrize("tasks", [NUSC_GROUPS, (NUSC_CLASS_NAMES,),
                                   (("car", "pedestrian"), ("bus", "truck", "barrier"))])
def test_task_label_tables_and_gt_remap_match_jax(tasks):
    ref = jh.task_label_tables(NUSC_CLASS_NAMES, tasks)
    assert th.task_label_tables(NUSC_CLASS_NAMES, tasks) == ref
    jgt, tgt = _gts(_task_gt(3))
    for to_local in ref[0]:
        got = th.remap_gt_for_task(tgt, to_local)
        want = jh.remap_gt_for_task(jgt, to_local)
        _eq(got.labels, want.labels), _eq(got.valid, want.valid), _eq(got.boxes, want.boxes)
        assert got.labels.dtype == torch.int32
        assert not (got.valid & (got.labels < 0)).any()


def _head_inputs(seed, c=128, tasks=NUSC_GROUPS):
    """Random per-task logits and regressions at C clusters, and the GT."""
    rng = np.random.default_rng(seed)
    gt_arrays = _task_gt(seed)
    xyz, qb, qv = _queries(seed + 1, gt_arrays[0], q=c)
    cls = [rng.normal(0, 2, (c, len(t))).astype(np.float32) for t in tasks]
    reg = [rng.normal(0, 0.5, (c, 10)).astype(np.float32) for _ in tasks]
    iou = [rng.normal(0, 1, c).astype(np.float32) for _ in tasks]
    return gt_arrays, (xyz, qb, qv), cls, reg, iou


@pytest.mark.parametrize("variant", ["six_tasks_iou_corner", "one_task"])
def test_multi_task_cluster_head_loss_matches_jax(variant):
    tasks = (NUSC_CLASS_NAMES,) if variant == "one_task" else NUSC_GROUPS
    gt_arrays, (xyz, qb, qv), cls, reg, iou = _head_inputs(5, tasks=tasks)
    jgt, tgt = _gts(gt_arrays)
    extra = variant == "six_tasks_iou_corner"
    kw = dict(with_corner_loss=extra, with_iou=extra)
    got = th.multi_task_cluster_head_loss(
        [_t(a) for a in cls], [_t(a) for a in reg], _t(xyz), _t(qb), _t(qv), tgt,
        HeadConfig(**kw), tasks, NUSC_CLASS_NAMES, prefix="p_",
        iou_logits_list=[_t(a) for a in iou] if extra else None)
    ref = jax.jit(functools.partial(jh.multi_task_cluster_head_loss, cfg=JHeadConfig(**kw),
                                    tasks=tasks, class_names=NUSC_CLASS_NAMES, prefix="p_"))(
        [jnp.asarray(a) for a in cls], [jnp.asarray(a) for a in reg], jnp.asarray(xyz),
        jnp.asarray(qb), jnp.asarray(qv), jgt,
        iou_logits_list=[jnp.asarray(a) for a in iou] if extra else None)
    assert set(got) == set(ref)
    for k in ref:
        if "num_pos" in k:
            assert float(got[k]) == float(ref[k]), k
        else:
            _close(got[k], ref[k])
    if variant == "one_task":
        assert "p_loss_cls" in got and not any("task" in k for k in got)
    else:
        assert len(got) == 6 * len([k for k in got if k.startswith("p_task0_")])
        assert sum(float(got[f"p_task{t}_num_pos"]) > 0 for t in range(6)) >= 3
    if extra:
        assert all(f"p_task{t}_loss_iou" in got for t in range(6))


@pytest.fixture
def pallas_nms(monkeypatch):
    """The JAX package's NMS through its Pallas scan in interpret mode."""
    monkeypatch.setattr(jnms, "_use_pallas_nms", lambda n: True)
    monkeypatch.setattr(pallas_kernels, "nms_scan_pallas",
                        functools.partial(pallas_kernels.nms_scan_pallas, interpret=True))


# ---------------------------------------------------------------------------
# the IoU branch, boxes_iou_3d, activations
# ---------------------------------------------------------------------------


def _iou_branch_case(mode):
    """test_nn_modules.py's IoU-branch case (three classes, four GT boxes,
    clusters on them and in clutter), with the label ``mode``."""
    cfg_kw = dict(in_channel=32, shared_mlp_dims=(32, 32), num_cls_layer=1, cls_hidden_dim=16,
                  num_classes=3, with_iou=True, with_corner_loss=True, iou_label_mode=mode,
                  common_attrs=(("center", 3, 1, 16), ("dim", 3, 1, 16), ("rot", 2, 1, 16),
                                ("vel", 2, 1, 16)))
    rng = np.random.default_rng(0)
    c = 24
    feats = rng.normal(size=(c, 32)).astype(np.float32)
    valid = rng.random(c) < 0.9
    boxes = np.zeros((1, 4, 10), np.float32)
    boxes[0, :, :7] = [[0, 0, -1, 3, 2, 1.5, 0.3]] * 4
    boxes[0, :, 0] = [0, 5, -5, 8]
    boxes[0, :, 9] = 1.0
    labels = np.array([[0, 1, 2, 0]], np.int32)
    gvalid = np.ones((1, 4), bool)
    xyz = rng.uniform(-10, 10, (c, 3)).astype(np.float32)
    xyz[:8, 0] = boxes[0, np.arange(8) % 4, 0] + rng.normal(0, 0.4, 8)
    xyz[:8, 1] = rng.normal(0, 0.4, 8)
    xyz[:8, 2] = -0.5
    return cfg_kw, feats, valid, (boxes, labels, gvalid), xyz


def test_boxes_iou_3d_matches_jax():
    # hand-made: equal boxes, a half-overlap in x, half the height, stacked
    # in z without overlap, rotated by 90 degrees, disjoint
    a = np.array([[0, 0, 0, 2, 2, 2, 0]] * 6, np.float32)
    b = np.array([[0, 0, 0, 2, 2, 2, 0], [1, 0, 0, 2, 2, 2, 0], [0, 0, 0, 2, 2, 1, 0],
                  [0, 0, 2, 2, 2, 2, 0], [0, 0, 0, 2, 2, 2, np.pi / 2], [9, 9, 0, 1, 1, 1, 0]],
                 np.float32)
    got = geometry.boxes_iou_3d(_t(a), _t(b))
    np.testing.assert_allclose(np.diag(got.numpy()), [1, 1 / 3, 0.5, 0, 1, 0], atol=1e-6)
    _close(got, jax.jit(jg.boxes_iou_3d)(jnp.asarray(a), jnp.asarray(b)))
    rng = np.random.default_rng(11)
    b1, b2 = _boxes(rng, 40), _boxes(rng, 30)
    got = geometry.boxes_iou_3d(_t(b1), _t(b2))
    _close(got, jax.jit(jg.boxes_iou_3d)(jnp.asarray(b1), jnp.asarray(b2)))
    assert int((got > 0.05).sum()) > 10 and float(got.max()) <= 1.0


@pytest.mark.parametrize("name", ["relu", "gelu", "silu", "tanh", "identity"])
def test_activations_match_jax(name):
    x = np.linspace(-6, 6, 101, dtype=np.float32)
    _close(get_activation(name)(_t(x)), j_get_activation(name)(jnp.asarray(x)))
    with pytest.raises(KeyError):
        get_activation("swish")


# ---------------------------------------------------------------------------
# clustering: FPS, ball grouping, hybrid per-group clustering, one-problem CCL
# ---------------------------------------------------------------------------


def _centers(seed, k=300, batch=3):
    """Voted centers of one group: blobs of points per sample, clutter,
    invalid rows (some with a batch id out of range)."""
    rng = np.random.default_rng(seed)
    blob = rng.uniform(-8, 8, (12, 3))
    xyz = (blob[rng.integers(0, 12, k)] + rng.normal(0, 0.3, (k, 3))).astype(np.float32)
    xyz[k // 2: k // 2 + 40] = rng.uniform(-10, 10, (40, 3))
    b = rng.integers(0, batch, k).astype(np.int32)
    valid = rng.random(k) > 0.15
    b[~valid & (rng.random(k) < 0.5)] = batch + 2
    return xyz, b, valid


@pytest.mark.parametrize("k,case", [(16, "random"), (64, "random"), (80, "few_valid"),
                                    (8, "all_invalid")])
def test_furthest_point_sample_and_ball_group_match_jax(k, case):
    xyz, _, valid = _centers(1, k=200)
    if case == "few_valid":
        valid[:] = False
        valid[[5, 17, 60, 61, 150]] = True     # fewer valid points than picks
    elif case == "all_invalid":
        valid[:] = False
    picks, sel = fps.furthest_point_sample(_t(xyz), _t(valid), k)
    jp, js = jfps.furthest_point_sample(jnp.asarray(xyz), jnp.asarray(valid), k)
    _eq(picks, jp), _eq(sel, js)
    assert picks.dtype == torch.int32
    if case == "random":
        assert len(set(picks.tolist())) == k and valid[picks.numpy()].all()
    lab = fps.ball_group(_t(xyz), _t(valid), _t(xyz)[picks.long()], sel, 1.5)
    _eq(lab, jfps.ball_group(jnp.asarray(xyz), jnp.asarray(valid), jnp.asarray(xyz)[jp], js, 1.5))


@pytest.mark.parametrize("case", ["random", "mixed_batch", "all_invalid"])
def test_connected_components_bev_matches_jax(case):
    xy, batch, valid = ccl_problem_arrays(case, 1, 300, seed=4)
    dist_ = 0.6
    xy = xy[0] * dist_
    z = np.random.default_rng(0).normal(size=(300, 1)).astype(np.float32)
    xyz = np.concatenate([xy, z], 1)             # a third column, ignored
    got = ccl.connected_components_bev(_t(xyz), _t(batch[0]), _t(valid[0]), dist_)
    ref = jccl.connected_components_bev(jnp.asarray(xyz), jnp.asarray(batch[0]),
                                        jnp.asarray(valid[0]), dist_)
    _eq(got, ref)
    assert got.dtype == torch.int32
    if case != "all_invalid":
        assert int(got.max()) > 2
        firsts = [int(np.flatnonzero(got.numpy() == c)[0]) for c in range(int(got.max()) + 1)]
        assert firsts == sorted(firsts)          # ids in order of their least node
    else:
        assert (got == -1).all()


def test_connected_components_bev_is_exact_where_jax_caps_its_iterations():
    """A reversed chain of 300 nodes (see ``test_torch_ops.py``'s reversed
    chain): the port returns one component, the JAX package's one-problem
    path stops after 64 iterations and splits the chain."""
    xy, batch, valid = ccl_problem_arrays("reversed_chain", 1, 300)
    got = ccl.connected_components_bev(_t(xy[0]), _t(batch[0]), _t(valid[0]), 1.0)
    assert (got == 0).all()
    ref = jccl.connected_components_bev(jnp.asarray(xy[0]), jnp.asarray(batch[0]),
                                        jnp.asarray(valid[0]), 1.0)
    assert len(np.unique(np.asarray(ref))) > 1


# ---------------------------------------------------------------------------
# build_fsd, the train step at world size 1, detection weight 0
# ---------------------------------------------------------------------------


def _jax_variable_shapes(jcfg):
    model = jfsd.SingleStageFSD(cfg=jcfg)
    pb = S.make_scene_arrays(seed=0, n_cap=jcfg.caps.points, max_gt=jcfg.caps.max_gt)
    jpb = JPB(points=jnp.asarray(pb["points"]), batch_idx=jnp.asarray(pb["batch_idx"]),
              valid=jnp.asarray(pb["valid"]))
    return jax.eval_shape(lambda k: model.init(k, jpb, 2, None, False), jax.random.key(0))


def _fsd_batch(cfg, seed=0):
    sc = S.make_scene_arrays(seed=seed, n_cap=cfg.caps.points, max_gt=cfg.caps.max_gt)
    return T.Batch(S.to_point_batch(sc, device="cpu"), None, S.to_ground_truth(sc, device="cpu"),
                   None)


def test_six_task_detection_weight_zero_leaves_the_heads_without_gradient():
    """Detection weight 0 (the segmentor-pretrain phase): every task's loss
    terms are 0 and the cluster head's gradients exactly 0, while the
    segmentor trains. (The JAX package scales only keys that start with
    "loss", so its six-task step keeps the ``task{t}_loss_*`` terms;
    ``test_torch_fsd.py`` holds the one-task step to it at weight 0.)"""
    cfg = tiny_fsd_config(tasks=NUSC_GROUPS)
    model = build_fsd(cfg, seed=0, device="cpu")
    batch = _fsd_batch(cfg)
    losses = model(batch.pb, 2, batch.gt, train=True, detection_weight=0.0)["losses"]
    T.total_loss(losses).backward()
    for k, v in losses.items():
        if k.startswith("task") and "loss" in k:
            assert float(v.detach()) == 0.0, k
    assert float(losses["task1_num_pos"]) > 0
    head = model.query_branch.bbox_head
    assert all(p.grad is None or not p.grad.any() for p in head.parameters())
    assert float(model.segmentor.VoteSegHead_0.Dense_0.weight.grad.abs().sum()) > 0
