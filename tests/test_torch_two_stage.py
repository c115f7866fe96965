"""The port's two-stage FSD (``models/roi.py::extract_roi_points``,
``models/rcnn.py``, ``models/two_stage.py``) against the JAX package's on
the CPU: the chunked RoI pooling and its ``dropped`` count (the grid path's
too), the IoU assignment, the ``GroupCorrectionHead`` with its loss and
gradients, ``rcnn_loss`` and ``rcnn_get_bboxes`` on inputs drawn with
numpy, and the tiny ``TwoStageFSD`` whole, the JAX variable tree carried
across by ``weights.from_jax_variables`` with ``strict=True``.

The whole model compiles one JAX step per module (a module-scoped fixture,
XLA's backend optimisation turned down, which only moves the reference by
float rounding): eval-form BN, ``value_and_grad`` of the summed loss and
``get_bboxes``, with the detection weight an argument, run at 1 and at 0.
Every UNet conv takes the gather path on both sides and torch runs one
thread (``test_torch_fsd.py`` says why). The decode's NMS runs through the
JAX package's Pallas scan in interpret mode for the function-level test.

Tolerances:

* integers and bools (pair indices, validity, ``dropped``, assignments,
  labels, ``num_pos``): equal;
* f32 functions of f32 inputs (pair geometry, IoU, the head, ``rcnn_loss``,
  the decode): ``F32_TOL`` 1e-5 relative to max(1, |ref|); the head's
  gradients ``HEAD_GRAD_TOL`` 1e-4 of each leaf's largest magnitude;
* the whole model, through the bf16 UNet (as ``test_torch_fsd.py``):
  outputs and losses ``BF16_CHAIN_TOL`` 4e-3, gradients ``LEAF_TOL`` 5e-2
  relative L2 per leaf and ``TOTAL_TOL`` 1e-2 over the tree.

``test_torch_two_stage_model.py`` holds more tests of this module's helpers
and fixtures, at its tolerances, in files of at most five tests, so that
xdist's ``--dist loadfile`` (files with more tests first) queues them behind
``tests/test_train.py``, the Tier-1 run's longest file.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from fixtures import make_scene
from fullysparsefusion_tpu.config import HeadConfig as JHeadConfig
from fullysparsefusion_tpu.config import tiny_fsd_config as j_tiny_fsd_config
from fullysparsefusion_tpu.models import rcnn as jrcnn
from fullysparsefusion_tpu.models import roi as jroi
from fullysparsefusion_tpu.models.two_stage import TwoStageFSD as JTwoStage
from fullysparsefusion_tpu.parallel import train as jtrain
from fullysparsefusion_tpu_torch import synthetic as S
from fullysparsefusion_tpu_torch.config import HeadConfig, tiny_fsd_config
from fullysparsefusion_tpu_torch.models import rcnn as trcnn
from fullysparsefusion_tpu_torch.models import roi as troi
from fullysparsefusion_tpu_torch.parallel import train as T
from fullysparsefusion_tpu_torch.train.hooks import RuntimeSchedule
from fullysparsefusion_tpu_torch.utils.containers import GroundTruth
from fullysparsefusion_tpu_torch.weights import build_two_stage_fsd, from_jax_variables
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)
from test_torch_fsd import SCENE, _gather_only
from test_torch_fsd_parts import pallas_nms  # noqa: F401 (fixture)
from test_torch_fsf import FAST_COMPILE, _numpy_variables
from test_torch_losses import _close, _eq, _gt_arrays, _gts, _t

F32_TOL = 1e-5
HEAD_GRAD_TOL = 1e-4
BF16_CHAIN_TOL = 4e-3
LEAF_TOL = 5e-2
TOTAL_TOL = 1e-2
EXTRA = (0.5, 0.5, 0.5)
ROI_HEAD = "roi_head."


def _jit(fn, **static):
    """A JAX reference function compiled once, its static arguments bound."""
    return jax.jit(functools.partial(fn, **static), compiler_options=FAST_COMPILE)


# ---------------------------------------------------------------------------
# RoI pooling
# ---------------------------------------------------------------------------


def _roi_case(case, seed=0, n=1500):
    """Points of two samples in a 40 m square and RoIs over them: centers on
    points, 2-6 m boxes, any yaw. ``stacked``: every RoI three deep (the
    same box at i, i + q/3 and i + 2q/3, each point inside three), so
    ``dropped`` > 0; ``all_invalid``: no valid RoI; ``off_chunk``: Q = 100,
    not a multiple of the 64-RoI chunk."""
    rng = np.random.default_rng(seed)
    q = {"random": 128, "stacked": 96, "all_invalid": 64, "off_chunk": 100}[case]
    xyz = rng.uniform([-20, -20, -2], [20, 20, 2], (n, 3)).astype(np.float32)
    pbatch = rng.integers(0, 2, n).astype(np.int32)
    pvalid = rng.random(n) > 0.1
    src = rng.integers(0, n, q)
    rois = np.zeros((q, 7), np.float32)
    rois[:, :2] = xyz[src, :2] + rng.normal(0, 0.5, (q, 2))
    rois[:, 2] = rng.uniform(-2.5, -1.5, q)
    rois[:, 3:6] = rng.uniform(2.0, 6.0, (q, 3))
    rois[:, 6] = rng.uniform(-np.pi, np.pi, q)
    rbatch = pbatch[src].copy()
    rvalid = rng.random(q) > 0.15
    if case == "stacked":
        third = q // 3
        for i in (1, 2):
            rois[i * third:(i + 1) * third] = rois[:third]
            rbatch[i * third:(i + 1) * third] = rbatch[:third]
        rvalid[:] = True
    if case == "all_invalid":
        rvalid[:] = False
    return xyz, pbatch, pvalid, rois, rbatch, rvalid


def _check_pairs(got, ref, fields=("point_idx", "roi_idx", "valid", "dropped")):
    for f in fields:
        _eq(getattr(got, f), getattr(ref, f))
    _close(got.geometry, ref.geometry, F32_TOL)


@pytest.mark.parametrize("case", ["random", "stacked", "all_invalid", "off_chunk"])
def test_extract_roi_points_matches_jax(case):
    """The chunked all-pairs pooling, pair for pair (the JAX ``lax.scan``
    over chunks of 64 RoIs, its pad chunk included), ``dropped`` exactly."""
    arrays = _roi_case(case)
    ref = _jit(jroi.extract_roi_points, extra_wlh=EXTRA, capacity=2048)(
        *[jnp.asarray(a) for a in arrays])
    got = troi.extract_roi_points(*[_t(a) for a in arrays], EXTRA, 2048)
    _check_pairs(got, ref)
    n_pairs, dropped = int(got.valid.sum()), int(got.dropped)
    if case == "all_invalid":
        assert n_pairs == 0 and dropped == 0
    else:
        assert n_pairs > 100 and dropped > 0
    if case == "stacked":   # each point keeps the two lowest of its three copies
        assert dropped * 2 >= n_pairs
        assert int(got.roi_idx[got.valid].max()) < 2 * (arrays[3].shape[0] // 3)


@pytest.mark.parametrize("case", ["random", "stacked"])
def test_extract_roi_points_grid_dropped_matches_jax(case):
    """The grid path's pairs and its ``dropped`` count (memberships past
    ``rois_per_point``), exactly."""
    arrays = _roi_case(case, seed=1)
    kw = dict(batch_size=2, bev_lo=(-24.0, -24.0), bev_hi=(24.0, 24.0))
    ref = _jit(jroi.extract_roi_points_grid, extra_wlh=EXTRA, capacity=2048, **kw)(
        *[jnp.asarray(a) for a in arrays])
    got = troi.extract_roi_points_grid(*[_t(a) for a in arrays], EXTRA, 2048, **kw)
    _check_pairs(got, ref)
    assert int(got.dropped) > 0
    # the grid and the all-pairs test keep the same pairs here; the grid's
    # ``dropped`` leaves out what its per-cell candidate cap drops
    chunked = troi.extract_roi_points(*[_t(a) for a in arrays], EXTRA, 2048)
    _check_pairs(chunked, ref, ("point_idx", "roi_idx", "valid"))
    assert int(chunked.dropped) >= int(got.dropped)


# ---------------------------------------------------------------------------
# assignment, the head, the loss, the decode
# ---------------------------------------------------------------------------


def _proposals(gt_boxes, gt_valid, seed, q=48, jitter=0.1):
    """Half the proposals are jittered valid GT boxes (positives), the rest
    random boxes; some invalid. Returns (rois [q, 7], batch, valid)."""
    rng = np.random.default_rng(seed)
    b, m, _ = gt_boxes.shape
    flat, fv = gt_boxes.reshape(-1, gt_boxes.shape[-1]), gt_valid.reshape(-1)
    fb = np.repeat(np.arange(b), m).astype(np.int32)
    sel = rng.choice(np.where(fv)[0], q // 2)
    rois = np.zeros((q, 7), np.float32)
    rois[:q // 2] = flat[sel, :7] + rng.normal(0, jitter, (q // 2, 7))
    rois[q // 2:, :2] = rng.uniform(-10, 10, (q - q // 2, 2))
    rois[q // 2:, 2] = rng.uniform(-1.5, -0.5, q - q // 2)
    rois[q // 2:, 3:6] = rng.uniform(1.5, 4.0, (q - q // 2, 3))
    rois[q // 2:, 6] = rng.uniform(-np.pi, np.pi, q - q // 2)
    batch = np.concatenate([fb[sel], rng.integers(0, b, q - q // 2)]).astype(np.int32)
    return rois, batch, rng.random(q) > 0.1


def test_assign_rois_by_iou_matches_jax():
    """``tests/test_rcnn.py``'s case (one GT, a shifted copy and a far box)
    and random proposals over two samples: assignments equal, IoU within
    ``F32_TOL``."""
    one = (np.asarray([[[0, 0, 0, 4, 4, 2, 0, 0, 0, 1]]], np.float32), np.asarray([[1]], np.int32),
           np.asarray([[True]]))
    rois = np.asarray([[0.2, 0, 0, 4, 4, 2, 0], [20, 0, 0, 4, 4, 2, 0]], np.float32)
    jgt, tgt = _gts(one)
    a, iou = trcnn.assign_rois_by_iou(_t(rois), torch.zeros(2, dtype=torch.int32),
                                      torch.ones(2, dtype=torch.bool), tgt)
    assert a.tolist() == [0, -1] and float(iou[0]) > 0.8
    ja, jiou = _jit(jrcnn.assign_rois_by_iou)(jnp.asarray(rois), jnp.zeros(2, jnp.int32),
                                        jnp.ones(2, bool), jgt)
    _eq(a, ja), _close(iou, jiou)

    arrays = _gt_arrays(3)
    jgt, tgt = _gts(arrays)
    rois, rb, rv = _proposals(arrays[0], arrays[2], seed=4)
    ja, jiou = _jit(jrcnn.assign_rois_by_iou)(jnp.asarray(rois), jnp.asarray(rb),
                                              jnp.asarray(rv), jgt)
    a, iou = trcnn.assign_rois_by_iou(_t(rois), _t(rb), _t(rv), tgt)
    _eq(a, ja), _close(iou, jiou)
    assert int((a >= 0).sum()) >= 10 and int((a < 0).sum()) >= 10


def _head_case():
    """The tiny config's scene (batch 2), random per-point features and
    proposals on its GT: (JAX args, port args, JAX GT, port GT)."""
    jcfg = j_tiny_fsd_config()
    pb, gt = make_scene(seed=0, n_cap=jcfg.caps.points, max_gt=jcfg.caps.max_gt)
    rng = np.random.default_rng(8)
    feats = rng.normal(size=(jcfg.caps.points, 35)).astype(np.float32)
    rois, rb, rv = _proposals(np.asarray(gt.boxes), np.asarray(gt.valid), seed=9, q=40)
    arrays = (np.asarray(pb.points), feats, np.asarray(pb.batch_idx), np.asarray(pb.valid), rois,
              rb, rv)
    tgt = GroundTruth(_t(gt.boxes), _t(gt.labels), _t(gt.valid))
    return [jnp.asarray(a) for a in arrays], [_t(a) for a in arrays], gt, tgt


def test_group_correction_head_and_its_loss_gradients_match_jax():
    """The ``GroupCorrectionHead`` (pooling, three 128-wide SIR blocks, the
    512-wide class and box MLPs) with carried weights and its ``rcnn_loss``:
    outputs, losses and every parameter's gradient, positives included."""
    jcfg, cfg = j_tiny_fsd_config(), tiny_fsd_config()
    jargs, targs, jgt, tgt = _head_case()
    head = jrcnn.GroupCorrectionHead(cfg=jcfg.head, caps=jcfg.caps)
    shapes = jax.eval_shape(lambda k: head.init(k, *jargs), jax.random.key(0))
    jvars = _numpy_variables(shapes, seed=10)

    def run(params):
        def loss_fn(p):
            outs = head.apply({"params": p}, *jargs)
            losses = jrcnn.rcnn_loss(outs, jargs[4], jargs[5], jargs[6], jgt, jcfg.head)
            return jtrain.total_loss(losses), (outs, losses)

        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    (_, (jouts, jlosses)), jgrads = jax.tree_util.tree_map(
        np.asarray, jax.jit(run, compiler_options=FAST_COMPILE)(jvars["params"]))
    m = trcnn.GroupCorrectionHead(cfg.head, cfg.caps, point_dim=5, feat_dim=35)
    m.load_state_dict(from_jax_variables(jvars), strict=True)
    outs = m(*targs)
    losses = trcnn.rcnn_loss(outs, *targs[4:], tgt, cfg.head)
    T.total_loss(losses).backward()
    for k in ("cls_logits", "reg_preds"):
        _close(outs[k], jouts[k])
    _eq(outs["nonempty"], jouts["nonempty"])
    assert set(losses) == set(jlosses) == {"rcnn_loss_cls", "rcnn_loss_reg", "rcnn_num_pos"}
    assert float(losses["rcnn_num_pos"]) == float(jlosses["rcnn_num_pos"]) >= 10
    for k in ("rcnn_loss_cls", "rcnn_loss_reg"):
        _close(losses[k], jlosses[k])
    ref = from_jax_variables({"params": jgrads})
    grads = dict(m.named_parameters())
    assert set(ref) == set(grads)
    for k, g in ref.items():
        _close(grads[k].grad, g.numpy(), HEAD_GRAD_TOL, scale=float(g.abs().max()))
    assert float(ref["MLP_1.Dense_2.weight"].abs().max()) > 0
    assert 0 < int(outs["num_roi_points"]) and int(outs["dropped"]) >= 0


def test_rcnn_loss_matches_jax():
    """Ten classes, random logits and residuals, proposals on the GT."""
    arrays = _gt_arrays(11)
    jgt, tgt = _gts(arrays)
    rois, rb, rv = _proposals(arrays[0], arrays[2], seed=12, q=64)
    rng = np.random.default_rng(13)
    outs = dict(cls_logits=rng.normal(0, 2, (64, 10)).astype(np.float32),
                reg_preds=rng.normal(0, 0.5, (64, 10)).astype(np.float32))
    cfg = dict(focal_gamma=2.0, loss_cls_weight=2.0)
    ref = _jit(jrcnn.rcnn_loss, cfg=JHeadConfig(**cfg), prefix="x_")(
        {k: jnp.asarray(v) for k, v in outs.items()}, jnp.asarray(rois), jnp.asarray(rb),
        jnp.asarray(rv), jgt)
    got = trcnn.rcnn_loss({k: _t(v) for k, v in outs.items()}, _t(rois), _t(rb), _t(rv), tgt,
                          HeadConfig(**cfg), prefix="x_")
    assert set(got) == set(ref) == {"x_loss_cls", "x_loss_reg", "x_num_pos"}
    assert float(got["x_num_pos"]) == float(ref["x_num_pos"]) >= 10
    for k in ("x_loss_cls", "x_loss_reg"):
        _close(got[k], ref[k])


def test_rcnn_get_bboxes_matches_jax(pallas_nms):
    """Ten classes over 96 proposals of two samples, the JAX decode's NMS
    through ``nms_scan_pallas(interpret=True)``."""
    arrays = _gt_arrays(14)
    rois, rb, _ = _proposals(arrays[0], arrays[2], seed=15, q=96, jitter=0.3)
    rng = np.random.default_rng(16)
    outs = dict(cls_logits=rng.normal(-1, 2, (96, 10)).astype(np.float32),
                reg_preds=rng.normal(0, 0.3, (96, 10)).astype(np.float32),
                nonempty=rng.random(96) > 0.2)
    cfg = dict(max_num=80, score_thr=0.2)
    ref = _jit(jrcnn.rcnn_get_bboxes, batch_size=2, cfg=JHeadConfig(**cfg))(
        {k: jnp.asarray(v) for k, v in outs.items()}, jnp.asarray(rois), jnp.asarray(rb))
    got = trcnn.rcnn_get_bboxes({k: _t(v) for k, v in outs.items()}, _t(rois), _t(rb), 2,
                                HeadConfig(**cfg))
    assert got.valid.shape == (2, 80)
    _eq(got.valid, ref.valid), _eq(got.labels, ref.labels)
    _close(got.boxes, ref.boxes), _close(got.scores, ref.scores)
    assert int(got.valid.sum()) >= 40 and len(got.labels[got.valid].unique()) >= 8


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def two_stage():
    """The tiny two-stage FSD, eval-form BN, at detection weights 1 and 0:
    the JAX package's forward, loss dict, gradient tree and ``get_bboxes``
    (one compile) and the port's."""
    jcfg, cfg = _gather_only(j_tiny_fsd_config()), _gather_only(tiny_fsd_config())
    jpb, jgt = make_scene(n_cap=jcfg.caps.points, max_gt=jcfg.caps.max_gt, **SCENE)
    model = JTwoStage(cfg=jcfg)
    shapes = jax.eval_shape(lambda k: model.init(k, jpb, 2, None, False), jax.random.key(0))
    jvars = _numpy_variables(shapes)

    def run(params, stats, det_weight):
        def loss_fn(p):
            out = model.apply({"params": p, "batch_stats": stats}, jpb, 2, jgt, False, 0.0,
                              det_weight)
            return jtrain.total_loss(out["losses"]), out

        (loss, out), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        det = model.apply({"params": params, "batch_stats": stats}, out, 2,
                          method=JTwoStage.get_bboxes)
        return loss, out, grads, det

    step = jax.jit(run, compiler_options=FAST_COMPILE)
    ref = {w: jax.tree_util.tree_map(np.asarray, step(jvars["params"], jvars["batch_stats"], w))
           for w in (1.0, 0.0)}
    sc = S.make_scene_arrays(n_cap=cfg.caps.points, max_gt=cfg.caps.max_gt, **SCENE)
    tpb, tgt = S.to_point_batch(sc, device="cpu"), S.to_ground_truth(sc, device="cpu")
    got = {}
    for w in (1.0, 0.0):
        m = build_two_stage_fsd(cfg, device="cpu", jax_variables=jvars)
        out = m(tpb, 2, tgt, train=False, detection_weight=w)
        loss = T.total_loss(out["losses"])
        loss.backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in m.named_parameters()}
        got[w] = (loss, out, grads, m.get_bboxes(out, 2))
    return dict(ref=ref, got=got)


def _forward_outputs(o):
    res = {f"seg_out.{k}": o["seg_out"][k] for k in ("seg_logits", "vote_preds", "valid")}
    res.update({k: o[k] for k in ("cluster_xyz", "cluster_batch", "cluster_valid", "num_clusters",
                                  "cls_logits", "reg_preds", "rois", "roi_batch", "roi_valid")})
    res.update({f"rcnn.{k}": o["rcnn"][k] for k in ("cls_logits", "reg_preds", "nonempty")})
    return res


# ---------------------------------------------------------------------------
# the weights, the train step
# ---------------------------------------------------------------------------


def test_two_stage_sharded_train_step_at_world_size_one_equals_train_step_bitwise(tmp_path):
    """``sharded_train_step`` (the FSD forward, ``rcnn_loss``'s two
    ``mesh_mean``s over the group) under a gloo group of world size 1 in
    this process, against ``train_step`` from the same state: losses,
    gradient norm, parameters and BN buffers bitwise equal, the
    ``roi_head`` trained."""
    cfg = tiny_fsd_config()
    state = build_two_stage_fsd(cfg, seed=0, device="cpu").state_dict()
    sc = S.make_scene_arrays(seed=0, n_cap=cfg.caps.points, max_gt=cfg.caps.max_gt)
    batch = T.Batch(S.to_point_batch(sc, device="cpu"), None, S.to_ground_truth(sc, device="cpu"),
                    None)
    out = {}
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
                            rank=0, world_size=1)
    try:
        for name, group in (("train_step", None), ("sharded", dist.group.WORLD)):
            model = build_two_stage_fsd(cfg, device="cpu")
            model.load_state_dict(state)
            opt = T.make_optimizer(model, total_steps=10)
            loss, losses, gnorm = T.sharded_train_step(model, opt, RuntimeSchedule(), batch, 0,
                                                       group)
            out[name] = (float(loss), {k: float(v) for k, v in losses.items()}, float(gnorm),
                         model.state_dict())
    finally:
        dist.destroy_process_group()
    a, b = out["train_step"], out["sharded"]
    assert a[:3] == b[:3]
    assert "rcnn_loss_cls" in a[1] and a[1]["rcnn_loss_cls"] > 0
    for k, v in a[3].items():
        assert torch.equal(v, b[3][k]), k
    for k in ("roi_head.MLP_0.Dense_2.weight", "rpn.segmentor.VoteSegHead_0.Dense_0.weight"):
        assert not torch.equal(a[3][k], state[k]), k


def test_dataclass_defaults_match_between_packages():
    """The two-stage's RCNN takes the first stage's head config: the port's
    defaults equal the JAX package's field for field."""
    assert dataclasses.asdict(HeadConfig()) == dataclasses.asdict(JHeadConfig())
