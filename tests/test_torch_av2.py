"""Argoverse 2 in the PyTorch port against the JAX package on the CPU: the
config, a tiny AV2-shaped FSF (26 classes in AV2's six groups, code size 8
without velocity, 7 cameras, 4-dim points, AV2's cluster voxel sizes,
connected distances and score thresholds), the AV2 metric, the host-side
pipeline transforms and the AV2 reader.

One JAX jit runs the tiny model's eval-form forward with losses +
``get_bboxes`` and a train-form forward with losses, on weights drawn with
numpy into the JAX variable tree (``test_torch_fsf._numpy_variables``) and
carried to the port by ``weights.from_jax_variables``. Tolerances, as
``test_torch_fsf.py`` and ``test_torch_train.py`` set them:

* integer and bool outputs and the loss dict's counts: equal (the
  ``assign_recall`` ratios of those counts within two f32 ulps: XLA's
  division lands an ulp from PyTorch's at 5/6);
* f32 outputs downstream of the sparse UNet, and the losses of the port's
  own forward: 4e-3 relative / absolute (bf16 activations between the
  UNet's convs, one bf16 ulp is 2^-8);
* the head and the decode fed the JAX forward's own inputs, and the losses
  the port computes from the JAX train-form forward's own outputs: 1e-5;
* ``evaluate_av2``: 1e-12 (the same NumPy arithmetic on both sides);
* pipelines and reader: bitwise.

The train-form call runs every UNet conv on the gather path, as
``test_torch_train.py`` does. Even so train-form BN carries bf16 ulps into
the segmentation logits (0.04 apart here), and three points whose group
score lies within 7e-4 of AV2's 0.25 threshold change sides: the LiDAR
branch then sees other foreground sets (26 against 24 points). The port's
own train-form forward is therefore held on the terms upstream of that
decision (segmentor and camera queries); every term, the LiDAR branch's and
the refinement's included, is held on the JAX forward's own outputs.
Gradients are not compared here (``test_torch_train.py`` holds them at the
nuScenes shape): a JAX ``value_and_grad`` compile would double the file's
time.

``test_torch_av2_phases.py``, ``test_torch_av2_heads.py`` and
``test_torch_av2_train_form.py`` hold more tests of this module's helpers
and fixtures, at its tolerances, in files of at most five tests, so that
xdist's ``--dist loadfile`` (files with more tests first) queues them behind
``tests/test_train.py``, the Tier-1 run's longest file.
"""
import dataclasses
import pickle

import jax
import numpy as np
import pytest
import torch

from fixtures import make_camera_data, make_scene, with_noaug_channels
from fullysparsefusion_tpu import config as jcfg
from fullysparsefusion_tpu.data import av2 as jav2
from fullysparsefusion_tpu.data import pipelines as jP
from fullysparsefusion_tpu.eval.av2_detection import evaluate_av2 as j_evaluate_av2
from fullysparsefusion_tpu.eval.detection import DetectionRecord as JRecord
from fullysparsefusion_tpu.models.fsf import FSF as JFSF
from fullysparsefusion_tpu_torch import config as tcfg
from fullysparsefusion_tpu_torch import synthetic as S
from fullysparsefusion_tpu_torch.data import av2 as tav2
from fullysparsefusion_tpu_torch.data import pipelines as tP
from fullysparsefusion_tpu_torch.eval.av2_detection import evaluate_av2
from fullysparsefusion_tpu_torch.eval.detection import DetectionRecord
from fullysparsefusion_tpu_torch.weights import build_fsf
from test_torch_fsf import FAST_COMPILE, _numpy_variables
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)

BF16_CHAIN_TOL = 4e-3
F32_TOL = 1e-5
LOSS_TOL = 4e-3
METRIC_TOL = 1e-12
RECALL_TOL = 2.0 ** -22     # two f32 ulps of a ratio in [0.5, 1]
# the JAX package's bench capacities at AV2 scale (tools/bench_av2.py, batch 1)
AV2_BENCH_CAPS = dict(
    points=131072, voxels=57344, prevox=98304, fg_per_group=4096,
    cluster_voxels_per_group=1024, clusters=1024, max_gt=128, frustum_points=16384,
    frustum_objects=256, roi_points=32768, max_roi_points=512,
)
AV2_STAGE_CAPS = (57344, 122880, 143360, 88576, 32768)


def tiny_av2_config(m, gather_only=False):
    """The tiny FSF of config module ``m`` (either package's) with AV2's
    shape: 26 classes in AV2's groups, code size 8 without the velocity
    attribute, 7 cameras, 4-dim points, AV2's cluster voxel sizes,
    connected distances, score thresholds and refinement distances.
    ``gather_only`` runs every UNet conv on the gather path."""
    n = len(m.AV2_CLASS_NAMES)
    base, av2 = m.tiny_fsf_config(), m.av2_fsf_config().fsd

    def head(h):
        return dataclasses.replace(h, num_classes=n, code_size=8, common_attrs=tuple(
            a for a in h.common_attrs if a[0] != "vel"))

    seg = dataclasses.replace(base.fsd.segmentor, num_classes=n, point_dim=4,
                              **({"unet_dense_min_occupancy": 2.0} if gather_only else {}))
    fsd = dataclasses.replace(
        base.fsd, class_names=m.AV2_CLASS_NAMES, group_names=m.AV2_GROUPS, segmentor=seg,
        head=head(base.fsd.head), score_thresh=av2.score_thresh,
        cluster_voxel_sizes=av2.cluster_voxel_sizes, connected_dists=av2.connected_dists)
    return dataclasses.replace(base, fsd=fsd, num_cams=7, frustum_head=head(base.frustum_head),
                               refined_head=head(base.refined_head), refine_max_dist=(1.0,) * n)


# --- config ------------------------------------------------------------------


@pytest.mark.parametrize("caps", ["default", "bench"])
def test_av2_config_matches_jax_field_by_field(caps):
    def build(m):
        if caps == "default":
            return m.av2_fsf_config()
        cfg = m.av2_fsf_config(m.Capacities(**AV2_BENCH_CAPS))
        seg = dataclasses.replace(cfg.fsd.segmentor, unet_stage_capacities=AV2_STAGE_CAPS)
        return dataclasses.replace(cfg, fsd=dataclasses.replace(cfg.fsd, segmentor=seg))

    t, j = build(tcfg), build(jcfg)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.num_classes, t.num_cams, t.refined_head.code_size) == (26, 7, 8)
    assert tcfg.AV2_CLASS_NAMES == jcfg.AV2_CLASS_NAMES and tcfg.AV2_GROUPS == jcfg.AV2_GROUPS


def test_tiny_av2_config_matches_jax():
    for g in (False, True):
        assert dataclasses.asdict(tiny_av2_config(tcfg, g)) == \
            dataclasses.asdict(tiny_av2_config(jcfg, g))


def _stage_counts(vox, sc, xp, pb, cfg, caps):
    """Active voxels of each UNet stage (voxelize, then the strided convs'
    output sets) at ``caps``, by either package's ops (``xp`` its array
    module)."""
    seg = cfg.fsd.segmentor
    s, _, vb, vc = vox.voxelize_points(pb["xyz"], pb["batch_idx"], pb["valid"], seg.voxel_size,
                                       seg.point_cloud_range, caps[0])
    st = sc.SparseTensor(feats=xp.zeros((caps[0], 1)), coords=vc, batch=vb, valid=s.seg_valid,
                         dims=vox.grid_dims(seg.voxel_size, seg.point_cloud_range), batch_size=1)
    out = [int(st.valid.sum())]
    for i, pad in enumerate(seg.unet_strided_paddings):
        oc, ob, ov, od = sc.downsample_coords(st, (3, 3, 3), (2, 2, 2), pad, caps[i + 1])
        st = sc.SparseTensor(feats=xp.zeros((caps[i + 1], 1)), coords=oc, batch=ob, valid=ov,
                             dims=od, batch_size=1)
        out.append(int(ov.sum()))
    return out


# --- the tiny AV2-shaped FSF ---------------------------------------------------


def _run_jax():
    cfg = tiny_av2_config(jcfg)
    pb, gt = make_scene(seed=0, n_cap=cfg.caps.points, max_gt=cfg.caps.max_gt,
                        num_classes=cfg.num_classes, point_dim=4)
    cam = make_camera_data(pb, gt, num_cams=cfg.num_cams, num_classes=cfg.num_classes)
    pb = with_noaug_channels(pb)
    model = JFSF(cfg=cfg)
    train_model = JFSF(cfg=tiny_av2_config(jcfg, gather_only=True))
    shapes = jax.eval_shape(
        lambda k: model.init(k, pb, cam, 2, None, None, False,
                             method=lambda m, *a, **kw: m(*a, **kw)),
        jax.random.key(0))
    jvars = _numpy_variables(shapes)

    def run(v):
        out = model.apply(v, pb, cam, 2, gt, gt, False)
        det = model.apply(v, out, 2, method=JFSF.get_bboxes)
        tout, _ = train_model.apply(v, pb, cam, 2, gt, gt, True, 0.0, 1.0,
                                    mutable=["batch_stats"])
        return out, det, tout

    out, det, tout = jax.tree_util.tree_map(
        np.asarray, jax.jit(run, compiler_options=FAST_COMPILE)(jvars))
    return jvars, out, det, tout


@pytest.fixture(scope="module")
def parity():
    jvars, jout, jdet, jtout = _run_jax()
    cfg = tiny_av2_config(tcfg)
    sc = S.make_scene_arrays(seed=0, n_cap=cfg.caps.points, max_gt=cfg.caps.max_gt,
                             num_classes=cfg.num_classes, point_dim=4)
    cam = S.make_camera_arrays(sc["gt_boxes"], sc["gt_labels"], sc["gt_valid"],
                               num_cams=cfg.num_cams, num_classes=cfg.num_classes)
    pb, cd = S.fsf_inputs(sc, cam, device="cpu")
    gt = S.to_ground_truth(sc, device="cpu")
    model = build_fsf(cfg, device="cpu", jax_variables=jvars)
    with torch.no_grad():
        out = model(pb, cd, 2, gt, gt, train=False)
        det = model.get_bboxes(out, 2)
    tmodel = build_fsf(tiny_av2_config(tcfg, gather_only=True), device="cpu",
                       jax_variables=jvars)
    with torch.no_grad():
        tout = tmodel(pb, cd, 2, gt, gt, train=True)
        pb_inner = type(pb)(points=pb.points[:, :-3], batch_idx=pb.batch_idx, valid=pb.valid)
        recomputed = tmodel._losses(pb_inner, cd, gt, gt, _to_torch(jtout))
    return dict(jout=jout, jdet=jdet, jtout=jtout, model=model, out=out, det=det, tout=tout,
                recomputed=recomputed, cfg=cfg)


def _to_torch(x):
    """The JAX forward's result dict as the port's: arrays to tensors, a
    one-task head's per-task lists to their one entry."""
    if isinstance(x, dict):
        return {k: _to_torch(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        if len(x) == 1 and isinstance(x[0], np.ndarray):
            return _to_torch(x[0])
        return [_to_torch(v) for v in x]
    return torch.from_numpy(np.array(x))


def _hold_losses(ref, got, tol, keys=None):
    for k in keys or ref:
        a, b = float(ref[k]), float(got[k])
        if "num_pos" in k:
            assert a == b, k
        elif "recall" in k:     # a ratio of equal counts, XLA's f32 division an ulp off
            assert abs(a - b) <= RECALL_TOL * abs(a), (k, a, b)
        else:
            assert abs(a - b) <= tol * max(1.0, abs(a)), (k, a, b)


# --- the AV2 metric --------------------------------------------------------------


def _pools(seed, n_records=4, num_classes=6):
    """Seeded record pools: class 4 has predictions and no GT, class 5
    neither; a fifth of the boxes beyond 150 m; tied scores."""
    rng = np.random.default_rng(seed)
    pools = []
    for _ in range(n_records):
        n_gt, n_det = rng.integers(0, 12), rng.integers(0, 30)

        def boxes(k):
            b = np.zeros((k, 7))
            r = np.where(rng.random(k) < 0.2, rng.uniform(150, 200, k), rng.uniform(0, 140, k))
            th = rng.uniform(-np.pi, np.pi, k)
            b[:, 0], b[:, 1], b[:, 2] = r * np.cos(th), r * np.sin(th), rng.uniform(-2, 0, k)
            b[:, 3:6] = rng.uniform(0.5, 5.0, (k, 3))
            b[:, 6] = rng.uniform(-np.pi, np.pi, k)
            return b

        gt = boxes(n_gt)
        gt_labels = rng.integers(0, 4, n_gt)
        det = boxes(n_det)
        near = rng.random(n_det) < 0.6
        if n_gt:                                         # detections near GT boxes
            src = rng.integers(0, n_gt, n_det)
            det[near] = gt[src[near]] + rng.normal(0, 0.7, (int(near.sum()), 7))
        labels = np.where(near & (n_gt > 0), gt_labels[src] if n_gt else 0,
                          rng.integers(0, 5, n_det))
        scores = np.round(rng.random(n_det), 1)          # ties
        pools.append((det, scores, labels, gt, gt_labels))
    return pools


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluate_av2_matches_jax(seed):
    pools = _pools(seed)
    names = [f"C{i}" for i in range(6)]
    got = evaluate_av2([DetectionRecord(*p) for p in pools], 6, names)
    ref = j_evaluate_av2([JRecord(*p) for p in pools], 6, names)
    assert set(got["per_class"]) == set(ref["per_class"])
    assert "C5" not in got["per_class"]                  # no GT, no detections
    for k in ("mAP", "CDS"):
        assert abs(got[k] - ref[k]) <= METRIC_TOL, k
    for c, m in ref["per_class"].items():
        for k, v in m.items():
            assert abs(got["per_class"][c][k] - v) <= METRIC_TOL, (c, k)


def test_evaluate_av2_empty_matches_jax():
    empty = (np.zeros((0, 7)), np.zeros(0), np.zeros(0, int), np.zeros((0, 7)), np.zeros(0, int))
    assert evaluate_av2([DetectionRecord(*empty)], 3) == \
        j_evaluate_av2([JRecord(*empty)], 3) == {"mAP": 0.0, "CDS": 0.0, "per_class": {}}


# --- pipelines -------------------------------------------------------------------


def _points(rng, n=500, d=4):
    p = rng.normal(0, 30, (n, d)).astype(np.float32)
    p[:, 3] = rng.uniform(0, 255, n)
    return p


def _gt(rng, m=12, cols=9):
    b = rng.normal(0, 30, (m, cols)).astype(np.float32)
    b[:, 3:6] = np.abs(b[:, 3:6]) / 10 + 0.5
    return b


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", range(4))
def test_transforms_match_jax_bitwise(seed):
    tp = tP.sample_transform_params(np.random.default_rng(seed), translation_std=(0.2, 0.2, 0.1))
    jtp = jP.sample_transform_params(np.random.default_rng(seed), translation_std=(0.2, 0.2, 0.1))
    for f in ("rotation", "scale", "translation", "flip_x", "flip_y"):
        _same(getattr(tp, f), getattr(jtp, f))
    rng = np.random.default_rng(100 + seed)
    pts = _points(rng)
    _same(tP.apply_points_transform(pts, tp), jP.apply_points_transform(pts, jtp))
    for cols in (7, 9):
        b = _gt(rng, cols=cols)
        _same(tP.apply_boxes_transform(b, tp), jP.apply_boxes_transform(b, jtp))
    for flips in ((True, False), (False, True), (True, True)):
        f = dict(rotation=0.3, scale=1.02, flip_x=flips[0], flip_y=flips[1])
        b = _gt(rng)
        _same(tP.apply_boxes_transform(b, tP.TransformParams(**f)),
              jP.apply_boxes_transform(b, jP.TransformParams(**f)))


def test_filters_and_shuffle_match_jax_bitwise():
    rng = np.random.default_rng(7)
    pts = _points(rng, 800)
    pcr = (-40.0, -40.0, -3.2, 40.0, 40.0, 3.2)
    _same(tP.save_noaug_channels(pts), jP.save_noaug_channels(pts))
    _same(tP.filter_points_range(pts, pcr), jP.filter_points_range(pts, pcr))
    _same(tP.normalize_intensity(pts), jP.normalize_intensity(pts))
    b, lab = _gt(rng, 30), rng.integers(0, 26, 30).astype(np.int32)
    got = tP.filter_boxes_range(b, lab, (-40, -40, 40, 40), [b * 2])
    ref = jP.filter_boxes_range(b, lab, (-40, -40, 40, 40), [b * 2])
    _same(got[0], ref[0]), _same(got[1], ref[1]), _same(got[2][0], ref[2][0])
    assert tP.filter_boxes_range(b, lab, (-40, -40, 40, 40))[2] is None
    _same(tP.shuffle_points(pts, np.random.default_rng(3)),
          jP.shuffle_points(pts, np.random.default_rng(3)))


@pytest.mark.parametrize("cap,max_gt,cols", [(2048, 16, 7), (700, 5, 9)])
def test_collate_scene_matches_jax_bitwise(cap, max_gt, cols):
    """``cap`` 700 and ``max_gt`` 5 cut the second sample's points and GT."""
    rng = np.random.default_rng(cap)
    samples = [dict(points=_points(rng, n, 7), gt_boxes=_gt(rng, m, cols),
                    gt_labels=rng.integers(0, 26, m).astype(np.int32),
                    no_aug_gt_boxes=_gt(rng, m, cols))
               for n, m in ((400, 4), (500, 9))]
    got, ref = tP.collate_scene(samples, cap, max_gt), jP.collate_scene(samples, cap, max_gt)
    assert set(got) == set(ref)
    for k in ref:
        _same(got[k], ref[k])


# --- the AV2 reader ----------------------------------------------------------------


def _write_infos(tmp_path, n=2):
    rng = np.random.default_rng(11)
    infos = []
    for i in range(n):
        pts = _points(rng, 3000)
        pts[:20, :2] = 250.0                                  # outside the range
        name = f"lidar_{i}.bin"
        pts.tofile(tmp_path / name)
        m = 10
        boxes = _gt(rng, m, 7)
        boxes[0, :2] = 300.0                                  # outside the range
        names = [jcfg.AV2_CLASS_NAMES[j] for j in rng.integers(0, 26, m)]
        names[1] = "NOT_A_CLASS"
        infos.append(dict(lidar_path=name, gt_boxes=boxes, gt_names=names,
                          log_id=f"log{i}", timestamp_ns=1000 + i,
                          lidar2img=rng.normal(size=(7, 4, 4)).astype(np.float32)))
    path = tmp_path / "infos.pkl"
    with open(path, "wb") as f:
        pickle.dump({"infos": infos}, f)
    return str(path)


@pytest.mark.parametrize("training,augment", [(True, True), (True, False), (False, False)])
def test_av2_reader_matches_jax(tmp_path, training, augment):
    path = _write_infos(tmp_path)
    kw = dict(info_path=path, data_root=str(tmp_path), class_names=tcfg.AV2_CLASS_NAMES,
              training=training, seed=5)
    reader, jreader = tav2.AV2Reader(**kw), jav2.AV2Reader(**kw)
    assert len(reader) == len(jreader) == 2
    for i in range(2):
        got, ref = reader.sample(i, augment), jreader.sample(i, augment)
        assert set(got) == set(ref)
        for k in ref:
            if isinstance(ref[k], np.ndarray):
                _same(got[k], ref[k])
            else:
                assert got[k] == ref[k], k
        assert got["points"].shape[1] == 7                     # 4 + no-aug xyz
        assert len(got["gt_labels"]) == 8          # the class-less and the far box dropped


def test_av2_rows_match_jax():
    rng = np.random.default_rng(12)
    boxes = _gt(rng, 20, 7)
    yaw = boxes[:, 6]
    _same(tav2.yaw_to_quat_wxyz(yaw), jav2.yaw_to_quat_wxyz(yaw))
    scores = rng.random(20).astype(np.float32)
    labels = rng.integers(0, 26, 20)
    args = (boxes, scores, labels, tcfg.AV2_CLASS_NAMES, "log0", 123)
    rows = tav2.boxes_to_av2_rows(*args)
    assert rows == jav2.boxes_to_av2_rows(*args)
    assert rows[0]["category"] == tcfg.AV2_CLASS_NAMES[labels[0]].upper()
    assert set(rows[0]) == set(tav2.LABEL_ATTR) | {"score", "category", "log_id", "timestamp_ns"}


def test_av2_feather_matches_jax(tmp_path):
    pd = pytest.importorskip("pandas")
    pytest.importorskip("pyarrow")
    rng = np.random.default_rng(13)
    rows = tav2.boxes_to_av2_rows(_gt(rng, 6, 7), rng.random(6), rng.integers(0, 26, 6),
                                  tcfg.AV2_CLASS_NAMES, "log1", 7)
    tav2.write_feather(rows, str(tmp_path / "t" / "dets.feather"))
    jav2.write_feather(rows, str(tmp_path / "j" / "dets.feather"))
    got = pd.read_feather(tmp_path / "t" / "dets.feather")
    pd.testing.assert_frame_equal(got, pd.read_feather(tmp_path / "j" / "dets.feather"))
    assert len(got) == 6
