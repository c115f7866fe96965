"""Detection evaluation in the PyTorch port against the JAX package's: the
port's copy of ``eval/detection.py`` gives equal metric dicts on the same
records (random pools at several seeds, a frame with no detections, a
class with no GT, score ties, the hand-built scenes of
``tests/test_eval_golden.py``); ``parallel/eval.py``'s sharding and shard
files agree with the JAX package's both ways; ``records_from_bboxes``
matches ``tools/train_to_map.py``'s on a hand-built ``get_bboxes`` result.
"""
import importlib.util
import math
import os

import numpy as np
import pytest
import torch

from fullysparsefusion_tpu.eval import detection as jdet
from fullysparsefusion_tpu.parallel import eval as jeval
from fullysparsefusion_tpu.utils.containers import GroundTruth as JGroundTruth
from fullysparsefusion_tpu_torch.eval import detection as tdet
from fullysparsefusion_tpu_torch.eval.records import records_from_bboxes
from fullysparsefusion_tpu_torch.ops.nms import NMSResult
from fullysparsefusion_tpu_torch.parallel import eval as teval
from fullysparsefusion_tpu_torch.utils.containers import GroundTruth
from test_eval_golden import NUSC_CLASSES, _box
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _random_records(seed, n_frames=5, num_classes=4, attrs=False):
    rng = np.random.default_rng(seed)
    recs = []
    for _ in range(n_frames):
        n_gt, n_det = rng.integers(0, 7), rng.integers(0, 10)
        gt = np.stack([_box(*rng.uniform(-45, 45, 2), yaw=rng.uniform(-3, 3),
                            vx=rng.normal(), vy=rng.normal()) for _ in range(n_gt)]
                      ) if n_gt else np.zeros((0, 9), np.float32)
        gl = rng.integers(0, num_classes, n_gt)
        # detections near some GT (true positives at several distances) and clutter
        near = gt[rng.integers(0, n_gt, n_det)] if n_gt else np.zeros((n_det, 9), np.float32)
        det = near + rng.normal(0, 0.8, (n_det, 9)).astype(np.float32) * [1, 1, .1, .1, .1,
                                                                          .1, .3, .5, .5]
        # mostly the matched GT's class, some at random
        dl = rng.integers(0, num_classes, n_det)
        if n_gt:
            dl = np.where(rng.random(n_det) < 0.8, gl[rng.integers(0, n_gt, n_det)], dl)
        # scores on a coarse grid: ties within and across frames
        sc = np.round(rng.random(n_det) * 8) / 8
        extra = {}
        if attrs:
            extra = dict(attrs=rng.integers(-1, 8, n_det), gt_attrs=rng.integers(-1, 8, n_gt))
        recs.append(dict(boxes=det.astype(np.float32), scores=sc.astype(np.float32),
                         labels=dl.astype(np.int32), gt_boxes=gt.astype(np.float32),
                         gt_labels=gl.astype(np.int32), **extra))
    return recs


def _golden_records():
    car, ped, bar = (NUSC_CLASSES.index(c) for c in ("car", "pedestrian", "barrier"))
    kw = dict(dx=0.6, dy=0.6, dz=1.7, yaw=0.5)
    return [
        dict(boxes=np.stack([_box(0.2, 0), _box(10, 0.4)]), scores=np.asarray([0.9, 0.8]),
             labels=np.asarray([car, car]), gt_boxes=np.stack([_box(0, 0), _box(10, 0)]),
             gt_labels=np.asarray([car, car])),
        dict(boxes=np.stack([_box(0.3, 0, **kw), _box(50, 0, **kw), _box(5, 1.2, **kw),
                             _box(20, 0, **kw), _box(38, 0.6, **kw)]),
             scores=np.asarray([0.95, 0.85, 0.80, 0.70, 0.60]), labels=np.full(5, ped),
             gt_boxes=np.stack([_box(0, 0, **kw), _box(5, 0, **kw), _box(38, 0, **kw),
                                _box(45, 0, **kw)]), gt_labels=np.full(4, ped)),
        dict(boxes=_box(0.1, 0, dx=0.5, dy=2.0, dz=0.5, yaw=np.pi - 0.3, n=7)[None],
             scores=np.asarray([0.9]), labels=np.asarray([bar]),
             gt_boxes=_box(0, 0, dx=0.5, dy=2.0, dz=1.0, yaw=0.0, n=7)[None],
             gt_labels=np.asarray([bar])),
        dict(boxes=np.stack([_box(0.1, 0), _box(10, 0.1)]), scores=np.asarray([0.9, 0.8]),
             labels=np.asarray([car, car]), gt_boxes=np.stack([_box(0, 0), _box(10, 0)]),
             gt_labels=np.asarray([car, car]),
             attrs=np.asarray([jdet.ATTR_ID["vehicle.moving"], jdet.ATTR_ID["vehicle.parked"]]),
             gt_attrs=np.asarray([jdet.ATTR_ID["vehicle.moving"],
                                  jdet.ATTR_ID["vehicle.stopped"]])),
    ]


def _no_detections():
    r = _random_records(11, n_frames=3)
    r[1] = dict(r[1], boxes=np.zeros((0, 9), np.float32), scores=np.zeros(0, np.float32),
                labels=np.zeros(0, np.int32))
    return r


def _class_without_gt():
    r = _random_records(12, n_frames=4, num_classes=3)
    # labels 0..2 only in GT; detections of class 3 have no GT anywhere
    r[0] = dict(r[0], labels=np.full_like(r[0]["labels"], 3))
    return r


CASES = {
    **{f"random_seed{s}": (lambda s=s: _random_records(s)) for s in (0, 1, 2, 3)},
    "random_with_attributes": lambda: _random_records(4, attrs=True),
    "a_frame_without_detections": _no_detections,
    "a_class_without_gt": _class_without_gt,
    "score_ties": lambda: [dict(r, scores=np.full_like(r["scores"], 0.5))
                           for r in _random_records(5)],
    "golden": _golden_records,
}


def _equal(a, b, path="metrics"):
    assert type(a) is type(b) or (np.isscalar(a) and np.isscalar(b)), path
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple, np.ndarray)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)
    elif isinstance(a, float) and math.isnan(a):
        assert math.isnan(b), path
    else:
        assert a == b, path


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("names", ["nuscenes", "numbered"])
def test_evaluate_detections_equals_the_jax_copy(case, names):
    recs = CASES[case]()
    n = 10 if case == "golden" else 4
    class_names = NUSC_CLASSES[:n] if names == "nuscenes" else None
    got = tdet.evaluate_detections([tdet.DetectionRecord(**r) for r in recs], n, class_names)
    ref = jdet.evaluate_detections([jdet.DetectionRecord(**r) for r in recs], n, class_names)
    _equal(got, ref)
    assert "mAP" in got


def test_default_attributes_equal_the_jax_copy():
    rng = np.random.default_rng(3)
    boxes = rng.normal(size=(40, 9)).astype(np.float32)
    labels = rng.integers(-1, 11, 40)
    np.testing.assert_array_equal(tdet.default_attributes(boxes, labels, NUSC_CLASSES),
                                  jdet.default_attributes(boxes, labels, NUSC_CLASSES))


@pytest.mark.parametrize("n,world", [(0, 2), (7, 1), (7, 3), (12, 4)])
def test_shard_indices_partition_the_dataset_as_the_jax_copy(n, world):
    shards = [teval.shard_indices(n, r, world) for r in range(world)]
    for r, s in enumerate(shards):
        np.testing.assert_array_equal(s, jeval.shard_indices(n, r, world))
    np.testing.assert_array_equal(np.sort(np.concatenate(shards)), np.arange(n))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_shard_files_merge_the_same_in_both_packages(tmp_path, writer):
    n, world = 11, 3
    results = [{"idx": i, "score": i / 10} for i in range(n)]
    write = teval.write_shard_results if writer == "port" else jeval.write_shard_results
    for r in range(world):
        write([results[i] for i in teval.shard_indices(n, r, world)], str(tmp_path), r)
    assert sorted(os.listdir(tmp_path)) == [f"results_rank{r:03d}.json" for r in range(world)]
    assert teval.merge_shard_results(str(tmp_path)) == results
    assert jeval.merge_shard_results(str(tmp_path)) == results


def test_allgather_results_is_the_list_itself_without_a_group():
    local = [{"idx": 3}]
    assert teval.allgather_results(local) is local


def _tool_records_from_bboxes():
    spec = importlib.util.spec_from_file_location(
        "train_to_map", os.path.join(REPO, "tools", "train_to_map.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.records_from_bboxes


def test_records_from_bboxes_match_the_jax_tool():
    rng = np.random.default_rng(9)
    b, k, m = 2, 6, 5
    res = dict(boxes=rng.normal(size=(b, k, 9)).astype(np.float32),
               scores=rng.random((b, k)).astype(np.float32),
               labels=rng.integers(0, 3, (b, k)).astype(np.int32),
               valid=rng.random((b, k)) > 0.4)
    res["valid"][1] = False                   # a sample without detections
    gt = dict(boxes=rng.normal(size=(b, m, 10)).astype(np.float32),
              labels=rng.integers(0, 3, (b, m)).astype(np.int32),
              valid=rng.random((b, m)) > 0.3)
    got = records_from_bboxes(NMSResult(**{k: torch.from_numpy(v) for k, v in res.items()}),
                              GroundTruth(**{k: torch.from_numpy(v) for k, v in gt.items()}), b)
    ref = _tool_records_from_bboxes()(NMSResult(**res), JGroundTruth(**gt), b)
    assert len(got) == len(ref) == b
    for g, r in zip(got, ref):
        for f in ("boxes", "scores", "labels", "gt_boxes", "gt_labels"):
            a, e = getattr(g, f), getattr(r, f)
            assert a.dtype == e.dtype and a.shape == e.shape, f
            np.testing.assert_array_equal(a, e, err_msg=f)
    assert got[1].boxes.shape == (0, 9) and got[0].gt_boxes.shape[1] == 9
