"""The benchmark's frozen copies: the scene and camera generators (checksums
of their seed-0 arrays, pinned when they were copied from the program), the
device painter against the NumPy generator, the traffic's object counts,
and the cost functions on rulebooks counted by hand. And what a run reads,
pinned before the model families moved out of the harness: the tiny
configuration's weights and frames of one seed, and the numbers that the
tiny cells compare."""
import hashlib
import time

import numpy as np
import pytest
import torch

from benchmark.harness import cell as cells, costs, manifest, scenes, traffic
from benchmark.tests import tiny


def digest(arrays) -> str:
    m = hashlib.sha256()
    for k in sorted(arrays):
        a = np.ascontiguousarray(arrays[k])
        m.update(k.encode())
        m.update(str(a.dtype).encode())
        m.update(a.tobytes())
    return m.hexdigest()[:16]


NUSC_SCENE = dict()
AV2_SCENE = dict(n_boxes=48, num_classes=26, point_dim=4, extent=190.0, n_rings=64,
                 pts_per_ring=1600, n_walls=48, sweeps=2)
NUSC_CAMS = dict(batch_size=1, num_cams=6, num_classes=10, img_h=450, img_w=800, max_anno=250,
                 fx=400.0)


@pytest.mark.parametrize("kw,expect", [(NUSC_SCENE, "9d87e702e4abee3a"),
                                       (AV2_SCENE, "2532f0c5486b5b71")])
def test_lidar_scene_checksum(kw, expect):
    assert digest(scenes.make_lidar_scene_arrays(0, **kw)) == expect


def test_camera_checksum():
    sc = scenes.make_lidar_scene_arrays(0)
    cam = scenes.make_camera_arrays(sc["gt_boxes"], sc["gt_labels"], sc["gt_valid"], **NUSC_CAMS)
    assert digest(cam) == "bc72a1d4e1a9027a"


def test_device_painter_matches_generator():
    sc = scenes.make_lidar_scene_arrays(3, n_boxes=40, extent=20.0)
    kw = dict(batch_size=1, num_cams=2, num_classes=10, img_h=90, img_w=160, max_anno=32,
              fx=80.0)
    ref = scenes.make_camera_arrays(sc["gt_boxes"], sc["gt_labels"], sc["gt_valid"], **kw)
    got = scenes.camera_tensors(sc["gt_boxes"], sc["gt_labels"], sc["gt_valid"], "cpu", **kw)
    planes = ref["masks"]
    assert (planes > 0).any()
    assert torch.equal(got["masks"], torch.as_tensor(
        planes.reshape(-1, planes.shape[-1]).astype(np.int32)))
    assert np.array_equal(got["anno"].numpy(), ref["anno"])
    assert np.array_equal(got["lidar2img"].numpy(), ref["lidar2img"])


def test_every_seed_gets_the_same_object_counts():
    t = dict(pool=16, objects=[16, 64])
    a = traffic.object_counts(t, 1)
    b = traffic.object_counts(t, 2**31 + 1234567)
    assert sorted(a) == sorted(b) and a != b
    assert min(a) == 16 and max(a) == 64 and len(a) == 16
    assert traffic.object_counts(t, 5) == traffic.object_counts(t, 5)


def test_gather_conv_cost_hand_counted():
    # 3 source rows of 8 channels, 2 taps over 4 output rows, 16 channels out;
    # a miss points at row 3; hits: tap 0 at outputs 0, 2; tap 1 at all four -> 6
    feats = torch.zeros(3, 8, dtype=torch.bfloat16)
    rows = torch.tensor([[0, 3, 2, 3], [1, 0, 2, 1]], dtype=torch.int32)
    w = torch.zeros(2, 8, 16, dtype=torch.bfloat16)
    hits, flop, byte = costs.gather_conv_cost(feats, rows, w)
    assert hits == 6
    assert flop == 2 * 6 * 8 * 16
    assert byte == 2 * 3 * 8 + 4 * 2 * 4 + 2 * 2 * 8 * 16 + 4 * 4 * 16
    g = torch.zeros(4, 16, dtype=torch.bfloat16)
    hits, flop, byte = costs.dw_per_tap_cost(feats, rows, g)
    assert (hits, flop) == (6, 2 * 6 * 8 * 16)
    assert byte == 2 * 3 * 8 + 4 * 2 * 4 + 2 * 4 * 16 + 4 * 2 * 8 * 16


def test_bound_takes_the_larger_of_operations_and_bytes():
    assert costs.bound_s(989e12, 1.0) == pytest.approx(1.0)
    assert costs.bound_s(1.0, 3.35e12) == pytest.approx(1.0)
    assert costs.bound_s(2 * 989e12, 3.35e12) == pytest.approx(2.0)


# pinned at the tree before benchmark/families/ (the harness's own sides,
# weights and traffic modules), on one CPU thread
PIN_SEED = 2**31 + 11
PINNED_WEIGHTS = "4b30ffbdd3561fdb"
PINNED_FRAMES = "78d8575ce194f4bc"
PINNED_CHECKS = {
    "tiny.stream": {f"moved_share.frame{i}": {"value": 0.0, "limit": 0.02} for i in range(3)},
    "tiny.train": {"grad_leaf_gap": {"value": 0.0, "limit": 0.1},
                   "change_leaf_gap": {"value": 0.0, "limit": 0.4},
                   "grad_diff_gap": {"value": 0.0, "limit": 0.2},
                   "seg_loss_gap": {"value": 0.0, "limit": 0.0005}},
}
PINNED_LOSSES = [25.210481643676758, 28.979591369628906, 32.578521728515625]


def named_digest(named) -> str:
    m = hashlib.sha256()
    for k, t in named:
        a = torch.as_tensor(t).contiguous()
        m.update(k.encode())
        m.update(str(a.dtype).encode())
        m.update(str(tuple(a.shape)).encode())
        m.update(a.numpy().tobytes())
    return m.hexdigest()[:16]


def test_tiny_weights_and_frames_are_pinned():
    cfg = tiny.tiny_config()
    fam = manifest.family(cfg)
    assert named_digest(sorted(fam.make_state(cfg, PIN_SEED, "cpu").items())) == PINNED_WEIGHTS
    pool = traffic.make_pool(fam, cfg, dict(pool=3, objects=[3, 5], points_on="host"), PIN_SEED,
                             "cpu")
    named = []
    for f in pool:
        named += [(f"{f.index}.{k}", getattr(f, k)) for k in ("points", "batch_idx", "valid")]
        named += [(f"{f.index}.gt.{k}", v) for k, v in sorted(f.gt.items())]
        named += [(f"{f.index}.cam.{k}", f.cam[k]) for k in ("masks", "anno", "lidar2img")]
    assert [f.objects for f in pool] == [3, 5, 4]
    assert named_digest(named) == PINNED_FRAMES


@pytest.mark.parametrize("cell", sorted(PINNED_CHECKS))
def test_tiny_checks_are_pinned(tmp_path, cell):
    root = tiny.make_checkout(str(tmp_path))
    # a window long enough that every frame of the pool is served, and so judged
    res, readings = cells.measure(root, cell, PIN_SEED, 3.0, False, "cpu", time.perf_counter(),
                                  root + "/benchmark")
    assert res["attempted"] >= 3
    assert res["checks"] == PINNED_CHECKS[cell]
    if cell == "tiny.train":
        assert readings["detail"]["losses"] == [PINNED_LOSSES, PINNED_LOSSES]
