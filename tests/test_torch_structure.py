"""The PyTorch port against the JAX package: import boundary, config surface
and the synthetic scene generators."""
import ast
import dataclasses
import os
import sys

import numpy as np
import pytest

from fixtures import make_camera_data, make_lidar_scene, make_scene, with_noaug_channels
from fullysparsefusion_tpu import config as jcfg
from fullysparsefusion_tpu.data.masks import pack_mask_scores as j_pack_mask_scores
from fullysparsefusion_tpu_torch import config as tcfg
from fullysparsefusion_tpu_torch import synthetic as S
from fullysparsefusion_tpu_torch.models.camera import CameraData
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "fullysparsefusion_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "fullysparsefusion_tpu")
# host libraries that the card's machine lacks: the port has its own codecs
FORBIDDEN_HOST = ("PIL", "pandas", "pyarrow", "cv2")


def _port_sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    sources = _port_sources()
    assert len(sources) > 20
    bad = [(os.path.relpath(p, REPO), m) for p in sources for m in _imported_modules(p)
           if m.split(".")[0] in FORBIDDEN]
    assert bad == []


def test_port_imports_no_host_image_or_table_library():
    """Not even inside a function: the JPEG, PNG and Feather codecs are the
    port's own (``data/jpeg.py``, ``data/png.py``, ``data/feather.py``)."""
    bad = [(os.path.relpath(p, REPO), m) for p in _port_sources() for m in _imported_modules(p)
           if m.split(".")[0] in FORBIDDEN_HOST]
    assert bad == []


def test_av2_format_results_runs_without_pandas(tmp_path, monkeypatch):
    from fullysparsefusion_tpu_torch.data import av2
    from fullysparsefusion_tpu_torch.data.feather import read_feather

    for name in FORBIDDEN_HOST:  # an import of any of them now raises ImportError
        monkeypatch.setitem(sys.modules, name, None)
    reader = av2.AV2Reader.__new__(av2.AV2Reader)
    reader.class_names = ("REGULAR_VEHICLE", "BUS")
    boxes = np.arange(14, dtype=np.float32).reshape(2, 7)
    path = reader.format_results([(boxes, np.array([0.5, 0.25], np.float32), np.array([1, 0]),
                                   "log", 7)], str(tmp_path / "out.feather"))
    cols = read_feather(path)
    assert cols["category"].tolist() == ["BUS", "REGULAR_VEHICLE"]
    np.testing.assert_array_equal(cols["tz_m"], [2 + 5 / 2, 9 + 12 / 2])
    assert cols["timestamp_ns"].tolist() == [7, 7]


@pytest.mark.parametrize("name", ["nusc_fsf_config", "tiny_fsf_config", "tiny_fsd_config"])
def test_config_matches_jax_field_by_field(name):
    assert dataclasses.asdict(getattr(tcfg, name)()) == dataclasses.asdict(getattr(jcfg, name)())


def test_bench_config_overrides_match_jax():
    caps = dict(points=131072, voxels=57344, prevox=65536, fg_per_group=4096)
    stage = (57344, 40960, 24576, 8192, 2560)
    t, j = [m.FSFConfig(fsd=m.FSDConfig(caps=m.Capacities(**caps),
                                        segmentor=m.VoteSegmentorConfig(unet_stage_capacities=stage)))
            for m in (tcfg, jcfg)]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def _assert_same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 3])
def test_make_scene_and_camera_data_identical(seed):
    pb, gt = make_scene(seed=seed)
    cam = make_camera_data(pb, gt)
    sc = S.make_scene_arrays(seed=seed)
    for k, v in (("points", pb.points), ("batch_idx", pb.batch_idx), ("valid", pb.valid),
                 ("gt_boxes", gt.boxes), ("gt_labels", gt.labels), ("gt_valid", gt.valid)):
        _assert_same(sc[k], v)
    ca = S.make_camera_arrays(sc["gt_boxes"], sc["gt_labels"], sc["gt_valid"])
    assert (int(ca["masks"].shape[2]), int(ca["masks"].shape[3])) == (cam.img_h, cam.img_w)
    _assert_same(ca["masks"].reshape(-1, ca["masks"].shape[-1]), cam.masks)
    _assert_same(ca["anno"], cam.anno)
    _assert_same(ca["lidar2img"], cam.lidar2img)
    assert (np.asarray(cam.masks) > 0).any()
    tcam = S.to_camera_data(ca, device="cpu")
    np.testing.assert_array_equal(tcam.masks.numpy(), np.asarray(cam.masks).astype(np.int32))
    assert (tcam.img_h, tcam.img_w) == (cam.img_h, cam.img_w)


def test_with_noaug_channels_identical():
    pb, _ = make_scene(seed=1)
    sc = S.make_scene_arrays(seed=1)
    _assert_same(S.with_noaug_channels_array(sc["points"]), with_noaug_channels(pb).points)


def test_make_lidar_scene_identical_small():
    pb, gt = make_lidar_scene(seed=2, n_cap=16384, n_rings=8, pts_per_ring=400, n_walls=4,
                              sweeps=2, n_boxes=5)
    sc = S.make_lidar_scene_arrays(seed=2, n_cap=16384, n_rings=8, pts_per_ring=400,
                                   n_walls=4, sweeps=2, n_boxes=5)
    for k, v in (("points", pb.points), ("batch_idx", pb.batch_idx), ("valid", pb.valid),
                 ("gt_boxes", gt.boxes), ("gt_labels", gt.labels), ("gt_valid", gt.valid)):
        _assert_same(sc[k], v)


def test_pack_mask_scores_identical():
    rng = np.random.default_rng(5)
    masks = rng.integers(0, 6, (2, 3, 8, 8, 4)).astype(np.uint8)
    anno = rng.random((2, 5, 9)).astype(np.float32)
    _assert_same(S.pack_mask_scores(masks, anno), j_pack_mask_scores(masks, anno))
    _assert_same(S.pack_mask_scores(masks[0], anno[0]), j_pack_mask_scores(masks[0], anno[0]))


def test_camera_data_requires_image_size():
    with pytest.raises(TypeError, match="img_h"):
        CameraData(masks=None, anno=None, lidar2img=None)
