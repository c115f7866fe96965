"""The port's AV2 preparation (``cli/prepare_av2.py``, reading the logs with
``data/feather.py``) against the JAX package's ``tools/prepare_av2.py``
(pandas), on tiny AV2-shaped logs that pyarrow wrote with LZ4 (the sweeps
in AV2's schema: float16 ``x, y, z``, uint8 ``intensity``): the info
pickles equal (arrays bitwise, names, relative paths) and the ``.bin``
files byte-equal; a log without annotations gives no frames; a pose file
without ``timestamp_ns`` raises in both. The prepared frames are then read
by both packages' ``AV2Reader`` (equal samples). ``AV2Reader.format_results``
writes, without pandas, the frame that the JAX reader's writes."""
import filecmp
import os
import pickle
import sys

import numpy as np
import pyarrow as pa
import pyarrow.feather as pf
import pandas as pd
import pytest

from fullysparsefusion_tpu.config import AV2_CLASS_NAMES
from fullysparsefusion_tpu.data import av2 as jav2
from fullysparsefusion_tpu_torch.cli import prepare_av2 as T
from fullysparsefusion_tpu_torch.data import av2 as tav2
from fullysparsefusion_tpu_torch.data.feather import read_feather
from test_torch_data_nuscenes import assert_same, jax_tools
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.filterwarnings("ignore::FutureWarning")
CATEGORIES = ("REGULAR_VEHICLE", "PEDESTRIAN", "BICYCLIST", "BOX_TRUCK", "WHEELED_DEVICE")


def write_log(root, log_id, seed, stamps=(315969904359876000, 315969904459876000,
                                          315969904559876000), points=(300, 41, 257),
              annotated=True, pose_ts=True):
    rng = np.random.default_rng(seed)
    d = os.path.join(root, log_id)
    os.makedirs(os.path.join(d, "sensors", "lidar"))
    for ts, n in zip(stamps, points):
        pf.write_feather(pa.table({
            "x": (rng.normal(size=n) * 30).astype(np.float16),
            "y": (rng.normal(size=n) * 30).astype(np.float16),
            "z": rng.normal(size=n).astype(np.float16),
            "intensity": rng.integers(0, 256, n).astype(np.uint8),
            "laser_number": rng.integers(0, 64, n).astype(np.uint8),
            "offset_ns": rng.integers(0, 10**8, n).astype(np.int32)}),
            os.path.join(d, "sensors", "lidar", f"{ts}.feather"), compression="lz4")
    if annotated:
        # boxes on the first and last sweep only, interleaved in file order
        ts_col = np.array([stamps[0], stamps[2]] * 4 + [stamps[0]], np.int64)
        n = len(ts_col)
        q = rng.normal(size=(n, 4)).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        f32 = lambda s: (rng.random(n) * s + 0.5).astype(np.float32)  # noqa: E731
        pf.write_feather(pa.table({
            "timestamp_ns": ts_col, "track_uuid": [f"u{i}" for i in range(n)],
            "category": [CATEGORIES[i % len(CATEGORIES)] for i in range(n)],
            "length_m": f32(5), "width_m": f32(2), "height_m": f32(2),
            "qw": q[:, 0], "qx": q[:, 1], "qy": q[:, 2], "qz": q[:, 3],
            "tx_m": f32(40) - 20, "ty_m": f32(40) - 20, "tz_m": f32(2) - 1,
            "num_interior_pts": rng.integers(0, 500, n)}),
            os.path.join(d, "annotations.feather"), compression="lz4")
    pose = {"qw": np.ones(3), "qx": np.zeros(3), "qy": np.zeros(3), "qz": np.zeros(3),
            "tx_m": rng.normal(size=3), "ty_m": rng.normal(size=3), "tz_m": rng.normal(size=3)}
    if pose_ts:
        pose = {"timestamp_ns": np.array(stamps, np.int64), **pose}
    pf.write_feather(pa.table(pose), os.path.join(d, "city_SE3_egovehicle.feather"),
                     compression="lz4")
    return d


def test_process_log_and_main_match_the_jax_tool(tmp_path):
    root = str(tmp_path / "sensor")
    write_log(root, "log_b", 0)
    write_log(root, "log_a", 1, stamps=(1000, 2000, 3000))
    write_log(root, "log_c", 2, annotated=False)
    outs = {}
    for who in ("jax", "port"):
        out = str(tmp_path / who)
        argv = ["--av2-root", root, "--out", os.path.join(out, "infos.pkl"),
                "--points-out", os.path.join(out, "points")]
        if who == "jax":
            with jax_tools(), pytest.MonkeyPatch.context() as mp:
                from prepare_av2 import main

                mp.setattr(sys, "argv", ["prepare_av2.py"] + argv)
                main()
        else:
            T.main(argv)
        with open(os.path.join(out, "infos.pkl"), "rb") as f:
            outs[who] = pickle.load(f)
    assert_same(outs["port"], outs["jax"])
    infos = outs["port"]["infos"]
    assert len(infos) == 6 and [len(i["gt_names"]) for i in infos] == [5, 0, 4] * 2
    assert infos[0]["gt_names"][:2] == ["Regular_Vehicle", "Bicyclist"]
    for info in infos:
        assert filecmp.cmp(os.path.join(tmp_path, "jax", info["lidar_path"]),
                           os.path.join(tmp_path, "port", info["lidar_path"]), shallow=False)
    # the float16 -> float32 points and intensity / 255 (in float64), bitwise
    sweep = pf.read_table(os.path.join(root, "log_a", "sensors", "lidar", "1000.feather"))
    pts = np.fromfile(os.path.join(tmp_path, "port", infos[0]["lidar_path"]), np.float32)
    want = np.stack([sweep["x"].to_numpy(), sweep["y"].to_numpy(), sweep["z"].to_numpy(),
                     sweep["intensity"].to_numpy() / 255.0], 1).astype(np.float32)
    np.testing.assert_array_equal(pts.reshape(-1, 4), want)

    readers = [m.AV2Reader(os.path.join(tmp_path, who, "infos.pkl"), str(tmp_path / who),
                           AV2_CLASS_NAMES, training=False)
               for m, who in ((jav2, "jax"), (tav2, "port"))]
    for i in (0, 3):
        assert_same(readers[1].sample(i), readers[0].sample(i))


def test_pose_without_timestamps_raises_in_both(tmp_path):
    d = write_log(str(tmp_path), "log", 3, pose_ts=False)
    with pytest.raises(KeyError):
        T.process_log(d, str(tmp_path / "p"), AV2_CLASS_NAMES)
    with jax_tools():
        from prepare_av2 import process_log

        with pytest.raises(KeyError):
            process_log(d, str(tmp_path / "q"), AV2_CLASS_NAMES)
    assert T.process_log(str(tmp_path / "absent"), str(tmp_path / "p"), AV2_CLASS_NAMES) == []


def test_av2_format_results_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    classes = ("REGULAR_VEHICLE", "PEDESTRIAN", "BUS")
    dets = [(rng.normal(size=(n, 7)).astype(np.float32), rng.random(n).astype(np.float32),
             rng.integers(0, 3, n), f"log{k}", 315969629019741000 + k)
            for k, n in enumerate((5, 0, 3))]
    paths = []
    for mod in (jav2, tav2):
        reader = mod.AV2Reader.__new__(mod.AV2Reader)
        reader.class_names = classes
        paths.append(reader.format_results(dets, str(tmp_path / f"{mod.__name__}.feather")))
    pd.testing.assert_frame_equal(pd.read_feather(paths[1]), pd.read_feather(paths[0]))
    assert_same(read_feather(paths[1]), read_feather(paths[0]))
    assert len(read_feather(paths[1])["score"]) == 8
