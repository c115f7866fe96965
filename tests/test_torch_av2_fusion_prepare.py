"""``cli/prepare_av2.py --fusion`` against the JAX package's
``tools/prepare_av2.py`` functions, on tiny synthesised AV2 logs
(``cli/make_fake_av2.py``: a seven-camera ring rig modelled on AV2's, an ego
at 10 m/s turning at 0.3 rad/s, cameras at 20 Hz off the 10 Hz sweeps),
whose feathers pyarrow reads back. Tolerances:

* every frame's ``lidar2img[c]``: bitwise the JAX module's
  ``build_lidar2img(se3(quat_to_rot(q), t), ...)`` with its
  ``quat_to_rot`` and ``se3``, on the rows pyarrow reads;
* the chosen image timestamps: equal to a brute-force nearest (a tie to
  the earlier image);
* everything else in the info: equal to the plain preparation's (the JAX
  tool's), but for the names, which are capitalized: all 26 upper-case
  AV2 categories land in ``AV2_CLASS_NAMES`` and ``AV2Reader`` keeps every
  GT box (the plain preparation keeps 12 of 26);
* a missing pose row, calibration row or camera directory raises, naming
  it.

``tests/test_torch_av2_fusion_masks.py`` holds the projection against the
rig's own geometry and the masks.
"""
import os

import numpy as np
import pyarrow as pa
import pytest

from fullysparsefusion_tpu_torch.cli import make_fake_av2 as F
from fullysparsefusion_tpu_torch.cli import prepare_av2 as P
from fullysparsefusion_tpu_torch.config import AV2_CLASS_NAMES
from fullysparsefusion_tpu_torch.data.av2 import AV2Reader
from fullysparsefusion_tpu_torch.data.feather import write_feather
from test_torch_data_nuscenes import assert_same, jax_tools
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)


def prepare(root, fusion=True, out="out"):
    argv = ["--av2-root", os.path.join(root, "sensor"), "--out",
            os.path.join(root, out, "infos.pkl"), "--points-out", os.path.join(root, out, "points")]
    return P.main(argv + (["--fusion"] if fusion else []))


def _columns(path):
    """A feather's columns as pyarrow reads them."""
    return pa.ipc.open_file(path).read_all().to_pydict()


def _rows(path, key):
    cols = _columns(path)
    return {k: {c: cols[c][i] for c in cols} for i, k in enumerate(cols[key])}


def test_fusion_matrices_are_the_jax_chain_on_the_feather_rows(tmp_path):
    root = str(tmp_path)
    for i, log in enumerate(("log_b", "log_a")):
        F.write_log(os.path.join(root, "sensor"), log, F.synthetic_frames(3, seed=10 * i),
                    F.RingRig())
    infos, plain = prepare(root), prepare(root, fusion=False, out="plain")
    assert [i["log_id"] for i in infos] == ["log_a"] * 3 + ["log_b"] * 3
    with jax_tools():
        import prepare_av2 as J

    def se3_row(row):
        q = np.array([row[k] for k in ("qw", "qx", "qy", "qz")], np.float64)
        t = np.array([row[k] for k in ("tx_m", "ty_m", "tz_m")], np.float64)
        return J.se3(J.quat_to_rot(q), t)

    for info, base in zip(infos, plain):
        log_dir = os.path.join(root, "sensor", info["log_id"])
        ext = _rows(os.path.join(log_dir, "calibration", "egovehicle_SE3_sensor.feather"),
                    "sensor_name")
        intr = _rows(os.path.join(log_dir, "calibration", "intrinsics.feather"), "sensor_name")
        poses = _rows(os.path.join(log_dir, "city_SE3_egovehicle.feather"), "timestamp_ns")
        ts = info["timestamp_ns"]
        assert info["cam_names"] == list(P.RING_CAMERAS) and list(info["cams"]) == list(P.RING_CAMERAS)
        assert info["lidar2img"].dtype == np.float64 and info["lidar2img"].shape == (7, 4, 4)
        for c, cam in enumerate(P.RING_CAMERAS):
            entry = info["cams"][cam]
            stamps = sorted(int(f[:-4]) for f in os.listdir(
                os.path.join(log_dir, "sensors", "cameras", cam)))
            assert entry["timestamp_ns"] == min(stamps, key=lambda t: (abs(t - ts), t))
            assert os.path.isfile(os.path.join(root, "sensor", entry["data_path"]))
            assert (entry["height_px"], entry["width_px"]) == (intr[cam]["height_px"],
                                                               intr[cam]["width_px"])
            k = np.array([[intr[cam]["fx_px"], 0.0, intr[cam]["cx_px"]],
                          [0.0, intr[cam]["fy_px"], intr[cam]["cy_px"]], [0.0, 0.0, 1.0]],
                         np.float64)
            want = J.build_lidar2img(se3_row(poses[ts]), se3_row(poses[entry["timestamp_ns"]]),
                                     np.linalg.inv(se3_row(ext[cam])), k)
            np.testing.assert_array_equal(info["lidar2img"][c], want, err_msg=f"{ts} {cam}")
        # a 25 ms offset at 20 Hz ties two images: the earlier one is taken
        assert info["cams"]["ring_front_left"]["timestamp_ns"] == ts - 25_000_000
        rest = {k: v for k, v in info.items() if k not in ("lidar2img", "cam_names", "cams")}
        assert_same(dict(rest, gt_names=[n.title() for n in rest["gt_names"]]), base)
        assert all(n in AV2_CLASS_NAMES for n in info["gt_names"])


def test_fusion_names_cover_the_config_and_the_reader_keeps_every_box(tmp_path):
    root = str(tmp_path)
    rng = np.random.default_rng(3)
    n = len(AV2_CLASS_NAMES)
    boxes = np.zeros((n, 7), np.float32)
    boxes[:, 0] = np.arange(n) * 3.0 - 40
    boxes[:, 1] = rng.uniform(-20, 20, n)
    boxes[:, 2] = -1.5
    boxes[:, 3:6] = (2.0, 1.5, 1.5)
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, n)
    points = np.concatenate([rng.uniform(-40, 40, (500, 3)), rng.random((500, 1))], 1)
    frame = dict(points=points.astype(np.float32), gt_boxes=boxes, gt_labels=np.arange(n))
    F.write_log(os.path.join(root, "sensor"), "log", [frame], F.TINY_RIG)
    cats = _columns(os.path.join(root, "sensor", "log", "annotations.feather"))["category"]
    assert cats == [c.upper() for c in AV2_CLASS_NAMES]
    kept = {}
    for fusion in (True, False):
        infos = prepare(root, fusion, out=f"out{fusion}")
        if fusion:
            assert infos[0]["gt_names"] == list(AV2_CLASS_NAMES)
        reader = AV2Reader(os.path.join(root, f"out{fusion}", "infos.pkl"),
                           os.path.join(root, f"out{fusion}"), AV2_CLASS_NAMES, training=False)
        kept[fusion] = reader.sample(0)["gt_labels"].tolist()
    assert kept[True] == list(range(n))
    assert len(kept[False]) == 12          # title() misses the 14 multi-word names


@pytest.mark.parametrize("missing", ["pose_row", "calibration_row", "camera_dir"])
def test_fusion_missing_input_raises_naming_it(tmp_path, missing):
    root = str(tmp_path)
    made = F.write_log(os.path.join(root, "sensor"), "log", F.synthetic_frames(2), F.TINY_RIG)
    log_dir = made["log_dir"]
    if missing == "pose_row":
        ts = P.nearest_stamp(made["camera_stamps"][6], made["sweeps"][1])
        path = os.path.join(log_dir, "city_SE3_egovehicle.feather")
        cols = _columns(path)
        keep = [i for i, t in enumerate(cols["timestamp_ns"]) if t != ts]
        assert len(keep) == len(cols["timestamp_ns"]) - 1
        write_feather({k: np.array(v)[keep] for k, v in cols.items()}, path)
        err, name = KeyError, str(ts)
    elif missing == "calibration_row":
        path = os.path.join(log_dir, "calibration", "intrinsics.feather")
        cols = _columns(path)
        keep = [i for i, s in enumerate(cols["sensor_name"]) if s != "ring_rear_left"]
        write_feather({k: np.array(v, object if k == "sensor_name" else None)[keep]
                       for k, v in cols.items()}, path)
        err, name = KeyError, "ring_rear_left"
    else:
        cam_dir = os.path.join(log_dir, "sensors", "cameras", "ring_side_right")
        for f in os.listdir(cam_dir):
            os.remove(os.path.join(cam_dir, f))
        os.rmdir(cam_dir)
        err, name = FileNotFoundError, "ring_side_right"
    with pytest.raises(err, match=name):
        prepare(root)
    assert len(prepare(root, fusion=False)) == 2    # the plain preparation reads none of it
