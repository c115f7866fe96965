"""The AV2 camera inputs from a ``prepare_av2 --fusion`` tree, on a tiny
synthesised log (``cli/make_fake_av2.py``: a box in front of each of the
seven ring cameras, the masks painted from the rig's own geometry).
Tolerances:

* ``cli/common.load_av2_masks``' packed planes and anno: bitwise the JAX
  package's ``load_sample_masks_single_channel`` (+ ``pack_mask_scores``) on
  the same PNGs, at downsample 1 and 2;
* its ``lidar2img``: the frame's f32 matrices with the front camera's rows 0
  and 1 times ``w / front_w`` and ``h / front_h``, then rows 0–1 over the
  downsample, to 1 f32 ulp (``rtol`` 2^-23);
* a point that projects to native front-camera pixel ``(u, v)`` lands,
  through the scaled matrix and the port's lookup arithmetic, on the grid
  cell ``(i, j)`` whose source span under the loader's nearest index map
  (cell ``j`` of ``W / d`` reads the source from ``j · d · front_w / W``
  on) holds ``(u, v)`` (a point within 1e-4 px of a span's edge may take
  either cell), and ``points_in_mask_compact`` reads that cell;
* ``ops/voxelize.voxel_coords`` on float16 coordinates (AV2's sweeps put
  points exactly on voxel edges): bitwise the JAX package's jitted
  ``voxel_coords`` at AV2's voxel sizes, where a plain f32 division would
  floor some of them into the next voxel;
* a point at a known city position projects, through the written matrix,
  within 0.5 px of where the rig's own geometry (the camera's pose in the
  city at the image's timestamp) puts it; the uncompensated chain (the
  camera's pose taken at the sweep's timestamp) misses it by more than
  20 px at 10 m/s and 50 ms.
"""
import os

import jax
import numpy as np
import pytest
import torch

from fullysparsefusion_tpu.data import masks as jmasks
from fullysparsefusion_tpu.ops import voxelize as jvox
from fullysparsefusion_tpu_torch.cli import make_fake_av2 as F
from fullysparsefusion_tpu_torch.cli import prepare_av2 as P
from fullysparsefusion_tpu_torch.cli.common import load_av2_masks
from fullysparsefusion_tpu_torch.config import AV2_CLASS_NAMES, av2_fsf_config
from fullysparsefusion_tpu_torch.data.av2 import AV2Reader
from fullysparsefusion_tpu_torch.ops import voxelize as tvox
from fullysparsefusion_tpu_torch.ops.projection import points_in_mask_compact
from test_torch_data_nuscenes import assert_same
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)

NUM_CLASSES = len(AV2_CLASS_NAMES)


def ring_frame(rig, seed, dist=7.0, per_box=150):
    """A box ``dist`` m out from the ring centre in each camera's direction
    (labels 0, 3, 6, ...) with ``per_box`` interior points, and background."""
    rng = np.random.default_rng(seed)
    boxes, pts = [], []
    for c in range(len(P.RING_CAMERAS)):
        y = rig.yaw(c)
        b = np.array([F.RING_CENTRE[0] + dist * np.cos(y), dist * np.sin(y), -1.0, 2.0, 1.6, 1.5,
                      rng.uniform(-np.pi, np.pi)])
        local = rng.uniform(-0.5, 0.5, (per_box, 3)) * b[3:6]
        cs, sn = np.cos(b[6]), np.sin(b[6])
        pts.append(np.stack([local[:, 0] * cs - local[:, 1] * sn + b[0],
                             local[:, 0] * sn + local[:, 1] * cs + b[1],
                             local[:, 2] + b[2] + b[5] / 2, rng.random(per_box)], 1))
        boxes.append(b)
    pts.append(np.concatenate([rng.uniform(-12, 12, (300, 2)), rng.uniform(-2, 2, (300, 1)),
                               rng.random((300, 1))], 1))
    return dict(points=np.concatenate(pts).astype(np.float32),
                gt_boxes=np.stack(boxes).astype(np.float32),
                gt_labels=np.arange(len(boxes)) * 3)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("av2"))
    F.write_log(os.path.join(root, "sensor"), "log", [ring_frame(F.TINY_RIG, s) for s in (0, 1)],
                F.TINY_RIG, mask_dir=os.path.join(root, "masks"), radius=1)
    P.main(["--av2-root", os.path.join(root, "sensor"), "--out", os.path.join(root, "infos.pkl"),
            "--points-out", os.path.join(root, "points"), "--fusion"])
    reader = AV2Reader(os.path.join(root, "infos.pkl"), root, AV2_CLASS_NAMES, training=False)
    return dict(root=root, reader=reader, masks=os.path.join(root, "masks"))


def _front_hw(info):
    front = info["cams"][info["cam_names"][0]]
    return front["height_px"], front["width_px"]


@pytest.mark.parametrize("d", [1, 2])
def test_av2_masks_match_the_jax_loader(tree, d):
    reader, hw = tree["reader"], F.TINY_RIG.ring_hw
    for i, info in enumerate(reader.infos):
        s = reader.sample(i)
        planes, anno, l2i = load_av2_masks([s], [_front_hw(info)], tree["masks"], NUM_CLASSES, hw,
                                           d)
        jm, ja = jmasks.load_sample_masks_single_channel(
            tree["masks"], f"log_{info['timestamp_ns']}", 7, NUM_CLASSES, hw, front_cam=0,
            front_hw=_front_hw(info), downsample=d)
        assert_same([planes, anno], [jmasks.pack_mask_scores(jm[None], ja[None]), ja[None]])
        cams_painted = {int(c) for c in ja[ja[:, 8] > 0, 6]}
        assert cams_painted == set(range(7)) and ((jm & 0xFF) > 0).any(axis=(1, 2, 3)).all()
        want = s["lidar2img"].copy()
        want[0, 0] *= hw[1] / _front_hw(info)[1]
        want[0, 1] *= hw[0] / _front_hw(info)[0]
        want[:, :2] /= d
        assert l2i.dtype == np.float32
        np.testing.assert_allclose(l2i[0], want, rtol=2.0 ** -23, atol=0)


def test_front_camera_points_land_on_their_source_cell(tree):
    reader, (h, w) = tree["reader"], F.TINY_RIG.ring_hw
    info, s = reader.infos[0], reader.sample(0)
    fh, fw = _front_hw(info)
    xyz = s["points"][:, :3].astype(np.float64)
    native = np.c_[xyz, np.ones(len(xyz))] @ info["lidar2img"][0].T
    u, v = native[:, 0] / native[:, 2], native[:, 1] / native[:, 2]
    seen = (native[:, 2] > 1e-3) & (u >= 0) & (u < fw) & (v >= 0) & (v < fh)
    assert seen.sum() > 100
    for d in (1, 2):
        planes, _, l2i = load_av2_masks([s], [(fh, fw)], tree["masks"], NUM_CLASSES, (h, w), d)
        pts = torch.from_numpy(s["points"][seen, :3])
        m = torch.from_numpy(l2i[0, 0])
        pts4 = torch.cat([pts, torch.ones(len(pts), 1)], 1)
        z = (pts4 @ m[2]).clamp(1e-5, 1e5)
        j = torch.floor(pts4 @ m[0] / z).long().numpy()
        i = torch.floor(pts4 @ m[1] / z).long().numpy()
        for cell, src, n, n_src in ((j, u[seen], w, fw), (i, v[seen], h, fh)):
            lo, hi = cell * d * n_src / n, (cell + 1) * d * n_src / n
            edge = np.minimum(np.abs(src - lo), np.abs(src - hi)) < 1e-4
            assert ((lo <= src) & (src < hi) | edge).all()
        inside = (j < w // d) & (i < h // d)
        ids, _ = points_in_mask_compact(pts, torch.zeros(len(pts), dtype=torch.int32),
                                        torch.from_numpy(l2i), torch.from_numpy(
                                            planes.astype(np.int32)).reshape(-1, NUM_CLASSES),
                                        h // d, w // d)
        want = planes[0, 0, i[inside], j[inside]] & 0xFF
        np.testing.assert_array_equal(ids[inside, 0].numpy(), want)
        assert (want > 0).sum() > 50


def test_written_matrix_projects_like_the_rig(tmp_path):
    rig = F.RingRig()
    sweeps = [F.T0_NS + k * F.SWEEP_PERIOD_NS for k in range(2)]
    # every camera 50 ms off the sweeps: a tie, and the earlier image
    stamps = F.camera_stamps(sweeps, period_ns=100_000_000, offsets_ns=[50_000_000] * 7)
    F.write_log(str(tmp_path / "sensor"), "log", [ring_frame(rig, 0)] * 2, rig, stamps=stamps)
    infos = P.main(["--av2-root", str(tmp_path / "sensor"), "--out", str(tmp_path / "i.pkl"),
                    "--points-out", str(tmp_path / "p"), "--fusion"])
    c = P.RING_CAMERAS.index("ring_side_left")
    ego = np.array([[F.RING_CENTRE[0] + 10 * np.cos(rig.yaw(c)), 10 * np.sin(rig.yaw(c)), 1.0]])
    for info in infos:
        ts, t_cam = info["timestamp_ns"], info["cams"]["ring_side_left"]["timestamp_ns"]
        assert t_cam == ts - 50_000_000
        u, v, z = F.project(rig, c, t_cam, F.to_city(ts, ego))
        assert z[0] > 0 and 0 <= u[0] < rig.ring_hw[1] and 0 <= v[0] < rig.ring_hw[0]

        def pixel(m):
            p = m @ np.r_[ego[0], 1.0]
            return np.array([p[0] / p[2], p[1] / p[2]])

        assert np.abs(pixel(info["lidar2img"][c]) - [u[0], v[0]]).max() < 0.5
        k4 = np.eye(4)
        k4[:3, :3] = rig.intrinsics(c)
        uncompensated = k4 @ np.linalg.inv(P.se3(rig.ego_R_cam(c), rig.ego_t_cam(c)))
        assert np.abs(pixel(uncompensated) - [u[0], v[0]]).max() > 20


def test_voxel_coords_agree_with_jax_on_voxel_edges():
    cfg = av2_fsf_config().fsd
    pcr = cfg.segmentor.point_cloud_range
    rng = np.random.default_rng(0)
    xyz = (rng.uniform(-1, 1, (20000, 3)) * (200.0, 200.0, 3.0)).astype(np.float16)
    xyz = xyz.astype(np.float32)
    sizes = {cfg.segmentor.voxel_size, (0.1, 0.1, 0.1), *cfg.cluster_voxel_sizes}
    on_edge = 0
    for vs in sorted(sizes):
        want = np.asarray(jax.jit(lambda x: jvox.voxel_coords(x, vs, pcr)[0])(xyz))
        got = tvox.voxel_coords(torch.from_numpy(xyz), vs, pcr)[0].numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(vs))
        plain = np.floor((xyz - np.float32(pcr[:3])) / np.float32(vs)).astype(np.int32)
        on_edge += int((plain != want).any(1).sum())
    assert on_edge > 100
