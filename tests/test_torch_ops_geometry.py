"""Box geometry, the camera projection and mask lookups, the segment reductions
and the CCL's reversed chain against the JAX package on the CPU: tests of
``test_torch_ops.py``, at its tolerances. A file of at most five tests, so
that xdist's ``--dist loadfile`` (files with more tests first) queues it
behind ``tests/test_train.py``, the run's longest file.
"""
import jax.numpy as jnp
import numpy as np
import torch

from fullysparsefusion_tpu.ops import geometry as jgeo
from fullysparsefusion_tpu.ops import segment as jseg
from fullysparsefusion_tpu.ops.ccl import connected_components_bev_batched as j_ccl_batched
from fullysparsefusion_tpu.ops.projection import points_in_mask_compact as j_pim
from fullysparsefusion_tpu.ops.projection import project_points_2d as j_project
from fullysparsefusion_tpu_torch.ops import ccl, geometry, projection, segment
from fullysparsefusion_tpu_torch.synthetic import ccl_problem_arrays
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)
from test_torch_kernels import _boxes, t
from test_torch_ops import _fsf_mask_inputs, _union_find_roots, close, eq


def test_segment_reductions_and_ingroup_indices():
    rng = np.random.default_rng(1)
    cap = 64
    seg_id = rng.integers(0, cap + 1, 700).astype(np.int32)   # cap = trash
    feat = rng.normal(size=(700, 5)).astype(np.float32)
    counts = np.bincount(seg_id, minlength=cap + 1)[:cap].astype(np.int32)
    close(segment.segment_sum(t(feat), t(seg_id), cap),
          jseg.segment_sum(jnp.asarray(feat), jnp.asarray(seg_id), cap))
    close(segment.segment_mean(t(feat), t(seg_id), cap, counts=t(counts)),
          jseg.segment_mean(jnp.asarray(feat), jnp.asarray(seg_id), cap, counts=jnp.asarray(counts)))
    for name in ("segment_max", "segment_min"):
        eq(getattr(segment, name)(t(feat), t(seg_id), cap, empty_value=-3.0),
           getattr(jseg, name)(jnp.asarray(feat), jnp.asarray(seg_id), cap, empty_value=-3.0))
    groups = rng.integers(0, 9, 300).astype(np.int32)
    valid = rng.random(300) > 0.3
    eq(segment.ingroup_indices(t(groups), t(valid)),
       jseg.ingroup_indices(jnp.asarray(groups), jnp.asarray(valid)))


def test_reversed_chain_is_one_component_where_jax_caps_its_sweeps():
    """One chain 0.9 apart, node 0 at one end and the others numbered down
    from the far end: the component minimum moves one hop per sweep. The
    port is exact; the JAX package's CPU path stops after 32 iterations
    (its TPU path after 12 fixed sweeps) and splits the chain."""
    xy, batch, valid = ccl_problem_arrays("reversed_chain", 1, 64)
    ref = _union_find_roots(xy[0], batch[0], valid[0])
    assert (ref == 0).all()
    eq(ccl.ccl_roots(t(xy), t(batch), t(valid))[0], ref)
    assert ccl.ccl_roots_plain.sweeps > 33
    eq(ccl.connected_components_bev_batched(t(xy), t(batch), t(valid)), np.zeros((1, 64)))
    jax_labels = j_ccl_batched(jnp.asarray(xy), jnp.asarray(batch), jnp.asarray(valid))
    assert len(np.unique(np.asarray(jax_labels))) > 1


def test_box_geometry_matches_jax():
    rng = np.random.default_rng(5)
    boxes = _boxes(rng, 50)
    pts = rng.uniform(-7, 7, (400, 3)).astype(np.float32)
    tb, jb = t(boxes), jnp.asarray(boxes)
    close(geometry.gravity_center(tb), jgeo.gravity_center(jb))
    close(geometry.enlarge_boxes(tb, (1.0, 1.0, 1.0), 0.5),
          jgeo.enlarge_boxes(jb, (1.0, 1.0, 1.0), 0.5))
    close(geometry.rotate_points_z(t(pts), t(pts[:, 0])),
          jgeo.rotate_points_z(jnp.asarray(pts), jnp.asarray(pts[:, 0])))
    close(geometry.box_corners_bev(tb), jgeo.box_corners_bev(jb))
    inside = geometry.points_in_boxes(t(pts), tb)
    eq(inside, jgeo.points_in_boxes(jnp.asarray(pts), jb))
    assert inside.any()
    iou = geometry.boxes_iou_bev(tb, tb[:20])
    close(iou, jgeo.boxes_iou_bev(jb, jb[:20]))
    assert (iou > 0).sum() > 20


def test_projection_and_compact_mask_lookup_match_jax():
    from fixtures import make_camera_data, make_scene

    pb, gt = make_scene(seed=0)
    cam = make_camera_data(pb, gt)
    xyz = np.asarray(pb.points[:, :3])
    batch = np.asarray(pb.batch_idx)
    uv, ok = projection.project_points_2d(t(xyz), t(np.asarray(cam.lidar2img[0])),
                                          cam.img_h, cam.img_w)
    ruv, rok = j_project(jnp.asarray(xyz), cam.lidar2img[0], cam.img_h, cam.img_w)
    eq(ok, rok)
    close(uv, ruv)
    ids, scores = projection.points_in_mask_compact(
        t(xyz), t(batch), t(np.asarray(cam.lidar2img)),
        t(np.asarray(cam.masks).astype(np.int32)), cam.img_h, cam.img_w)
    rids, rscores = j_pim(jnp.asarray(xyz), jnp.asarray(batch), cam.lidar2img, cam.masks,
                          cam.img_h, cam.img_w)
    eq(ids, rids), eq(scores, rscores)
    assert (ids > 0).any()


def test_full_mask_lookup_matches_jax_and_compact():
    from fullysparsefusion_tpu.ops.projection import points_in_mask as j_points_in_mask

    pb, cam, masks5 = _fsf_mask_inputs()
    xyz, batch = np.asarray(pb.xyz), np.asarray(pb.batch_idx)
    l2i = np.asarray(cam.lidar2img)
    ids, scores = projection.points_in_mask(t(xyz), t(batch), t(l2i), t(masks5.astype(np.int32)))
    rids, rscores = j_points_in_mask(jnp.asarray(xyz), jnp.asarray(batch), cam.lidar2img,
                                     jnp.asarray(masks5))
    eq(ids, rids), eq(scores, rscores)
    assert ids.shape == (xyz.shape[0], cam.num_cams, cam.num_cls) and (ids > 0).any()
    # a point of this rig projects into at most two cameras, so the two
    # lowest-index cameras it projects into carry every hit: per point and
    # class, the (id, score) entries over the cameras equal the compact's
    cids, cscores = projection.points_in_mask_compact(
        t(xyz), t(batch), t(l2i), t(np.asarray(cam.masks).astype(np.int32)), cam.img_h,
        cam.img_w)
    full = (ids.double() * 256 + torch.round(scores.double() * 255)).sort(1, descending=True)
    comp = (cids.double() * 256 + torch.round(cscores.double() * 255)).sort(1, descending=True)
    eq(full.values[:, 2:], torch.zeros_like(full.values[:, 2:]))
    eq(full.values[:, :2], comp.values)
