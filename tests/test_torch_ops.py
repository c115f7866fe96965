"""The PyTorch port's ops against the JAX package's on the CPU: segments,
voxelization, compaction, geometry, projection, and the plain versions of
kernels K2 (CCL roots) and K3 (NMS keep masks), the one-sample NMS entry
points, ``voxel_downsample`` and the absolute-coordinate box coder. Integer
and bool outputs
must be equal; float outputs agree within 1e-5 (f32 on both sides, sums in
another order). ``test_torch_kernels.py`` holds the CUDA kernels to the plain
versions on a card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullysparsefusion_tpu.core.coders import ABSPointBBoxCoder as JABSCoder
from fullysparsefusion_tpu.ops import geometry as jgeo
from fullysparsefusion_tpu.ops import segment as jseg
from fullysparsefusion_tpu.ops.ccl import connected_components_bev
from fullysparsefusion_tpu.ops.ccl import connected_components_bev_batched as j_ccl_batched
from fullysparsefusion_tpu.ops.nms import multiclass_nms_bev as j_multiclass_nms_one
from fullysparsefusion_tpu.ops.nms import multiclass_nms_bev_batched as j_multiclass_nms
from fullysparsefusion_tpu.ops.nms import nms_bev_mask as j_nms_bev_mask
from fullysparsefusion_tpu.ops.nms import nms_mask_from_iou as j_nms_mask
from fullysparsefusion_tpu.ops.pallas_kernels import nms_scan_pallas
from fullysparsefusion_tpu.ops.projection import points_in_mask_compact as j_pim
from fullysparsefusion_tpu.ops.projection import project_points_2d as j_project
from fullysparsefusion_tpu.ops.voxelize import voxel_downsample as j_voxel_downsample
from fullysparsefusion_tpu.ops.voxelize import voxelize_points as j_voxelize
from fullysparsefusion_tpu.utils.gather import masked_gather as j_masked_gather
from fullysparsefusion_tpu_torch.core.coders import ABSPointBBoxCoder
from fullysparsefusion_tpu_torch.ops import ccl, geometry, nms, projection, segment
from fullysparsefusion_tpu_torch.ops.voxelize import voxel_downsample, voxelize_points
from fullysparsefusion_tpu_torch.synthetic import CCL_CASES, ccl_problem_arrays
from fullysparsefusion_tpu_torch.utils.gather import masked_gather
from test_torch_kernels import _boxes, _ccl_problems, t
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)

F32_TOL = 1e-5


def eq(a, b):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    np.testing.assert_array_equal(a, np.asarray(b))


def close(a, b, tol=F32_TOL):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol)


# --- segments --------------------------------------------------------------


@pytest.mark.parametrize("capacity", [40, 300])
def test_unique_segments_exact(capacity):
    rng = np.random.default_rng(capacity)
    keys = rng.integers(0, 120, 500).astype(np.int32)
    valid = rng.random(500) > 0.2
    got = segment.unique_segments(t(keys), t(valid), capacity)
    ref = jseg.unique_segments(jnp.asarray(keys), jnp.asarray(valid), capacity)
    for f in ("seg_id", "unique_keys", "counts", "num_segments", "seg_valid"):
        eq(getattr(got, f), getattr(ref, f))
    uk, sv, ns = segment.unique_keys_sorted(t(keys), t(valid), capacity)
    ruk, rsv, rns = jseg.unique_keys_sorted(jnp.asarray(keys), jnp.asarray(valid), capacity)
    eq(uk, ruk), eq(sv, rsv), eq(ns, rns)


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


@pytest.mark.parametrize("capacity", [10, 200, 400])
def test_masked_gather_exact(capacity):
    mask = np.random.default_rng(capacity).random(300) > 0.6
    got = masked_gather(t(mask), capacity)
    ref = j_masked_gather(jnp.asarray(mask), capacity)
    eq(got[0], ref[0]), eq(got[1], ref[1])


def test_voxelize_points_exact():
    rng = np.random.default_rng(2)
    xyz = rng.uniform(-14, 14, (3000, 3)).astype(np.float32)
    batch = rng.integers(0, 2, 3000).astype(np.int32)
    valid = rng.random(3000) > 0.1
    args = ((0.4, 0.4, 0.4), (-12.8, -12.8, -3.0, 12.8, 12.8, 3.2), 300)
    seg, coords, vb, vc = voxelize_points(t(xyz), t(batch), t(valid), *args)
    rseg, rcoords, rvb, rvc = j_voxelize(jnp.asarray(xyz), jnp.asarray(batch),
                                         jnp.asarray(valid), *args)
    for f in ("seg_id", "unique_keys", "counts", "num_segments", "seg_valid"):
        eq(getattr(seg, f), getattr(rseg, f))
    eq(coords, rcoords), eq(vb, rvb), eq(vc, rvc)
    assert int(rseg.num_segments) > 300       # overflow exercised


@pytest.mark.parametrize("capacity", [200, 4000])
def test_voxel_downsample_matches_jax(capacity):
    """Mean per voxel of every array; ``capacity`` 200 overflows."""
    rng = np.random.default_rng(capacity)
    xyz = rng.uniform(-14, 14, (3000, 3)).astype(np.float32)
    xyz[1000:1500] = xyz[:500] + 0.01               # shared voxels: real means
    batch = rng.integers(0, 2, 3000).astype(np.int32)
    valid = rng.random(3000) > 0.1
    data = {"xyz": xyz, "feat": rng.normal(size=(3000, 5)).astype(np.float32)}
    args = ((0.4, 0.4, 0.4), (-12.8, -12.8, -3.0, 12.8, 12.8, 3.2), capacity)
    out, vb, vv = voxel_downsample({k: t(v) for k, v in data.items()}, t(xyz), t(batch),
                                   t(valid), *args)
    rout, rvb, rvv = j_voxel_downsample({k: jnp.asarray(v) for k, v in data.items()},
                                        jnp.asarray(xyz), jnp.asarray(batch),
                                        jnp.asarray(valid), *args)
    eq(vb, rvb), eq(vv, rvv)
    assert set(out) == set(rout)
    for k in out:
        close(out[k], rout[k])
    assert 0 < int(vv.sum()) <= capacity


# --- K2: connected components ----------------------------------------------


def _union_find_roots(xy, batch, valid):
    n = len(xy)
    parent = list(range(n))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    d2 = ((xy[:, None, :] - xy[None, :, :]) ** 2).sum(-1)
    for i in range(n):
        for j in range(i + 1, n):
            if valid[i] and valid[j] and batch[i] == batch[j] and d2[i, j] < 1.0:
                parent[find(i)] = find(j)
    return np.array([min(j for j in range(n) if valid[j] and find(j) == find(i))
                     if valid[i] else -1 for i in range(n)])


@pytest.mark.parametrize("seed,g,n", [pytest.param(0, 3, 96, id="0"),
                                      pytest.param(1, 3, 96, id="1"),
                                      pytest.param(2, 6, 100, id="g6-n100")])
def test_ccl_roots_plain_matches_union_find_and_jax(seed, g, n):
    """Mixed batch ids and an all-invalid problem (2) in every case; the
    compact labels come from the batched relabel of all problems at once."""
    xy, batch, valid = _ccl_problems(seed, g, n)
    assert not valid[2].any() and len(np.unique(batch[valid])) == 2
    roots = ccl.ccl_roots(t(xy), t(batch), t(valid))
    assert roots.dtype == torch.int32
    for gi in range(xy.shape[0]):
        eq(roots[gi], _union_find_roots(xy[gi], batch[gi], valid[gi]))
    labels = ccl.connected_components_bev_batched(t(xy), t(batch), t(valid))
    for gi in range(xy.shape[0]):
        ref = connected_components_bev(jnp.asarray(xy[gi]), jnp.asarray(batch[gi]),
                                       jnp.asarray(valid[gi]), 1.0)
        eq(labels[gi], ref)
    assert len(set(roots[0, :10].tolist())) == 10 and len(set(roots[0, 10:20].tolist())) == 1


@pytest.mark.parametrize("case", CCL_CASES)
def test_ccl_problem_cases_match_union_find(case):
    """The K2 stress inputs (small here, full size on the card) and what
    each is built to hold: one component, complete stacks split by batch."""
    xy, batch, valid = ccl_problem_arrays(case, 2, 70, seed=3)
    roots = ccl.ccl_roots(t(xy), t(batch), t(valid))
    for gi in range(2):
        eq(roots[gi], _union_find_roots(xy[gi], batch[gi], valid[gi]))
    comps = [len(np.unique(r[r >= 0])) for r in roots.numpy()]
    expect = {"reversed_chain": [1, 1], "grid": [1, 1], "all_invalid": [0, 0]}
    if case in expect:
        assert comps == expect[case]
    elif case == "mixed_batch":
        assert comps[0] > len(np.unique(xy[0, :, 0]))
    elif case == "random":
        assert comps[1] == 0 and comps[0] > 1


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


# --- K3: NMS ---------------------------------------------------------------


def _nms_case(seed, n, ties=False, all_invalid=False):
    rng = np.random.default_rng(seed)
    m = rng.random((n, n)).astype(np.float32)
    iou = (m + m.T) / 2
    np.fill_diagonal(iou, 1.0)
    scores = rng.random(n).astype(np.float32)
    if ties:
        scores = np.round(scores * 4) / 4        # many equal scores: stable order decides
    valid = np.zeros(n, bool) if all_invalid else rng.random(n) > 0.2
    return iou, scores, valid


@pytest.mark.parametrize("case", [dict(n=40), dict(n=40, ties=True),
                                  dict(n=40, all_invalid=True), dict(n=64)])
def test_nms_mask_from_iou_matches_jax(case):
    iou, scores, valid = _nms_case(7, **case)
    got = nms.nms_mask_from_iou(t(iou), t(scores), t(valid), 0.6)
    eq(got, j_nms_mask(jnp.asarray(iou), jnp.asarray(scores), jnp.asarray(valid), 0.6))
    if case.get("all_invalid"):
        assert not got.any()


def test_nms_keep_plain_matches_pallas_interpret_64():
    iou, _, valid = _nms_case(3, 64)
    order = torch.arange(64, dtype=torch.int32)[None]
    got = nms.nms_keep_plain(t(iou), order, t(valid)[None], 0.6)[0]
    eq(got, nms_scan_pallas(jnp.asarray(iou), jnp.asarray(valid), 0.6, interpret=True))


def test_multiclass_nms_bev_batched_matches_jax():
    rng = np.random.default_rng(4)
    n, c = 120, 4
    boxes = _boxes(rng, n)
    scores = rng.random((n, c)).astype(np.float32)
    scores[:10] = 0.5                           # cross-class and cross-box ties
    valid = rng.random(n) > 0.1
    batch = rng.integers(0, 2, n).astype(np.int32)
    got = nms.multiclass_nms_bev_batched(t(boxes), t(scores), t(valid), t(batch), 2,
                                         0.2, 0.45, 150)
    ref = j_multiclass_nms(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid),
                           jnp.asarray(batch), 2, 0.2, 0.45, 150)
    eq(got.valid, ref.valid), eq(got.labels, ref.labels)
    close(got.boxes, ref.boxes), close(got.scores, ref.scores)
    assert 0 < int(got.valid.sum()) < 300     # below max_num: the NMS, not the cap, decides


@pytest.mark.parametrize("ties", [False, True])
def test_nms_bev_mask_matches_jax(ties):
    rng = np.random.default_rng(8)
    boxes = _boxes(rng, 90, extent=4.0)
    scores = rng.random(90).astype(np.float32)
    if ties:
        scores = np.round(scores * 3) / 3
    valid = rng.random(90) > 0.15
    got = nms.nms_bev_mask(t(boxes), t(scores), t(valid), 0.1)
    eq(got, j_nms_bev_mask(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), 0.1))
    assert 0 < int(got.sum()) < int(valid.sum())  # some suppressed


@pytest.mark.parametrize("max_num", [40, 500])
def test_multiclass_nms_bev_one_sample_matches_jax(max_num):
    """One sample, 26 classes (AV2's count); ``max_num`` 40 cuts, 500 pads."""
    rng = np.random.default_rng(9)
    n, c = 100, 26
    boxes = _boxes(rng, n, extent=5.0)
    scores = rng.random((n, c)).astype(np.float32)
    scores[:8] = 0.75                           # cross-class and cross-box ties
    valid = rng.random(n) > 0.1
    got = nms.multiclass_nms_bev(t(boxes), t(scores), t(valid), 0.2, 0.6, max_num)
    ref = j_multiclass_nms_one(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid),
                               0.2, 0.6, max_num)
    assert got.valid.shape == (max_num,)
    eq(got.valid, ref.valid), eq(got.labels, ref.labels)
    close(got.boxes, ref.boxes), close(got.scores, ref.scores)
    assert 0 < int(got.valid.sum()) <= max_num


@pytest.mark.parametrize("code_size", [8, 10])
def test_abs_point_coder_matches_jax(code_size):
    rng = np.random.default_rng(code_size)
    boxes = _boxes(rng, 50, extent=40.0)[:, :9]
    boxes = np.concatenate([boxes, np.ones((50, 1), np.float32)], 1)
    base = rng.normal(size=(50, 3)).astype(np.float32)
    kw = dict(code_size=code_size, xy_normalizer=40.0, z_normalizer=4.0)
    coder, jcoder = ABSPointBBoxCoder(**kw), JABSCoder(**kw)
    enc = coder.encode(t(boxes), t(base))
    close(enc, jcoder.encode(jnp.asarray(boxes), jnp.asarray(base)))
    preds = rng.normal(size=(50, code_size)).astype(np.float32)
    close(coder.decode(t(preds), t(base)), jcoder.decode(jnp.asarray(preds), jnp.asarray(base)))
    dec = coder.decode(enc, t(base))
    close(dec, boxes[:, :9 if code_size == 10 else 7], tol=1e-4)   # round trip (yaw in (-π, π])


# --- geometry and projection -----------------------------------------------


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


def _fsf_mask_inputs():
    """``tests/test_fsf.py::test_points_in_mask_compact_matches_full``'s
    inputs: the tiny config's seed-3 scene and its camera masks."""
    from fixtures import make_camera_data, make_scene
    from fullysparsefusion_tpu.config import tiny_fsf_config

    cfg = tiny_fsf_config()
    pb, gt = make_scene(seed=3, n_cap=cfg.caps.points, max_gt=cfg.caps.max_gt)
    cam = make_camera_data(pb, gt, num_classes=cfg.num_classes)
    masks5 = np.asarray(cam.masks).reshape(cam.lidar2img.shape[0], cam.num_cams, cam.img_h,
                                           cam.img_w, cam.num_cls)
    return pb, cam, masks5


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
