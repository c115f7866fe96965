"""The PyTorch port's ops against the JAX package's on the CPU: segments,
voxelization, compaction, geometry, projection, and the plain versions of
kernels K2 (CCL roots) and K3 (NMS keep masks), the one-sample NMS entry
points, ``voxel_downsample`` and the absolute-coordinate box coder. Integer
and bool outputs
must be equal; float outputs agree within 1e-5 (f32 on both sides, sums in
another order). ``test_torch_kernels.py`` holds the CUDA kernels to the plain
versions on a card.

``test_torch_ops_nms.py`` and ``test_torch_ops_geometry.py`` hold more tests
of this module's helpers and fixtures, at its tolerances, in files of at
most five tests, so that xdist's ``--dist loadfile`` (files with more tests
first) queues them behind ``tests/test_train.py``, the Tier-1 run's longest
file.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullysparsefusion_tpu.core.coders import ABSPointBBoxCoder as JABSCoder
from fullysparsefusion_tpu.ops import segment as jseg
from fullysparsefusion_tpu.ops.ccl import connected_components_bev
from fullysparsefusion_tpu.ops.nms import nms_mask_from_iou as j_nms_mask
from fullysparsefusion_tpu.ops.pallas_kernels import nms_scan_pallas
from fullysparsefusion_tpu.ops.voxelize import voxel_downsample as j_voxel_downsample
from fullysparsefusion_tpu.ops.voxelize import voxelize_points as j_voxelize
from fullysparsefusion_tpu.utils.gather import masked_gather as j_masked_gather
from fullysparsefusion_tpu_torch.core.coders import ABSPointBBoxCoder
from fullysparsefusion_tpu_torch.ops import ccl, nms, segment
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


def _segment_rows(rng, width, n=4000):
    """Rows of ``width`` f32 columns ([n] for width 1) over keys of which
    about half are invalid: a trash run of ~2,000 rows."""
    keys = rng.integers(0, 500, n).astype(np.int32)
    valid = rng.random(n) < 0.5
    feat = rng.normal(size=(n, width) if width > 1 else (n,)).astype(np.float32)
    return keys, valid, feat


@pytest.mark.parametrize("width", [1, 3, 4, 27, 128])
def test_segment_sum_matches_jax(width):
    """``fsf::segment_sum`` adds each segment's rows in ascending row order
    from 0, as XLA's scatter-add on the CPU does: bitwise equal, past the
    capacity (overflow into the trash row), with empty slots after the last
    segment, and through bare ids with gaps (empty segments)."""
    rng = np.random.default_rng(width)
    keys, valid, feat = _segment_rows(rng, width)
    for capacity in (150, 600):                   # ~410 distinct keys
        seg = segment.unique_segments(t(keys), t(valid), capacity)
        eq(seg.sum(t(feat)), jseg.segment_sum(jnp.asarray(feat), jnp.asarray(seg.seg_id.numpy()),
                                              capacity))
    capacity = 300
    ids = rng.integers(0, capacity + 1, len(feat)) // 2 * 2    # odd ids empty
    ref = np.zeros((capacity + 1,) + feat.shape[1:], np.float32)
    np.add.at(ref, ids, feat)                     # unbuffered: in row order
    eq(segment.segment_sum(t(feat), t(ids.astype(np.int32)), capacity), ref[:capacity])


def test_segment_sum_gradient_is_the_index_put_gradient():
    """The op's gradient is the gather of the output's gradient by segment
    id, 0 on trash rows: bitwise what ``index_put_(accumulate=True)`` into
    ``capacity + 1`` rows and a slice give."""
    rng = np.random.default_rng(5)
    keys, valid, feat = _segment_rows(rng, 27)
    capacity = 150
    seg = segment.unique_segments(t(keys), t(valid), capacity)
    g = t(rng.normal(size=(capacity, 27)).astype(np.float32))

    def grad(reduce):
        x = t(feat).requires_grad_()
        (reduce(x) * g).sum().backward()
        return x.grad

    def index_put(x):
        out = x.new_zeros((capacity + 1, 27))
        return out.index_put_((seg.seg_id.long(),), x, accumulate=True)[:capacity]

    want = grad(index_put)
    assert bool((want[seg.seg_id == capacity] == 0).all())
    for reduce in (seg.sum, lambda x: segment.segment_sum(x, seg.seg_id, capacity)):
        assert torch.equal(grad(reduce), want)


def test_segment_mean_through_segment_info_is_the_id_form():
    """``SegmentInfo.mean`` (the CSR ``unique_segments`` keeps) equals
    ``segment_mean`` over the bare ids bitwise: on [N] and [N, C] rows and a
    strided view of wider rows."""
    rng = np.random.default_rng(6)
    keys, valid, feat = _segment_rows(rng, 7)
    capacity = 150
    seg = segment.unique_segments(t(keys), t(valid), capacity)
    rows = t(feat)
    for x in (rows[:, 0].contiguous(), rows, rows[:, :3]):
        want = segment.segment_mean(x, seg.seg_id, capacity)
        eq(seg.mean(x), want)
        eq(segment.segment_mean(x, seg.seg_id, capacity, counts=seg.counts), want)


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
