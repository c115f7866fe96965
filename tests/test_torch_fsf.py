"""FSF inference in the PyTorch port against the JAX package, phase by phase,
on the tiny config and the fixture scene (batch 2), with the JAX package's
variable tree carried across by ``weights.from_jax_variables``.

One JAX forward + ``get_bboxes`` runs once per module (a single jit, on
weights drawn with numpy into the JAX variable tree); its result dict is
compared entry by entry with the port's. Tolerances:

* integer and bool outputs (validity, batch ids, labels, rows, counts):
  equal;
* f32 outputs downstream of the sparse UNet: 4e-3 relative / absolute. The
  UNet keeps bf16 activations between convs and its dense stage rounds conv
  outputs to bf16, so a value can land one bf16 ulp (2^-8) apart between
  the two packages;
* f32 outputs of modules fed identical f32 inputs (head, decode + NMS, RoI
  grid pooling): 1e-5, f32 sums in another order.

UNet paths at this size (batch 2, grid 64 x 64 x 16): stages 0 and 1 take
the gather path (kernel K1's plain version), stage 2 (16 x 16 x 4, capacity
1024) the dense conv3d path; the test asserts both ran.

``test_torch_fsf_phases.py`` and ``test_torch_fsf_heads.py`` hold more tests
of this module's helpers and fixtures, at its tolerances, in files of at
most five tests, so that xdist's ``--dist loadfile`` (files with more tests
first) queues them behind ``tests/test_train.py``, the Tier-1 run's longest
file.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures import make_camera_data, make_scene, with_noaug_channels
from fullysparsefusion_tpu.config import tiny_fsf_config as j_tiny_fsf_config
from fullysparsefusion_tpu.models.fsf import FSF as JFSF
from fullysparsefusion_tpu.models.roi import extract_roi_points_grid as j_roi_grid
from fullysparsefusion_tpu_torch import synthetic as S
from fullysparsefusion_tpu_torch.config import tiny_fsf_config
from fullysparsefusion_tpu_torch.models import roi as troi
from fullysparsefusion_tpu_torch.models import sparse_unet
from fullysparsefusion_tpu_torch.ops import sparse_conv
from fullysparsefusion_tpu_torch.weights import build_fsf
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)

BF16_CHAIN_TOL = 4e-3
F32_TOL = 1e-5
# XLA compile time of the reference, not its math: XLA's backend
# optimisation off, which only moves the reference by float rounding
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _numpy_variables(shapes, seed=0):
    """Weights for every leaf of the JAX variable tree, drawn with numpy:
    kernels ~ N(0, 1/fan_in), norm scales near 1, biases and BN means near
    0, BN variances in [0.5, 1.5]. Unlike a fresh init, the enhancement
    MLP's last layer is not zero, so the camera scores reach the point
    features, and BN statistics are not the identity."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name in ("kernel", "w"):
            return (rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name == "scale":
            return (1 + 0.1 * rng.normal(size=s.shape)).astype(np.float32)
        return (0.05 * rng.normal(size=s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _run_jax():
    cfg = j_tiny_fsf_config()
    pb, gt = make_scene(seed=0, n_cap=cfg.caps.points, max_gt=cfg.caps.max_gt)
    cam = make_camera_data(pb, gt, num_classes=cfg.num_classes)
    pb = with_noaug_channels(pb)
    model = JFSF(cfg=cfg)
    # the variable tree's shapes without compiling init
    shapes = jax.eval_shape(
        lambda k: model.init(k, pb, cam, 2, None, None, False,
                             method=lambda m, *a, **kw: m(*a, **kw)),
        jax.random.key(0))
    jvars = _numpy_variables(shapes)

    def run(v):
        out = model.apply(v, pb, cam, 2, None, None, False)
        return out, model.apply(v, out, 2, method=JFSF.get_bboxes)

    out, det = jax.tree_util.tree_map(
        np.asarray, jax.jit(run, compiler_options=FAST_COMPILE)(jvars))
    return jvars, out, det


class _Count:
    """Count calls of a module-level function while inside the context."""

    def __init__(self, module, name):
        self.module, self.name, self.n = module, name, 0

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def counted(*a, **k):
            self.n += 1
            return self.orig(*a, **k)

        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


@pytest.fixture(scope="module")
def parity():
    jvars, jout, jdet = _run_jax()
    cfg = tiny_fsf_config()
    sc = S.make_scene_arrays(seed=0, n_cap=cfg.caps.points, max_gt=cfg.caps.max_gt)
    cam = S.make_camera_arrays(sc["gt_boxes"], sc["gt_labels"], sc["gt_valid"],
                               num_classes=cfg.num_classes)
    pb, cd = S.fsf_inputs(sc, cam, device="cpu")
    model = build_fsf(cfg, device="cpu", jax_variables=jvars)
    with _Count(sparse_conv, "gather_conv") as gather, \
            _Count(sparse_unet, "subm_conv_dense") as dense_subm, \
            _Count(sparse_unet, "sparse_conv3d_dense") as dense_down:
        out = model(pb, cd, 2)
    det = model.get_bboxes(out, 2)
    counts = dict(gather=gather.n, dense=dense_subm.n + dense_down.n)
    return dict(jvars=jvars, jout=jout, jdet=jdet, model=model, out=out, det=det,
                counts=counts, cfg=cfg)


def _check(name, ref, got, tol):
    ref = np.asarray(ref)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    if ref.dtype == bool or np.issubdtype(ref.dtype, np.integer):
        np.testing.assert_array_equal(got, ref, err_msg=name)
    else:
        np.testing.assert_allclose(got, ref, rtol=tol, atol=tol, err_msg=name)


PHASES = {
    "seg": lambda o: {f"seg_out.{k}": o["seg_out"][k]
                      for k in ("seg_feats", "seg_logits", "vote_preds", "offsets", "valid")},
    "frustum": lambda o: {
        **{f"frustum.{k}": o["frustum"][k]
           for k in ("obj_centers", "obj_batch", "obj_valid", "obj_row", "preds_2d")},
        "frustum.cls_logits": _task0(o["frustum"]["out"]["cls_logits"]),
        "frustum.reg_preds": _task0(o["frustum"]["out"]["reg_preds"])},
    "fsd": lambda o: {f"fsd.{k}": o["fsd"][k]
                      for k in ("cluster_xyz", "cluster_batch", "cluster_group", "cluster_valid",
                                "obj_feat", "cls_logits", "reg_preds", "num_clusters",
                                "num_fg_points")},
    "fusion_and_final": lambda o: {
        **{f"final.{k}": o["final"][k]
           for k in ("centers", "cls_logits", "reg_preds", "q_batch", "q_valid")},
        **{f"stage{i}.{k}": st[k] for i, st in enumerate(o["stages"])
           for k in ("centers", "cls_logits", "reg_preds")}},
}


def _task0(x):
    """JAX heads return one entry per task; the port's single-task head the tensor."""
    return x[0] if isinstance(x, (list, tuple)) else x


def test_roi_grid_pooling_on_identical_inputs_matches_jax():
    rng = np.random.default_rng(0)
    n, q = 3000, 40
    xyz = rng.uniform(-12, 12, (n, 3)).astype(np.float32)
    pb = rng.integers(0, 2, n).astype(np.int32)
    pv = rng.random(n) > 0.1
    rois = np.zeros((q, 7), np.float32)
    rois[:, :2] = rng.uniform(-10, 10, (q, 2))
    rois[:, 2] = rng.uniform(-2, 0, q)
    rois[:, 3:6] = rng.uniform(1, 5, (q, 3))
    rois[:, 6] = rng.uniform(-np.pi, np.pi, q)
    rois[:6, :2] = rois[6:12, :2] + 0.3                  # overlapping RoIs share points
    rb = rng.integers(0, 2, q).astype(np.int32)
    rv = rng.random(q) > 0.1
    args = ((1.0, 1.0, 1.0), 2048, 2)
    kw = dict(batch_size=2, bev_lo=(-12.8, -12.8), bev_hi=(12.8, 12.8))
    ref = j_roi_grid(*map(jnp.asarray, (xyz, pb, pv, rois, rb, rv)), *args, **kw)
    got = troi.extract_roi_points_grid(*map(torch.from_numpy, (xyz, pb, pv, rois, rb, rv)),
                                       *args, **kw)
    for f in ("point_idx", "roi_idx", "valid"):
        _check(f, getattr(ref, f), getattr(got, f), 0)
    _check("geometry", ref.geometry, got.geometry, F32_TOL)
    assert 100 < int(got.valid.sum()) < 2048
