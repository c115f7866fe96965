"""The HTC 2D instance-mask model in the PyTorch port against the JAX
package on the CPU: ``ops/roi_align.py``, ``ops/dcn.py``, the box code and
layers of ``models/htc.py``, the whole tiny HTC tap by tap
(``utils/htc_parity.py``) and end to end, ``weights.from_jax_variables``
on HTC's tree, and the mask generation against the ``jax-htc`` backend of
``tools/generate_masks.py`` plus its ``paint_sample``.

Weights: the JAX variable tree's shapes come from ``jax.eval_shape`` of
``init`` (an eager ``init`` of the tiny HTC takes ~40 s), drawn with numpy:
kernels ~ N(0, 1/fan_in), norm scales near 1, BN variances in [0.5, 1.5],
other leaves 0.05 · N(0, 1), and the DCN offset branch ``conv_offset_w`` ~
0.5 · N(0, 1/fan_in), so that offsets are fractional, of the order of a
pixel, and some samples leave the map (at init they are 0 and DCN would be
a grouped conv). The references are jitted once each with
``FAST_COMPILE``.

Tolerances:

* function level (RoIAlign, DCN, the offset branch, anchors and decode,
  the semantic head's resize): 1e-5 relative and absolute (DCN: relative to
  the output's magnitude), f32 on both sides with sums in another order;
  the level map and the anchors exactly;
* the tiny HTC's taps (``ACTIVATION_ORDER``, image-level and on fixed
  RoIs): each within ``TAP_TOL`` = 1e-4 of the tap's largest magnitude, an
  f32 chain of ~20 layers whose sums run in another order;
* the whole tiny forward, on a random image and on a constant image whose
  RPN and class scores are tied exactly (``tiny`` says how and why):
  labels, validity and the row order exact, boxes within ``TAP_TOL`` of the
  image size, scores and mask probabilities within ``TAP_TOL``;
* the mask paste: the port's PIL resample bitwise equal to PIL's; the
  masks of the whole generation equal to the tool's except where PIL's
  value of the tool's map is 127 or 128 (where an f32 ulp of the
  probability can move the threshold), the painted planes equal where no
  mask differs, the anno rows' floats within 1e-4 and the rest exact.

``test_torch_htc_tiny.py`` and ``test_torch_htc_masks.py`` hold more tests
of this module's helpers and fixtures, at its tolerances, in files of at
most five tests, so that xdist's ``--dist loadfile`` (files with more tests
first) queues them behind ``tests/test_train.py``, the Tier-1 run's longest
file.
"""
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from fullysparsefusion_tpu.models import htc as jhtc
from fullysparsefusion_tpu.ops import dcn as jdcn
from fullysparsefusion_tpu.ops import roi_align as jroi
from fullysparsefusion_tpu.utils import htc_parity as jparity
from fullysparsefusion_tpu_torch import generate_masks as gm
from fullysparsefusion_tpu_torch.models import htc as thtc
from fullysparsefusion_tpu_torch.ops import dcn as tdcn
from fullysparsefusion_tpu_torch.ops import roi_align as troi
from fullysparsefusion_tpu_torch.weights import build_htc
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)
from test_torch_fsf import FAST_COMPILE

F32_TOL = 1e-5
TAP_TOL = 1e-4
TINY = dict(depth_blocks=(1, 1, 1, 1), num_proposals=16, rpn_pre_nms=16, max_dets=4)
# the tool's FSF_HTC_TINY model
TOOL_TINY = dict(depth_blocks=(1, 1, 1, 1), num_proposals=64, rpn_pre_nms=64, max_dets=8)
HW = (96, 160)
FIXED_ROIS = np.asarray([[4, 4, 40, 30], [10, 8, 60, 50], [0, 0, 150, 90], [30, 20, 50, 44],
                         [100, 50, 159, 95], [-8, 60, 30, 100]], np.float32)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def t(x):
    return torch.from_numpy(np.array(x))


def close(a, b, tol=F32_TOL):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol)


def _numpy_variables(shapes, seed=0):
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        fan_in = np.prod(s.shape[:-1])
        if name in ("kernel", "w"):
            return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "conv_offset_w":
            return (0.5 * rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name == "scale":
            return (1 + 0.1 * rng.normal(size=s.shape)).astype(np.float32)
        return (0.05 * rng.normal(size=s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _variable_shapes(model, hw):
    return jax.eval_shape(model.init, jax.random.key(0),
                          jax.ShapeDtypeStruct((1, *hw, 3), jnp.float32))


class _JittedApply:
    """A flax module whose ``apply`` is jitted once per keyword signature
    (``FAST_COMPILE``), for ``dump_jax_activations``, which calls ``apply``
    eagerly; keeps the last output of each signature."""

    def __init__(self, model):
        self.model, self.fns, self.last = model, {}, {}

    def apply(self, variables, *args, **kw):
        key = tuple(sorted(kw))
        if key not in self.fns:
            self.fns[key] = jax.jit(functools.partial(self.model.apply, **kw),
                                    compiler_options=FAST_COMPILE)
        self.last[key] = self.fns[key](variables, *args)
        return self.last[key]


def _images():
    rng = np.random.default_rng(1)
    return {"random": rng.uniform(0, 255, (1, *HW, 3)).astype(np.float32),
            "constant": np.full((1, *HW, 3), 128.0, np.float32)}


def _tied(jvars):
    """``jvars`` with the RPN's class kernel and the bbox heads' class
    kernels 0: every anchor of a level then scores sigmoid(its bias) and
    every proposal the same class scores, exactly, in both packages."""
    params = dict(jvars["params"])
    params["rpn_head"] = {**params["rpn_head"], "rpn_cls": {
        **params["rpn_head"]["rpn_cls"],
        "kernel": np.zeros_like(params["rpn_head"]["rpn_cls"]["kernel"])}}
    for i in range(3):
        head = params[f"bbox_head{i}"]
        params[f"bbox_head{i}"] = {**head, "fc_cls": {
            **head["fc_cls"], "kernel": np.zeros_like(head["fc_cls"]["kernel"])}}
    return {**jvars, "params": params}


@pytest.fixture(scope="module")
def tiny():
    """The tiny HTC in both packages from one numpy variable tree, and the
    JAX package's taps and detections on the random image, and its
    detections on the constant image with tied scores (``_tied``).

    On the constant image alone the scores are not tied (zero padding
    reaches every anchor through the receptive field): they are distinct
    values a few f32 ulps apart, which the two packages order differently,
    so the selection there is not a function of the inputs at f32."""
    jmodel = jhtc.HTC(**TINY)
    jvars = _numpy_variables(_variable_shapes(jmodel, HW))
    tied = _tied(jvars)
    proxy = _JittedApply(jmodel)
    ref, models = {}, {}
    for name, img, v in (("random", _images()["random"], jvars),
                         ("constant", _images()["constant"], tied)):
        acts = jparity.dump_jax_activations(proxy, v, jnp.asarray(img),
                                            FIXED_ROIS if name == "random" else None)
        (det,), _ = proxy.last[("capture_intermediates",)]
        ref[name] = (acts, jax.tree_util.tree_map(np.asarray, det))
        models[name] = build_htc(device="cpu", jax_variables=v, **TINY)
    return jvars, models, ref


# --- RoIAlign --------------------------------------------------------------


def _rois(rng, n, size):
    xy = rng.uniform(-0.2 * size, 1.1 * size, (n, 2))
    wh = rng.uniform(1.0, 0.8 * size, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize("out_size,scale", [(7, 0.25), (14, 0.125), (7, 1.0)])
def test_roi_align_matches_jax(out_size, scale):
    rng = np.random.default_rng(out_size)
    feat = rng.normal(size=(16, 24, 8)).astype(np.float32)
    rois = _rois(rng, 20, 24 / scale)
    rois[3] = [-30, -30, -5, -2]            # wholly off the canvas
    valid = rng.random(20) > 0.3
    got = troi.roi_align(t(feat), t(rois), t(valid), out_size, scale)
    ref = jroi.roi_align(jnp.asarray(feat), jnp.asarray(rois), jnp.asarray(valid), out_size,
                         scale)
    close(got, ref)
    assert not got[~t(valid)].any() and got[t(valid)].abs().sum() > 0


def test_map_rois_to_levels_exact():
    rng = np.random.default_rng(0)
    sides = np.asarray([1, 40, 111.9, 112, 112.1, 224, 448, 900, 0], np.float32)
    sq = np.stack([np.zeros_like(sides), np.zeros_like(sides), sides, sides], 1)
    rois = np.concatenate([sq, _rois(rng, 200, 600), [[10, 10, 5, 5]]]).astype(np.float32)
    got = troi.map_rois_to_levels(t(rois), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jroi.map_rois_to_levels(
        jnp.asarray(rois), 4)))
    assert got[:8].tolist() == [0, 0, 0, 1, 1, 2, 3, 3]


def test_multilevel_roi_align_matches_jax():
    rng = np.random.default_rng(2)
    strides = (4, 8, 16, 32)
    feats = [rng.normal(size=(384 // s, 640 // s, 8)).astype(np.float32) for s in strides]
    xy = rng.uniform(-20, 600, (40, 2))
    side = np.exp(rng.uniform(np.log(8), np.log(500), (40, 2)))
    rois = np.concatenate([xy, xy + side], 1).astype(np.float32)
    valid = rng.random(40) > 0.2
    got = troi.multilevel_roi_align([t(f) for f in feats], strides, t(rois), t(valid), 7)
    ref = jroi.multilevel_roi_align([jnp.asarray(f) for f in feats], strides,
                                    jnp.asarray(rois), jnp.asarray(valid), 7)
    close(got, ref)
    assert len(set(troi.map_rois_to_levels(t(rois), 4)[t(valid)].tolist())) >= 3


# --- DCN -------------------------------------------------------------------


@pytest.mark.parametrize("stride,groups,modulated", [(1, 1, False), (2, 1, True),
                                                     (1, 4, True), (2, 4, False)])
def test_deform_conv2d_matches_jax(stride, groups, modulated):
    rng = np.random.default_rng(stride * 10 + groups)
    n, h, w, cin, cout, k = 2, 9, 11, 8, 12, 3
    ho, wo = (h + 2 - k) // stride + 1, (w + 2 - k) // stride + 1
    x = rng.normal(size=(n, h, w, cin)).astype(np.float32)
    # fractional offsets of a few pixels: many samples between pixels, some off the map
    off = (1.5 * rng.normal(size=(n, ho, wo, 2 * k * k))).astype(np.float32)
    off[0, 0, 0, :2] = [-7.5, 3.25]
    wgt = (rng.normal(size=(k, k, cin // groups, cout)) / 5).astype(np.float32)
    bias = rng.normal(size=cout).astype(np.float32)
    mask = rng.uniform(0, 1, (n, ho, wo, k * k)).astype(np.float32) if modulated else None
    ref = jdcn.deform_conv2d(jnp.asarray(x), jnp.asarray(off), jnp.asarray(wgt),
                             None if mask is None else jnp.asarray(mask), stride=stride,
                             padding=1, bias=jnp.asarray(bias), groups=groups)
    got = tdcn.deform_conv2d(t(x).permute(0, 3, 1, 2), t(off).permute(0, 3, 1, 2),
                             t(wgt).permute(3, 2, 0, 1),
                             None if mask is None else t(mask).permute(0, 3, 1, 2),
                             stride, 1, t(bias), groups)
    ref = np.asarray(ref)
    got = got.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, atol=F32_TOL * np.abs(ref).max(), rtol=0)


def test_deform_conv2d_chunked_rows_and_zero_offsets(monkeypatch):
    """Output rows in chunks of one give the same result; zero offsets give
    the grouped conv."""
    rng = np.random.default_rng(7)
    x = t(rng.normal(size=(2, 9, 7, 8)).astype(np.float32))
    wgt = t(rng.normal(size=(6, 3, 3, 3)).astype(np.float32))
    off = t(rng.normal(size=(2, 18, 4, 4)).astype(np.float32))
    whole = tdcn.deform_conv2d(x, off, wgt, stride=2, groups=3)
    monkeypatch.setattr(tdcn, "SAMPLE_BYTES", 1)
    close(tdcn.deform_conv2d(x, off, wgt, stride=2, groups=3), whole.numpy(), 1e-6)
    zero = tdcn.deform_conv2d(x, torch.zeros_like(off), wgt, stride=2, groups=3)
    close(zero, torch.nn.functional.conv2d(x, wgt, stride=2, padding=1, groups=3).numpy())


def test_dcn_offsets_conv_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 9, 11, 8)).astype(np.float32)
    w_off = rng.normal(size=(3, 3, 8, 27)).astype(np.float32) / 8
    b_off = rng.normal(size=27).astype(np.float32)
    off, m = tdcn.dcn_offsets_conv(t(x).permute(0, 3, 1, 2), t(w_off).permute(3, 2, 0, 1),
                                   t(b_off), 3, stride=2)
    roff, rm = jdcn.dcn_offsets_conv(jnp.asarray(x), jnp.asarray(w_off), jnp.asarray(b_off), 3,
                                     stride=2)
    close(off.permute(0, 2, 3, 1), roff)
    close(m.permute(0, 2, 3, 1), rm)


# --- box code and the semantic head's resize -------------------------------


def test_anchors_exact_and_decode_matches_jax():
    for s in thtc.RPN_STRIDES:
        np.testing.assert_array_equal(thtc.base_anchors(s).numpy(), np.asarray(jhtc.base_anchors(s)))
        np.testing.assert_array_equal(thtc.level_anchors(s, 3, 5).numpy(),
                                      np.asarray(jhtc.level_anchors(s, 3, 5)))
    rng = np.random.default_rng(4)
    rois = _rois(rng, 64, 160)
    deltas = rng.normal(size=(64, 4)).astype(np.float32)
    deltas[:8, 2:] = [[30.0, -30.0]] * 8     # past the max ratio |log(16/1000)|
    for stds in ((1.0, 1.0, 1.0, 1.0),) + thtc.STAGE_STDS:
        got = thtc.delta_decode(t(rois), t(deltas), stds, HW)
        ref = jhtc.delta_decode(jnp.asarray(rois), jnp.asarray(deltas), stds, HW)
        close(got, ref)
    assert thtc.STAGE_STDS == jhtc.HTC.stage_stds


@pytest.mark.parametrize("src", [(24, 40), (6, 10), (3, 5), (2, 3)])
def test_semantic_resize_matches_jax_image_resize(src):
    """Every pyramid level of a 96 × 160 image to P3 (12 × 20): P2 shrinks
    (antialiased), P4–P6 grow, P6 (2 × 3) by a factor that does not divide."""
    rng = np.random.default_rng(src[0])
    f = rng.normal(size=(1, *src, 5)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(f), (1, 12, 20, 5), "bilinear")
    got = torch.nn.functional.interpolate(t(f).permute(0, 3, 1, 2), size=(12, 20),
                                          mode="bilinear", align_corners=False, antialias=True)
    close(got.permute(0, 2, 3, 1), ref)


def test_stable_topk_keeps_the_lower_index_first():
    x = jnp.asarray([-1, .5, -1, -1, .7, -1, .5], jnp.float32)
    _, ref = jax.lax.top_k(x, 7)
    _, got = thtc.stable_topk(t(np.asarray(x)), 7)
    assert got.tolist() == np.asarray(ref).tolist() == [4, 1, 6, 0, 2, 3, 5]


# --- the tiny HTC ----------------------------------------------------------


# --- weights ---------------------------------------------------------------


# --- mask generation --------------------------------------------------------


def test_resize_bilinear_u8_is_pils():
    rng = np.random.default_rng(0)
    sizes = [(28, 28), (28, 5), (5, 28), (1, 1), (56, 28), (14, 14), (299, 1), (1, 299)]
    sizes += [tuple(int(v) for v in rng.integers(1, 300, 2)) for _ in range(150)]
    for w, h in sizes:
        m = (rng.random((28, 28)) ** 3 * 255).astype(np.uint8)
        ref = np.asarray(Image.fromarray(m).resize((w, h), Image.BILINEAR))
        np.testing.assert_array_equal(gm.resize_bilinear_u8(m, w, h), ref, err_msg=str((w, h)))


def _tool():
    spec = importlib.util.spec_from_file_location(
        "generate_masks_tool", os.path.join(REPO, "tools", "generate_masks.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool
