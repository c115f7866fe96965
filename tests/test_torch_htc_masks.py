"""HTC's mask generation against the JAX package's mask tool on the CPU, the
full-depth tree's mapping and the flax initialisation: tests of
``test_torch_htc.py``, at its tolerances. A file of at most five tests, so
that xdist's ``--dist loadfile`` (files with more tests first) queues it
behind ``tests/test_train.py``, the run's longest file.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from PIL import Image
from fullysparsefusion_tpu.data.masks import reorg_anno as j_reorg_anno
from fullysparsefusion_tpu.models import htc as jhtc
from fullysparsefusion_tpu_torch import generate_masks as gm
from fullysparsefusion_tpu_torch.models import htc as thtc
from fullysparsefusion_tpu_torch.weights import build_htc, jax_state_items
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)
from test_torch_fsf import FAST_COMPILE
from test_torch_htc import TAP_TOL, TINY, TOOL_TINY, _tool, _variable_shapes, tiny


def test_full_depth_tree_maps_onto_the_default_htc():
    """Every key and shape of the default HTC's JAX tree (from
    ``eval_shape``, no arrays built) is the port's default ``HTC``'s, which
    has 135M–150M parameters."""
    shapes = _variable_shapes(jhtc.HTC(), (64, 64))
    zeros = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), shapes)
    mapped = {k: tuple(v.shape) for k, v in jax_state_items(zeros)}
    with torch.device("meta"):
        model = thtc.HTC()
    assert mapped == {k: tuple(v.shape) for k, v in model.state_dict().items()}
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert 135e6 < n < 150e6, n


def test_init_parameters_follows_flax_distributions():
    """Seeded init: DCN offset branches 0, BN the identity, and each weight
    family's spread that of its flax initializer."""
    model = build_htc(seed=0, device="cpu", **TINY)
    dcn = model.backbone.layer2_0.conv2
    assert not dcn.conv_offset.weight.any() and not dcn.conv_offset.bias.any()
    bn = model.backbone.layer2_0.bn2
    assert bool((bn.weight == 1).all() and (bn.running_var == 1).all() and not bn.bias.any())
    for w, std in ((dcn.weight, (2.0 / (dcn.weight.shape[0] * 9)) ** 0.5),
                   (model.mask_head0.upsample.weight, (2.0 / 1024) ** 0.5),
                   (model.neck.fpn0.weight, (1.0 / (256 * 9)) ** 0.5),
                   (model.bbox_head0.fc1.weight, (1.0 / 12544) ** 0.5)):
        assert abs(float(w.detach().std()) / std - 1) < 0.05, (w.shape, std)


def test_sample_masks_match_the_jax_htc_backend(tiny):
    """Two 64 × 96 cameras through the tool's ``jax-htc`` backend (its model
    set to the tiny tree and a jitted apply, so it skips its eager init) +
    ``paint_sample``, and through the port's ``paste_detections`` +
    ``paint_sample`` + ``reorg_anno``, at ``score_thr`` 0."""
    jvars, _, _ = tiny
    rng = np.random.default_rng(5)
    images = rng.integers(0, 255, (2, 64, 96, 3), dtype=np.uint8)
    tool = _tool()
    apply = jax.jit(lambda v, im: jhtc.HTC(**TOOL_TINY).apply(v, im),
                    compiler_options=FAST_COMPILE)
    tool._JAX_HTC = (jvars, apply)
    jdets = tool.backend_jax_htc(list(images), score_thr=0.0)
    jplanes, jannos = tool.paint_sample(jdets, 2, 10, (64, 96))

    model = build_htc(device="cpu", jax_variables=jvars, **TOOL_TINY)
    dets = gm.paste_detections(gm.run_htc(model, images), (64, 96), score_thr=0.0)
    assert len(dets) == len(jdets) == 16
    # where a mask may differ: PIL's value of the tool's own map at 127 or 128
    loose = []
    for cam in range(2):
        (jd,) = apply(jvars, jnp.asarray(gm.pad_images(images[cam:cam + 1])))
        for j in range(8):
            x1, y1, x2, y2 = np.asarray(jd.boxes)[j]
            bw, bh = max(int(round(x2 - x1)), 1), max(int(round(y2 - y1)), 1)
            m28 = Image.fromarray((np.asarray(jd.masks)[j] * 255).astype(np.uint8))
            v = np.asarray(m28.resize((bw, bh), Image.BILINEAR)).astype(int)
            loose.append(((v == 127) | (v == 128), (int(round(y1)), int(round(x1)))))
    differs = np.zeros((2, 64, 96), bool)
    for d, jd, (lo, (yy, xx)) in zip(dets, jdets, loose):
        assert (d["cam_id"], d["category"], d["offset"]) == (jd["cam_id"], jd["category"], (yy, xx))
        np.testing.assert_allclose(d["bbox"], jd["bbox"], atol=TAP_TOL * 96)
        assert abs(d["score"] - jd["score"]) <= TAP_TOL
        full = np.zeros((64, 96), bool)
        full[yy:yy + d["mask"].shape[0], xx:xx + d["mask"].shape[1]] = d["mask"]
        allowed = np.zeros((64, 96), bool)
        sub = lo[: max(0, 64 - yy), : max(0, 96 - xx)]
        allowed[yy:yy + sub.shape[0], xx:xx + sub.shape[1]] = sub
        diff = full != jd["mask"]
        assert not (diff & ~allowed).any()
        differs[d["cam_id"]] |= diff
    planes, annos = gm.paint_sample(dets, 2, 10, (64, 96))
    jarr = np.zeros_like(planes)
    for (cam, cls), m in jplanes.items():
        jarr[cam, :, :, cls] = m
    np.testing.assert_array_equal(planes[~differs], jarr[~differs])
    assert (planes > 0).any() and differs.mean() < 0.01
    print("mask pixels that differ from the tool's:", int(differs.sum()))
    anno, janno = gm.reorg_anno(annos), j_reorg_anno(jannos)
    np.testing.assert_array_equal(anno[:, 5:], janno[:, 5:])
    np.testing.assert_allclose(anno[:, :5], janno[:, :5], atol=TAP_TOL * 96)


def test_sample_masks_end_to_end_shapes(tiny):
    jvars, _, _ = tiny
    model = build_htc(device="cpu", jax_variables=jvars, **TOOL_TINY)
    images = np.random.default_rng(6).integers(0, 255, (2, 50, 70, 3), dtype=np.uint8)
    planes, anno = gm.sample_masks(model, images, score_thr=0.0)
    assert planes.shape == (2, 50, 70, 10) and planes.dtype == np.uint8
    assert anno.shape == (250, 9) and int(anno[:, 8].sum()) == 16
    ids = np.unique(planes)
    assert ids[0] == 0 and set(ids[1:].tolist()) <= set(range(1, 17))
