"""The tiny HTC tap by tap and end to end against the JAX package on the CPU,
and its strict load: tests of ``test_torch_htc.py``'s fixture, at its
tolerances. A file of at most five tests, so that xdist's ``--dist
loadfile`` (files with more tests first) queues it behind
``tests/test_train.py``, the run's longest file.
"""
import numpy as np
import pytest
import torch

from fullysparsefusion_tpu.utils import htc_parity as jparity
from fullysparsefusion_tpu_torch.ops import nms as tnms
from fullysparsefusion_tpu_torch.utils import htc_parity as tparity
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)
from test_torch_htc import FIXED_ROIS, HW, TAP_TOL, _images, close, t, tiny


def test_tiny_htc_taps_match_jax(tiny):
    _, models, ref = tiny
    model = models["random"]
    jacts, _ = ref["random"]
    acts = tparity.dump_torch_activations(model, t(_images()["random"]), t(FIXED_ROIS))
    assert set(acts) == set(jacts) == set(tparity.ACTIVATION_ORDER)
    errs = {}
    for k in tparity.ACTIVATION_ORDER:
        a, b = jacts[k], acts[k]
        assert a.shape == b.shape, k
        errs[k] = float(np.abs(a - b).max()) / float(np.abs(a).max())
    assert max(errs.values()) <= TAP_TOL, {k: v for k, v in errs.items() if v > TAP_TOL}
    print("worst tap error / magnitude:", max(errs.items(), key=lambda kv: kv[1]))
    # the port's report is the JAX package's, row for row
    rows = tparity.compare_activations(jacts, acts, atol=1e-3, rtol=1e-3)
    assert rows == jparity.compare_activations(jacts, acts, atol=1e-3, rtol=1e-3)
    assert tparity.first_divergent(rows) is None
    assert tparity.ACTIVATION_ORDER == jparity.ACTIVATION_ORDER


@pytest.mark.parametrize("image", ["random", "constant"])
def test_tiny_htc_forward_matches_jax(tiny, image):
    _, models, ref = tiny
    model, (_, jdet) = models[image], ref[image]
    launches = tnms.nms_keep.launches
    with torch.inference_mode():
        (det,) = model(t(_images()[image]))
    assert tnms.nms_keep.launches == launches        # CPU tensors: the plain version
    np.testing.assert_array_equal(det.valid.numpy(), jdet.valid)
    np.testing.assert_array_equal(det.labels.numpy(), jdet.labels)
    assert det.valid.any()
    close(det.boxes, jdet.boxes, TAP_TOL * max(HW))
    close(det.scores, jdet.scores, TAP_TOL)
    close(det.masks, jdet.masks, TAP_TOL)
    if image == "constant":   # tied scores, ordered by index alone
        assert len(set(det.scores.tolist())) < len(det.scores)


def test_tiny_htc_runs_both_nms_calls_through_nms_keep(tiny, monkeypatch):
    """Per image: the RPN's call (one class over the five levels' 16 +
    16 + 16 + 16 + 16 proposals) and the detections' (ten classes over the
    16 proposals, one call); every image's proposals come first, inside the
    forward's ``rpn`` span."""
    model = tiny[1]["random"]
    shapes = []
    orig = tnms.nms_keep

    def recorder(iou, order, valid_sorted, thr):
        shapes.append((tuple(order.shape), thr))
        return orig(iou, order, valid_sorted, thr)

    monkeypatch.setattr(tnms, "nms_keep", recorder)
    with torch.inference_mode():
        model(t(np.concatenate([_images()["random"]] * 2)))
    assert shapes == [((1, 80), 0.7)] * 2 + [((10, 16), 0.5)] * 2


def test_tiny_tree_loads_strict(tiny):
    jvars, models, _ = tiny
    sd = models["random"].state_dict()
    got = sd["backbone.layer2_0.conv2.conv_offset.weight"].numpy()
    ref = np.asarray(jvars["params"]["backbone"]["layer2_0"]["conv2"]["conv_offset_w"])
    np.testing.assert_array_equal(got, ref.transpose(3, 2, 0, 1))
    got = sd["mask_head1.upsample.weight"].numpy()
    ref = np.asarray(jvars["params"]["mask_head1"]["upsample_w"])
    np.testing.assert_array_equal(got, ref.transpose(2, 3, 0, 1))
