"""The rotated-NMS ops against the JAX package on the CPU: tests of
``test_torch_ops.py``, at its tolerances. A file of at most five tests, so
that xdist's ``--dist loadfile`` (files with more tests first) queues it
behind ``tests/test_train.py``, the run's longest file.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from fullysparsefusion_tpu.ops.nms import multiclass_nms_bev as j_multiclass_nms_one
from fullysparsefusion_tpu.ops.nms import multiclass_nms_bev_batched as j_multiclass_nms
from fullysparsefusion_tpu.ops.nms import nms_bev_mask as j_nms_bev_mask
from fullysparsefusion_tpu_torch.ops import nms
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)
from test_torch_kernels import _boxes, t
from test_torch_ops import close, eq


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
