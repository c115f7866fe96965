"""``models/fsd.group_sample`` of the port against the JAX package's with a
non-zero ``thresh_buffer`` of each sign (the decayed threshold of the
detection-enable hook), on numpy inputs made from a seed.

The JAX side gets the buffer as a traced f32 scalar under ``jax.jit``, as
its train step passes it; the port gets a Python float. Foreground masks
must be equal (integer decisions); voted centers are f32 sums of the same
products, 1e-6.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fullysparsefusion_tpu.config import tiny_fsf_config as j_tiny_fsf_config
from fullysparsefusion_tpu.models.fsd import group_sample as j_group_sample
from fullysparsefusion_tpu_torch.config import tiny_fsf_config
from fullysparsefusion_tpu_torch.models.fsd import group_sample
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)


def _inputs(seed, p=600, c=10):
    rng = np.random.default_rng(seed)
    return dict(
        seg_logits=rng.normal(0.0, 1.5, (p, c + 1)).astype(np.float32),
        offsets=rng.normal(0.0, 1.0, (p, (c + 1) * 3)).astype(np.float32),
        xyz=rng.uniform(-20.0, 20.0, (p, 3)).astype(np.float32),
        valid=rng.random(p) > 0.1,
        batch_idx=rng.integers(0, 2, p).astype(np.int32),
    )


@pytest.mark.parametrize("buffer", [-0.03, 0.04])
def test_group_sample_thresh_buffer_matches_jax(buffer):
    x = _inputs(7)
    j_fn = jax.jit(functools.partial(j_group_sample, cfg=j_tiny_fsf_config().fsd, batch_size=2))
    j_fg, j_centers = j_fn(*(jnp.asarray(x[k]) for k in ("seg_logits", "offsets", "xyz", "valid")),
                           thresh_buffer=jnp.float32(buffer),
                           batch_idx=jnp.asarray(x["batch_idx"]))
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    cfg = tiny_fsf_config().fsd
    fg, centers = group_sample(t["seg_logits"], t["offsets"], t["xyz"], t["valid"], cfg,
                               thresh_buffer=buffer, batch_idx=t["batch_idx"], batch_size=2)
    fg0, _ = group_sample(t["seg_logits"], t["offsets"], t["xyz"], t["valid"], cfg,
                          batch_idx=t["batch_idx"], batch_size=2)
    assert len(fg) == len(j_fg) == len(cfg.group_class_ids())
    moved = 0
    for g in range(len(fg)):
        np.testing.assert_array_equal(fg[g].numpy(), np.asarray(j_fg[g]))
        np.testing.assert_allclose(centers[g].numpy(), np.asarray(j_centers[g]), rtol=1e-6,
                                   atol=1e-6)
        moved += int((fg[g] != fg0[g]).sum())
    assert moved > 0                              # the buffer changed some decisions
