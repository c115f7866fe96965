"""Two ranks' gradients, BN statistics and an all-invalid rank against the JAX
package's two-device ``shard_map`` step on the CPU: tests of
``test_torch_ddp.py``'s fixture, at its tolerances. A file of at most five
tests, so that xdist's ``--dist loadfile`` (files with more tests first)
queues it behind ``tests/test_train.py``, the run's longest file.
"""
import numpy as np
import pytest

from fullysparsefusion_tpu_torch.weights import from_jax_variables
from test_torch_ddp import (CASES, HELD, LEAF_TOL, LOSS_TOL, STATS_TOL, TOTAL_TOL, _close, mesh2,
                            parity)
from test_torch_ddp_port import DETECTION_HEADS
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("case", HELD)
def test_two_ranks_gradient_tree_matches_jax_shard_map(parity, case):
    jres, tres = parity["jax"], parity["port"]
    ref = from_jax_variables({"params": jres[case][2]})
    r0, r1 = tres[case]
    assert set(ref) == set(r0["grads"])
    num = den = 0.0
    for k, g in ref.items():
        got, g = r0["grads"][k], g.numpy()
        assert np.array_equal(got, r1["grads"][k]), k
        d, n = float(np.linalg.norm(got - g)), float(np.linalg.norm(g))
        assert d <= LEAF_TOL * n + 1e-6, (k, d / max(n, 1e-12))
        num, den = num + d * d, den + n * n
    assert (num / den) ** 0.5 <= TOTAL_TOL
    if CASES[case][0] == 0.0:
        heads = [k for k in ref if k.startswith(DETECTION_HEADS)]
        assert len(heads) > 20
        for k in heads:
            assert not ref[k].any() and not r0["grads"][k].any(), k


@pytest.mark.parametrize("case", HELD)
def test_two_ranks_updated_batch_stats_match_jax_shard_map(parity, case):
    jvars, jres, tres = parity["jvars"], parity["jax"], parity["port"]
    ref = from_jax_variables({"batch_stats": jres[case][3]})
    old = from_jax_variables({"batch_stats": jvars["batch_stats"]})
    r0, r1 = tres[case]
    assert len(ref) > 20
    for k, v in ref.items():
        assert np.array_equal(r0["buffers"][k], r1["buffers"][k]), k
        _close(r0["buffers"][k], v.numpy(), STATS_TOL, k)
    assert any(not np.array_equal(r0["buffers"][k], old[k].numpy()) for k in ref)


def test_rank_with_an_all_invalid_scene_finishes_with_the_jax_losses_and_statistics(parity):
    jvars, jres, tres = parity["jvars"], parity["jax"], parity["port"]
    jloss, jl, jgrads, jstats = jres["rank_all_invalid"]
    r0, r1 = tres["rank_all_invalid"]
    assert r0["losses"] == r1["losses"] and set(r0["losses"]) == set(jl)
    for k in jl:
        if "loss" in k:
            _close(r0["losses"][k], jl[k], LOSS_TOL, k)
    assert r0["losses"]["loss_sem_seg"] > 0
    _close(r0["total"], jloss, LOSS_TOL, "total")
    for k, g in r0["grads"].items():
        assert np.isfinite(g).all() and np.array_equal(g, r1["grads"][k]), k
    for k, v in from_jax_variables({"batch_stats": jstats}).items():
        assert np.array_equal(r0["buffers"][k], r1["buffers"][k]), k
        _close(r0["buffers"][k], v.numpy(), STATS_TOL, k)
