"""The cluster head's losses against the JAX package on the CPU: a test of
``test_torch_losses.py``, at its tolerances. A file of at most five tests,
so that xdist's ``--dist loadfile`` (files with more tests first) queues it
behind ``tests/test_train.py``, the run's longest file.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from fullysparsefusion_tpu.config import HeadConfig as JHeadConfig
from fullysparsefusion_tpu.models import heads as jh
from fullysparsefusion_tpu_torch.config import HeadConfig
from fullysparsefusion_tpu_torch.models import heads as th
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)
from test_torch_losses import _close, _eq, _gt_arrays, _gts, _queries, _t


@pytest.mark.parametrize("variant", ["in_box", "given_assign", "corner", "code8", "empty_gt"])
def test_cluster_head_loss_matches_jax(variant):
    arrays = _gt_arrays(17, n_valid=(0, 0) if variant == "empty_gt" else (5, 3))
    jgt, tgt = _gts(arrays)
    xyz, qb, qv = _queries(18, _gt_arrays(17)[0])
    q = len(xyz)
    code = 8 if variant == "code8" else 10
    rng = np.random.default_rng(19)
    cls = rng.normal(0, 2, (q, 10)).astype(np.float32)
    reg = rng.normal(0, 0.5, (q, code)).astype(np.float32)
    kw = dict(code_size=code, with_corner_loss=variant == "corner")
    assign = None
    if variant == "given_assign":
        assign = rng.integers(-1, 16, q).astype(np.int32)
        assign[~arrays[2].reshape(-1)[assign.clip(0)]] = -1
    got = th.cluster_head_loss(_t(cls), _t(reg), _t(xyz), _t(qb), _t(qv), tgt, HeadConfig(**kw),
                               assign=None if assign is None else _t(assign), prefix="p_")
    ref = jh.cluster_head_loss(jnp.asarray(cls), jnp.asarray(reg), jnp.asarray(xyz),
                               jnp.asarray(qb), jnp.asarray(qv), jgt, JHeadConfig(**kw),
                               assign=None if assign is None else jnp.asarray(assign),
                               prefix="p_")
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k], ref[k])
    if variant != "empty_gt":
        assert float(got["p_num_pos"]) > 0
    _eq(th.assign_clusters_in_box(_t(xyz), _t(qb), _t(qv), tgt),
        jh.assign_clusters_in_box(jnp.asarray(xyz), jnp.asarray(qb), jnp.asarray(qv), jgt))
