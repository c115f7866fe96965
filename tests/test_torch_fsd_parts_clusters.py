"""FSD's hybrid clustering and its world-size-one sharded step against the JAX
package on the CPU: tests of ``test_torch_fsd_parts.py``, at its tolerances.
A file of at most five tests, so that xdist's ``--dist loadfile`` (files
with more tests first) queues it behind ``tests/test_train.py``, the run's
longest file.
"""
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from fullysparsefusion_tpu.config import NUSC_GROUPS
from fullysparsefusion_tpu.config import tiny_fsd_config as j_tiny_fsd_config
from fullysparsefusion_tpu.models import fsd as jfsd
from fullysparsefusion_tpu_torch.config import tiny_fsd_config
from fullysparsefusion_tpu_torch.models import fsd as tfsd
from fullysparsefusion_tpu_torch.parallel import train as T
from fullysparsefusion_tpu_torch.train.hooks import RuntimeSchedule
from fullysparsefusion_tpu_torch.weights import build_fsd
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)
from test_torch_fsd_parts import _centers, _fsd_batch
from test_torch_losses import _eq, _t


@pytest.mark.parametrize("method", ["ssg", "ccl"])
@pytest.mark.parametrize("batch_size", [1, 3])
def test_hybrid_cluster_one_group_matches_jax(method, batch_size):
    jcfg = j_tiny_fsd_config()
    cfg = tiny_fsd_config()
    xyz, b, valid = _centers(2, batch=batch_size)
    kw = dict(method=method, num_fps=32, radius=1.0, batch_size=batch_size)
    labelled = 0
    for g in (0, 4):
        lab, ok = tfsd.hybrid_cluster_one_group(_t(xyz), _t(b), _t(valid), g, cfg, **kw)
        jlab, jok = jfsd.hybrid_cluster_one_group(jnp.asarray(xyz), jnp.asarray(b),
                                                  jnp.asarray(valid), g, jcfg, **kw)
        _eq(lab, jlab), _eq(ok, jok)
        assert lab.dtype == torch.int32
        labelled += int((lab >= 0).sum())
        if batch_size > 1:       # labels of different samples never collide
            for s in range(batch_size):
                mine = set(lab[(_t(b) == s) & (lab >= 0)].tolist())
                other = set(lab[(_t(b) != s) & (lab >= 0)].tolist())
                assert not mine & other
    assert labelled > 20


def test_fsd_sharded_train_step_at_world_size_one_equals_train_step_bitwise(tmp_path):
    """``sharded_train_step`` under a gloo group of world size 1 in this
    process, against ``train_step`` from the same state: losses, gradient
    norm, parameters and BN buffers bitwise equal."""
    cfg = tiny_fsd_config(tasks=NUSC_GROUPS)
    state = build_fsd(cfg, seed=0, device="cpu").state_dict()
    batch = _fsd_batch(cfg)
    out = {}
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
                            rank=0, world_size=1)
    try:
        for name, group in (("train_step", None), ("sharded", dist.group.WORLD)):
            model = build_fsd(cfg, device="cpu")
            model.load_state_dict(state)
            opt = T.make_optimizer(model, total_steps=10,
                                   lr_mult_rules={"segmentor.SegmentorCore_0": 0.2})
            loss, losses, gnorm = T.sharded_train_step(model, opt, RuntimeSchedule(), batch, 0,
                                                       group)
            out[name] = (float(loss), {k: float(v) for k, v in losses.items()}, float(gnorm),
                         model.state_dict())
    finally:
        dist.destroy_process_group()
    a, b = out["train_step"], out["sharded"]
    assert a[:3] == b[:3]
    assert any(k.startswith("task5_") for k in a[1]) and a[1]["task1_num_pos"] > 0
    for k, v in a[3].items():
        assert torch.equal(v, b[3][k]), k
    assert not torch.equal(a[3]["segmentor.VoteSegHead_0.Dense_0.weight"],
                           state["segmentor.VoteSegHead_0.Dense_0.weight"])
