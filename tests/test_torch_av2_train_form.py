"""The tiny AV2-shaped FSF's train-form losses and the AV2 bench scene's UNet
stage counts against the JAX package on the CPU: tests of
``test_torch_av2.py``, at its tolerances. A file of at most five tests, so
that xdist's ``--dist loadfile`` (files with more tests first) queues it
behind ``tests/test_train.py``, the run's longest file.
"""
import types

import jax
import jax.numpy as jnp
import torch

from fixtures import make_lidar_scene
from fullysparsefusion_tpu import config as jcfg
from fullysparsefusion_tpu.ops import sparse_conv as jsc
from fullysparsefusion_tpu.ops import voxelize as jvox
from fullysparsefusion_tpu_torch import config as tcfg
from fullysparsefusion_tpu_torch import synthetic as S
from fullysparsefusion_tpu_torch.ops import sparse_conv as tsc
from fullysparsefusion_tpu_torch.ops import voxelize as tvox
from test_torch_av2 import (AV2_STAGE_CAPS, F32_TOL, LOSS_TOL, _hold_losses, _same,
                            _stage_counts, parity)
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)


def test_av2_bench_scene_and_stage_counts_match_jax():
    """The JAX package's AV2 bench scene, made by both packages, and its
    UNet stages' true active sets (no stage clipped at the bench's caps).
    The JAX side voxelizes under ``jax.jit``, as its model and its bench's
    ``--probe`` do: XLA folds the division by the voxel size into a product
    with its reciprocal, and stage 1 then has the bench's recorded 101,419
    voxels (``tools/bench_av2.py:39``); JAX's op-by-op division puts two
    more points' voxels across an edge (101,421)."""
    sc, cam = S.make_av2_scene_arrays(0)
    assert cam["masks"].shape == (1, 7, 1024, 775, 26) and int(cam["anno"][0, :, 8].sum()) > 0
    del cam
    pb, gt = make_lidar_scene(seed=0, n_cap=131072, max_gt=128, n_boxes=48, num_classes=26,
                              point_dim=4, extent=190.0, n_rings=64, pts_per_ring=1600,
                              n_walls=48, sweeps=2)
    for k, v in (("points", pb.points), ("valid", pb.valid), ("gt_boxes", gt.boxes),
                 ("gt_labels", gt.labels), ("gt_valid", gt.valid)):
        _same(sc[k], v)
    cfg, caps = tcfg.av2_fsf_config(), (98304, 163840, 163840, 131072, 65536)
    tpb = dict(xyz=torch.from_numpy(sc["points"][:, :3].copy()),
               batch_idx=torch.from_numpy(sc["batch_idx"]), valid=torch.from_numpy(sc["valid"]))
    jpb = dict(xyz=pb.xyz, batch_idx=pb.batch_idx, valid=pb.valid)
    got = _stage_counts(tvox, tsc, torch, tpb, cfg, caps)
    jitted = types.SimpleNamespace(
        voxelize_points=jax.jit(jvox.voxelize_points, static_argnums=(3, 4, 5)),
        grid_dims=jvox.grid_dims)
    assert got == _stage_counts(jitted, jsc, jnp, jpb, jcfg.av2_fsf_config(), caps)
    assert got == [47281, 101419, 119199, 73537, 22712]
    assert all(c < cap for c, cap in zip(got, AV2_STAGE_CAPS))


def test_av2_train_form_losses_on_jax_outputs_match_jax(parity):
    """Train-form BN: every term, from the JAX forward's own outputs."""
    jl, tl = parity["jtout"]["losses"], parity["recomputed"]
    assert set(jl) == set(tl)
    assert not any("vel" in k for k in tl)
    _hold_losses(jl, tl, F32_TOL)


def test_av2_train_form_forward_losses_match_jax(parity):
    """Train-form BN, the port's own forward: the terms upstream of the
    LiDAR branch's foreground decision (see the module docstring)."""
    jl, tl = parity["jtout"]["losses"], parity["tout"]["losses"]
    assert set(jl) == set(tl)
    held = [k for k in jl if k.startswith(("loss_", "frustum_"))]
    assert len(held) == 8
    _hold_losses(jl, tl, LOSS_TOL, held)
