"""The tiny FSF's scene, UNet paths, decode and cluster head on identical
inputs against the JAX package on the CPU, and the strict load: tests of
``test_torch_fsf.py``'s fixture, at its tolerances. A file of at most five
tests, so that xdist's ``--dist loadfile`` (files with more tests first)
queues it behind ``tests/test_train.py``, the run's longest file.
"""
import numpy as np
import pytest
import torch

from fullysparsefusion_tpu_torch.weights import build_fsf, from_jax_variables
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)
from test_torch_fsf import F32_TOL, _check, parity


def test_scene_is_not_vacuous(parity):
    out, det = parity["out"], parity["det"]
    assert int(out["frustum"]["obj_valid"].sum()) > 0          # camera queries
    assert int(out["fsd"]["num_clusters"]) > 0                  # LiDAR clusters
    assert int(det.valid.sum()) > 0                             # detections
    # the camera scores reach the point features through the enhancement MLP
    assert float(parity["model"].seg_enhance_mlp.Dense_1.weight.detach().abs().sum()) > 0


def test_unet_took_gather_and_dense_paths(parity):
    """Stages 0-1 run the gather conv (9 convs), stage 2 the dense conv3d (2 convs)."""
    assert parity["counts"] == dict(gather=9, dense=2)


def test_decode_on_identical_inputs_matches_jax(parity):
    """get_bboxes fed JAX's own final queries: no bf16 on the way."""
    fin = {k: torch.from_numpy(np.array(v)) for k, v in parity["jout"]["final"].items()}
    det = parity["model"].get_bboxes(dict(final=fin), 2)
    for f in ("valid", "labels", "boxes", "scores"):
        _check(f"det.{f}", getattr(parity["jdet"], f), getattr(det, f), F32_TOL)


def test_cluster_head_on_identical_inputs_matches_jax(parity):
    fsd = parity["jout"]["fsd"]
    out = parity["model"].fsd_branch.bbox_head(torch.from_numpy(np.array(fsd["obj_feat"])),
                                               torch.from_numpy(np.array(fsd["cluster_valid"])))
    _check("cls_logits", fsd["cls_logits"], out["cls_logits"], F32_TOL)
    _check("reg_preds", fsd["reg_preds"], out["reg_preds"], F32_TOL)


def test_from_jax_variables_is_strict(parity):
    sd = from_jax_variables(parity["jvars"])
    assert set(sd) == set(parity["model"].state_dict())
    extra = dict(parity["jvars"], params=dict(parity["jvars"]["params"], stray={"w": np.zeros(3)}))
    with pytest.raises(RuntimeError, match="stray"):
        build_fsf(parity["cfg"], device="cpu", jax_variables=extra)
    odd = dict(parity["jvars"], params=dict(parity["jvars"]["params"], odd={"gamma": np.zeros(3)}))
    with pytest.raises(KeyError, match="unmapped"):
        from_jax_variables(odd)
    short = dict(parity["jvars"], params={k: v for k, v in parity["jvars"]["params"].items()
                                          if k != "seg_head"})
    with pytest.raises(RuntimeError, match="seg_head"):
        build_fsf(parity["cfg"], device="cpu", jax_variables=short)
