"""The tiny AV2-shaped FSF's decode, cluster head and eval-form losses against
the JAX package on the CPU: tests of ``test_torch_av2.py``'s fixture, at its
tolerances. A file of at most five tests, so that xdist's ``--dist
loadfile`` (files with more tests first) queues it behind
``tests/test_train.py``, the run's longest file.
"""
import numpy as np
import torch

from test_torch_av2 import BF16_CHAIN_TOL, F32_TOL, LOSS_TOL, _hold_losses, parity
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)
from test_torch_fsf import _check, _task0


def test_av2_get_bboxes_matches_jax(parity):
    jdet, det = parity["jdet"], parity["det"]
    for f in ("valid", "labels", "boxes", "scores"):
        _check(f"det.{f}", getattr(jdet, f), getattr(det, f), BF16_CHAIN_TOL)


def test_av2_decode_on_identical_inputs_matches_jax(parity):
    """26-class decode + NMS fed JAX's own final queries: no bf16 on the way."""
    fin = {k: torch.from_numpy(np.array(v)) for k, v in parity["jout"]["final"].items()}
    det = parity["model"].get_bboxes(dict(final=fin), 2)
    for f in ("valid", "labels", "boxes", "scores"):
        _check(f"det.{f}", getattr(parity["jdet"], f), getattr(det, f), F32_TOL)


def test_av2_cluster_head_on_identical_inputs_matches_jax(parity):
    fsd = parity["jout"]["fsd"]
    with torch.no_grad():
        out = parity["model"].fsd_branch.bbox_head(
            torch.from_numpy(np.array(fsd["obj_feat"])),
            torch.from_numpy(np.array(fsd["cluster_valid"])))
    _check("cls_logits", _task0(fsd["cls_logits"]), out["cls_logits"], F32_TOL)
    _check("reg_preds", _task0(fsd["reg_preds"]), out["reg_preds"], F32_TOL)


def test_av2_scene_is_not_vacuous(parity):
    out, det = parity["out"], parity["det"]
    fsd = out["fsd"]
    groups = fsd["cluster_group"][fsd["cluster_valid"]].unique()
    assert len(groups) >= 2, groups                              # clusters in two groups
    assert int(out["frustum"]["obj_valid"].sum()) > 0            # camera queries
    assert int(det.valid.sum()) > 0                              # detections


def test_av2_losses_match_jax(parity):
    """Eval-form BN: the port's own forward takes JAX's decisions, so every
    loss term is held."""
    jl, tl = parity["jout"]["losses"], parity["out"]["losses"]
    assert set(jl) == set(tl)
    assert not any("vel" in k for k in tl)                       # code size 8
    _hold_losses(jl, tl, LOSS_TOL)
    assert float(tl["fsd_num_pos"]) > 0 and float(tl["stage0_num_pos"]) > 0
