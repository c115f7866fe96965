"""The tiny two-stage FSD's forward, losses, gradients and decode against the
JAX package on the CPU, and its strict load: tests of
``test_torch_two_stage.py``, at its tolerances. A file of at most five
tests, so that xdist's ``--dist loadfile`` (files with more tests first)
queues it behind ``tests/test_train.py``, the run's longest file.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fullysparsefusion_tpu.config import tiny_fsd_config as j_tiny_fsd_config
from fullysparsefusion_tpu.models.two_stage import TwoStageFSD as JTwoStage
from fullysparsefusion_tpu.utils.containers import PointBatch as JPB
from fullysparsefusion_tpu_torch import synthetic as S
from fullysparsefusion_tpu_torch.config import NUSC_GROUPS, tiny_fsd_config
from fullysparsefusion_tpu_torch.models.two_stage import TwoStageFSD
from fullysparsefusion_tpu_torch.weights import build_two_stage_fsd, from_jax_variables
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)
from test_torch_fsd import _check
from test_torch_two_stage import (BF16_CHAIN_TOL, LEAF_TOL, ROI_HEAD, TOTAL_TOL,
                                  _forward_outputs, two_stage)


def test_two_stage_forward_and_losses_match_jax(two_stage):
    jloss, jout, _, _ = two_stage["ref"][1.0]
    loss, out, _, _ = two_stage["got"][1.0]
    ref, got = _forward_outputs(jout), _forward_outputs(out)
    for name in ref:
        _check(name, ref[name], got[name], BF16_CHAIN_TOL)
    assert int(ref["num_clusters"]) >= 4 and int(np.asarray(ref["rcnn.nonempty"]).sum()) >= 4
    jl, tl = jout["losses"], out["losses"]
    assert set(jl) == set(tl) and {"rcnn_loss_cls", "rcnn_loss_reg", "rcnn_num_pos"} <= set(tl)
    for k in jl:
        if "num_pos" in k or "recall" in k:
            assert float(tl[k]) == float(jl[k]), k
        else:
            _check(k, jl[k], tl[k], BF16_CHAIN_TOL)
    _check("total", jloss, loss, BF16_CHAIN_TOL)


def test_two_stage_gradient_tree_matches_jax(two_stage):
    _, _, jgrads, _ = two_stage["ref"][1.0]
    ref = from_jax_variables({"params": jgrads})
    grads = two_stage["got"][1.0][2]
    assert set(ref) == set(grads)
    num = den = 0.0
    for k, g in ref.items():
        d, n = float((grads[k] - g).norm()), float(g.norm())
        assert d <= LEAF_TOL * n + 1e-6, (k, d / max(n, 1e-12))
        num, den = num + d * d, den + n * n
    assert (num / den) ** 0.5 <= TOTAL_TOL
    assert float(grads["roi_head.MLP_0.Dense_2.weight"].abs().sum()) > 0
    assert float(grads["roi_head.FullySparseBboxHead_0.SIRLayer_0.MLP_0.Dense_0.weight"]
                 .abs().sum()) > 0


def test_two_stage_get_bboxes_matches_jax(two_stage):
    jdet, det = two_stage["ref"][1.0][3], two_stage["got"][1.0][3]
    for f in ("valid", "labels", "boxes", "scores"):
        _check(f"det.{f}", getattr(jdet, f), getattr(det, f), BF16_CHAIN_TOL)
    assert det.valid.shape == (2, tiny_fsd_config().head.max_num) and int(det.valid.sum()) > 0


def test_two_stage_detection_weight_zero_leaves_the_roi_head_without_gradient(two_stage):
    """At weight 0 every detection term is 0 and the ``roi_head``'s
    gradients are exactly 0 in both packages; the segmentor's terms are
    weight 1's."""
    _, jout, jgrads, _ = two_stage["ref"][0.0]
    _, out, grads, _ = two_stage["got"][0.0]
    for k, v in out["losses"].items():
        if "loss" in k and k not in ("loss_sem_seg", "loss_vote"):
            assert float(v.detach()) == 0.0 and float(jout["losses"][k]) == 0.0, k
    ref = from_jax_variables({"params": jgrads})
    head = [k for k in grads if k.startswith(ROI_HEAD)]
    assert len(head) > 20
    for k in head:
        assert not ref[k].any() and not grads[k].any(), k
    for k in ("loss_sem_seg", "loss_vote"):
        _check(k, two_stage["ref"][1.0][1]["losses"][k], out["losses"][k], BF16_CHAIN_TOL)


def test_build_two_stage_fsd_loads_a_jax_tree_strictly():
    """flax's names (``rpn``, ``roi_head``, ``FullySparseBboxHead_0``,
    ``MLP_0`` / ``MLP_1``) come out letter for letter and every leaf maps;
    a tree without the ``roi_head`` is refused, and so is a multi-task
    first stage."""
    jcfg, cfg = j_tiny_fsd_config(), tiny_fsd_config()
    sc = S.make_scene_arrays(seed=0, n_cap=jcfg.caps.points, max_gt=jcfg.caps.max_gt)
    jpb = JPB(points=jnp.asarray(sc["points"]), batch_idx=jnp.asarray(sc["batch_idx"]),
              valid=jnp.asarray(sc["valid"]))
    shapes = jax.eval_shape(lambda k: JTwoStage(cfg=jcfg).init(k, jpb, 2, None, False),
                            jax.random.key(0))
    jvars = jax.tree_util.tree_map(lambda s: np.full(s.shape, 0.5, np.float32), shapes)
    model = build_two_stage_fsd(cfg, device="cpu", jax_variables=jvars)
    assert set(from_jax_variables(jvars)) == set(model.state_dict())
    assert [n for n, _ in model.named_children()] == ["rpn", "roi_head"]
    assert [n for n, _ in model.roi_head.named_children()] == [
        "FullySparseBboxHead_0", "MLP_0", "MLP_1"]
    assert model.roi_head.MLP_0.Dense_2.out_features == cfg.num_classes
    assert model.roi_head.MLP_1.Dense_2.out_features == cfg.head.code_size
    short = dict(jvars, params={k: v for k, v in jvars["params"].items() if k != "roi_head"})
    with pytest.raises(RuntimeError, match="roi_head"):
        build_two_stage_fsd(cfg, device="cpu", jax_variables=short)
    with pytest.raises(ValueError, match="one task"):
        TwoStageFSD(tiny_fsd_config(tasks=NUSC_GROUPS))
    assert not model.training
