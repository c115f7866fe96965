"""FSD's IoU branch, multi-task decode and strict load against the JAX package
on the CPU: tests of ``test_torch_fsd_parts.py``, at its tolerances. A file
of at most five tests, so that xdist's ``--dist loadfile`` (files with more
tests first) queues it behind ``tests/test_train.py``, the run's longest
file.
"""
import dataclasses
import functools
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fullysparsefusion_tpu.config import HeadConfig as JHeadConfig
from fullysparsefusion_tpu.config import NUSC_CLASS_NAMES, NUSC_GROUPS
from fullysparsefusion_tpu.config import tiny_fsd_config as j_tiny_fsd_config
from fullysparsefusion_tpu.models import heads as jh
from fullysparsefusion_tpu_torch.config import HeadConfig, tiny_fsd_config
from fullysparsefusion_tpu_torch.models import heads as th
from fullysparsefusion_tpu_torch.weights import build_fsd, from_jax_variables
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)
from test_torch_fsd_parts import (HEAD_KW, _head_inputs, _iou_branch_case, _jax_variable_shapes,
                                  pallas_nms)
from test_torch_losses import _close, _eq, _gts, _t


@pytest.mark.parametrize("tasks", [NUSC_GROUPS, (NUSC_CLASS_NAMES,)],
                         ids=["six_tasks", "one_task"])
def test_multi_task_get_bboxes_matches_jax(pallas_nms, tasks):
    _, (xyz, qb, qv), cls, reg, _ = _head_inputs(7, tasks=tasks)
    got = th.multi_task_get_bboxes([_t(a) for a in cls], [_t(a) for a in reg], _t(xyz),
                                   _t(qb), _t(qv), 2, HeadConfig(**HEAD_KW), tasks,
                                   NUSC_CLASS_NAMES)
    ref = jax.jit(functools.partial(jh.multi_task_get_bboxes, batch_size=2,
                                    cfg=JHeadConfig(**HEAD_KW), tasks=tasks,
                                    class_names=NUSC_CLASS_NAMES))(
        [jnp.asarray(a) for a in cls], [jnp.asarray(a) for a in reg], jnp.asarray(xyz),
        jnp.asarray(qb), jnp.asarray(qv))
    assert got.valid.shape == (2, len(tasks) * HEAD_KW["max_num"])
    _eq(got.valid, ref.valid), _eq(got.labels, ref.labels)
    _close(got.boxes, ref.boxes), _close(got.scores, ref.scores)
    labels = got.labels[got.valid]
    assert (labels >= 0).all() and len(labels.unique()) >= 6
    if len(tasks) > 1:      # task t's slots carry only task t's global classes
        tables = th.task_label_tables(NUSC_CLASS_NAMES, tasks)[1]
        per = got.labels.reshape(2, len(tasks), -1)
        for t_, table in enumerate(tables):
            lab = per[:, t_][got.valid.reshape(2, len(tasks), -1)[:, t_]]
            assert set(lab.tolist()) <= set(table)


@pytest.mark.parametrize("mode", ["iou", "dist"])
def test_iou_branch_head_loss_and_gradients_match_jax(mode):
    """The head's forward, every loss term and the gradient of the summed
    loss with respect to the head's parameters. In "iou" mode the labels
    come from the detached decoded predictions, as the JAX package's
    ``stop_gradient`` makes them."""
    cfg_kw, feats, valid, gt_arrays, xyz = _iou_branch_case(mode)
    names = ("a", "b", "c")
    jhead = jh.SparseClusterHead(cfg=JHeadConfig(**cfg_kw), tasks=(names,), class_names=names)
    params = jhead.init(jax.random.key(0), jnp.asarray(feats), jnp.asarray(valid), False)["params"]
    batch = np.zeros(len(xyz), np.int32)
    jgt, tgt = _gts(gt_arrays)

    def jloss(p):
        o = jhead.apply({"params": p}, jnp.asarray(feats), jnp.asarray(valid), False)
        losses = jh.cluster_head_loss(o["cls_logits"][0], o["reg_preds"][0], jnp.asarray(xyz),
                                      jnp.asarray(batch), jnp.asarray(valid), jgt,
                                      JHeadConfig(**cfg_kw), iou_logits=o["iou_logits"][0])
        return sum(v for k, v in losses.items() if "loss" in k), (o, losses)

    (_, (jo, jl)), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    head = th.SparseClusterHead(HeadConfig(**cfg_kw), (names,), names)
    head.load_state_dict(from_jax_variables({"params": params}), strict=True)
    o = head(_t(feats), _t(valid))
    for k in ("cls_logits", "reg_preds", "iou_logits"):
        _close(o[k], jo[k][0])
        _close(o[f"{k}_tasks"][0], jo[k][0])
    losses = th.cluster_head_loss(o["cls_logits"], o["reg_preds"], _t(xyz), _t(batch),
                                  _t(valid), tgt, HeadConfig(**cfg_kw),
                                  iou_logits=o["iou_logits"])
    assert set(losses) == set(jl) and "loss_iou" in losses and "loss_corner" in losses
    for k in jl:
        _close(losses[k], jl[k])
    assert float(losses["num_pos"]) >= 4
    sum(v for k, v in losses.items() if "loss" in k).backward()
    ref = from_jax_variables({"params": jgrad})
    for n, p in head.named_parameters():
        scale = max(1.0, float(np.abs(ref[n].numpy()).max()))
        _close(p.grad, ref[n], scale=scale)
    assert float(head.SeparateHead_0.MLP_5.Dense_0.weight.grad.abs().sum()) > 0


def test_build_fsd_loads_a_jax_tree_strictly_with_the_iou_branch():
    """Six tasks with the IoU branch: flax's names (``SegmentorCore_0``,
    ``VoteSegHead_0``, ``SeparateHead_{t}``, the ``iou`` attr's ``MLP_5``)
    come out letter for letter, every leaf maps. (``test_torch_fsd.py``
    loads the trees of one and six tasks without it.)"""
    jcfg = j_tiny_fsd_config(tasks=NUSC_GROUPS)
    jcfg = dataclasses.replace(jcfg, head=dataclasses.replace(jcfg.head, with_iou=True))
    cfg = tiny_fsd_config(tasks=NUSC_GROUPS)
    cfg = dataclasses.replace(cfg, head=dataclasses.replace(cfg.head, with_iou=True))
    shapes = _jax_variable_shapes(jcfg)
    jvars = jax.tree_util.tree_map(lambda s: np.full(s.shape, 0.5, np.float32), shapes)
    model = build_fsd(cfg, device="cpu", jax_variables=jvars)
    assert set(from_jax_variables(jvars)) == set(model.state_dict())
    heads = [n for n, _ in model.query_branch.bbox_head.named_children()]
    assert heads == ["MLP_0"] + [f"SeparateHead_{t}" for t in range(6)]
    score = model.query_branch.bbox_head.SeparateHead_5.MLP_4
    assert score.Dense_2.out_features == len(NUSC_GROUPS[5])
    assert hasattr(model.query_branch.bbox_head.SeparateHead_0, "MLP_5")
    short = dict(jvars, params={k: v for k, v in jvars["params"].items() if k != "segmentor"})
    with pytest.raises(RuntimeError, match="segmentor"):
        build_fsd(cfg, device="cpu", jax_variables=short)
    assert not model.training
