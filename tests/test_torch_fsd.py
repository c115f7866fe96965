"""The port's LiDAR-only ``SingleStageFSD`` against the JAX package's on the
CPU: forward, losses, decode and training, for the tiny config with one
task of every class and with the six nuScenes class-group tasks, the JAX
variable tree carried across by ``weights.from_jax_variables`` with
``strict=True``.

Each configuration compiles one JAX train step per module (a module-scoped
fixture; XLA's backend optimisation is turned down for these compiles,
which only moves the reference by float rounding):

* ``one_task``: eval-form BN, the detection weight an argument, run at 1
  and at 0: forward, the loss dict and ``get_bboxes``; at weight 0 the
  cluster head's gradients (the only ones this compile takes) are exactly
  0 on both sides. In the same compile the
  JAX package's FSD train forward (``fsd_forward_fn``, train-form BN),
  against which the port's ``train_step`` is held on its losses and the BN
  statistics it leaves;
* ``six_tasks``: eval-form BN, ``value_and_grad`` of the summed loss and
  the JAX package's AdamW (``parallel.train.make_optimizer``, the segmentor
  core at 0.2): forward, the loss dict with its ``task{t}_`` keys, the
  gradient tree, the parameters after the step and ``get_bboxes``.

A train-form step flips LiDAR-branch decisions under ulp noise (bf16 UNet
activations renormalised by BN), so the detection terms and the gradient
tree are held in eval form only; the train-form step is held on the
segmentor's losses and every BN statistic. Every
UNet conv takes the gather path on both sides (``test_torch_train.py``
says why), and the port's side runs one thread, as the parallel test
workers would otherwise contend for the cores.

Tolerances (as ``test_torch_train.py``):

* integers and bools (validity, cluster counts, labels, ``num_pos``): equal;
* f32 outputs and losses through the bf16 chain: ``BF16_CHAIN_TOL`` 4e-3;
* BN statistics: ``STATS_TOL`` 1e-5;
* gradients: ``LEAF_TOL`` 5e-2 relative L2 per leaf, ``TOTAL_TOL`` 1e-2 over
  the tree;
* parameters after AdamW: ``OPT_TOL`` 1e-6 (``test_torch_train.py``'s,
  there for equal gradients), except entries whose gradient is near 0,
  which AdamW's first step moves by up to lr either way: at most
  ``OPT_FLIP_SHARE`` 0.1 % of all entries [5.4e-4], each within 2 · lr.
"""
import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch

from fixtures import make_scene
from fullysparsefusion_tpu.config import NUSC_GROUPS
from fullysparsefusion_tpu.config import tiny_fsd_config as j_tiny_fsd_config
from fullysparsefusion_tpu.models.fsd import SingleStageFSD as JFSD
from fullysparsefusion_tpu.parallel import train as jtrain
from fullysparsefusion_tpu_torch import synthetic as S
from fullysparsefusion_tpu_torch.config import tiny_fsd_config
from fullysparsefusion_tpu_torch.parallel import train as T
from fullysparsefusion_tpu_torch.train.hooks import RuntimeSchedule
from fullysparsefusion_tpu_torch.weights import build_fsd, from_jax_variables
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)
from test_torch_fsf import FAST_COMPILE, _numpy_variables

BF16_CHAIN_TOL = 4e-3
STATS_TOL = 1e-5
LEAF_TOL = 5e-2
TOTAL_TOL = 1e-2
OPT_TOL = 1e-6
OPT_FLIP_SHARE = 1e-3
CORE = "segmentor.SegmentorCore_0"
LR_RULES = {CORE: 0.2}
SCENE = dict(seed=0, boxes_per_sample=5)


def _gather_only(cfg):
    seg = dataclasses.replace(cfg.segmentor, unet_dense_min_occupancy=2.0)
    return dataclasses.replace(cfg, segmentor=seg)


def _np(x):
    return x.detach().float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


def _check(name, ref, got, tol):
    ref = np.asarray(ref)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    if ref.dtype == bool or np.issubdtype(ref.dtype, np.integer):
        np.testing.assert_array_equal(got, ref, err_msg=name)
    else:
        np.testing.assert_allclose(got, ref, rtol=tol,
                                   atol=tol * max(1.0, float(np.abs(ref).max(initial=0))),
                                   err_msg=name)


def _inputs(tasks):
    """Both packages' configs, the JAX scene and model, numpy weights, and
    the port's scene (the same arrays)."""
    jcfg = _gather_only(j_tiny_fsd_config(tasks=tasks))
    cfg = _gather_only(tiny_fsd_config(tasks=tasks))
    jpb, jgt = make_scene(n_cap=jcfg.caps.points, max_gt=jcfg.caps.max_gt, **SCENE)
    model = JFSD(cfg=jcfg)
    shapes = jax.eval_shape(lambda k: model.init(k, jpb, 2, None, False), jax.random.key(0))
    jvars = _numpy_variables(shapes)
    sc = S.make_scene_arrays(n_cap=cfg.caps.points, max_gt=cfg.caps.max_gt, **SCENE)
    tpb, tgt = S.to_point_batch(sc, device="cpu"), S.to_ground_truth(sc, device="cpu")
    return jcfg, cfg, model, jvars, (jpb, jgt), (tpb, tgt)


def _jax_bboxes(model, variables, out):
    return model.apply(variables, out, 2, method=JFSD.get_bboxes)


@pytest.fixture(scope="module")
def one_task():
    """One task of every class: eval-form BN at detection weights 1 and 0
    (forward, losses, the cluster head's gradients, ``get_bboxes``), and the
    JAX package's FSD train forward (``fsd_forward_fn``: train-form BN,
    losses and updated statistics) against the port's ``train_step``."""
    jcfg, cfg, model, jvars, (jpb, jgt), (tpb, tgt) = _inputs(None)
    train_forward = jtrain.fsd_forward_fn(model, 2)

    def run(params, stats, det_weight):
        def loss_fn(head):
            branch = dict(params["query_branch"], bbox_head=head)
            p = dict(params, query_branch=branch)
            out = model.apply({"params": p, "batch_stats": stats}, jpb, 2, jgt, False, 0.0,
                              det_weight)
            return jtrain.total_loss(out["losses"]), out

        # the gradient of the cluster head's parameters only
        (loss, out), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params["query_branch"]["bbox_head"])
        det = _jax_bboxes(model, {"params": params, "batch_stats": stats}, out)
        return loss, out, grads, train_forward(params, stats, jpb, jgt, 0.0, det_weight), det

    step = jax.jit(run, compiler_options=FAST_COMPILE)
    ref = {w: jax.tree_util.tree_map(np.asarray, step(jvars["params"], jvars["batch_stats"], w))
           for w in (1.0, 0.0)}
    jdet = ref[1.0][4]
    got, det, train = _one_task_port(cfg, jvars, tpb, tgt)
    return dict(jvars=jvars, ref=ref, jdet=jdet, got=got, det=det, train=train)


def _one_task_port(cfg, jvars, tpb, tgt):
    """The port's side of ``one_task``: eval-form forward + backward at
    detection weights 1 and 0, ``get_bboxes``, one ``train_step``."""
    got = {}
    for w in (1.0, 0.0):
        m = build_fsd(cfg, device="cpu", jax_variables=jvars)
        out = m(tpb, 2, tgt, train=False, detection_weight=w)
        loss = T.total_loss(out["losses"])
        loss.backward()
        got[w] = (loss, out, m)
    with torch.no_grad():
        det = got[1.0][2].get_bboxes(got[1.0][1], 2)
    m = build_fsd(cfg, device="cpu", jax_variables=jvars)
    opt = T.make_optimizer(m, base_lr=1e-4, total_steps=100, lr_mult_rules=LR_RULES)
    step_loss, step_losses, _ = T.train_step(m, opt, RuntimeSchedule(), T.Batch(tpb, None, tgt,
                                                                              None), 0)
    return got, det, (step_loss, step_losses, m)


@pytest.fixture(scope="module")
def six_tasks():
    """The six nuScenes group tasks, eval-form BN: one step of the summed
    loss's gradient and the JAX package's AdamW."""
    jcfg, cfg, model, jvars, (jpb, jgt), (tpb, tgt) = _inputs(NUSC_GROUPS)
    tx = jtrain.make_optimizer(base_lr=1e-4, total_steps=100, lr_mult_rules=LR_RULES)

    def run(params, stats):
        def loss_fn(p):
            out = model.apply({"params": p, "batch_stats": stats}, jpb, 2, jgt, False)
            return jtrain.total_loss(out["losses"]), out

        (loss, out), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, _ = tx.update(grads, tx.init(params), params)
        det = _jax_bboxes(model, {"params": params, "batch_stats": stats}, out)
        return loss, out, grads, optax.apply_updates(params, updates), det

    jloss, jout, jgrads, jparams, jdet = jax.tree_util.tree_map(
        np.asarray, jax.jit(run, compiler_options=FAST_COMPILE)(jvars["params"],
                                                                jvars["batch_stats"]))
    port = _six_task_port(cfg, jvars, tpb, tgt)
    return dict(jvars=jvars, jloss=jloss, jout=jout, jgrads=jgrads, jparams=jparams, jdet=jdet,
                **port)


def _six_task_port(cfg, jvars, tpb, tgt):
    """The port's side of ``six_tasks``: eval-form forward + backward,
    ``get_bboxes``, one AdamW step."""
    m = build_fsd(cfg, device="cpu", jax_variables=jvars)
    opt = T.make_optimizer(m, base_lr=1e-4, total_steps=100, lr_mult_rules=LR_RULES)
    out = m(tpb, 2, tgt, train=False)
    loss = T.total_loss(out["losses"])
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in m.named_parameters()}
    with torch.no_grad():
        det = m.get_bboxes(out, 2)
    T.optimizer_step(opt, 0)
    return dict(model=m, out=out, loss=loss, grads=grads, det=det)


def _forward_outputs(o, tasks):
    """The compared forward outputs, named."""
    res = {f"seg_out.{k}": o["seg_out"][k]
           for k in ("seg_logits", "vote_preds", "offsets", "valid")}
    res.update({k: o[k] for k in ("cluster_xyz", "cluster_batch", "cluster_group",
                                  "cluster_valid", "num_clusters", "num_fg_points")})
    for t in range(tasks):
        res[f"cls_logits.{t}"] = o["cls_logits_tasks"][t]
        res[f"reg_preds.{t}"] = o["reg_preds_tasks"][t]
    return res


def _check_forward(ref, got, tasks):
    ref, got = _forward_outputs(ref, tasks), _forward_outputs(got, tasks)
    for name in ref:
        _check(name, ref[name], got[name], BF16_CHAIN_TOL)
    assert int(ref["num_clusters"]) >= 4


def _check_losses(ref, got):
    assert set(ref) == set(got)
    for k in ref:
        if "num_pos" in k or "recall" in k:
            assert float(got[k]) == float(ref[k]), k
        else:
            _check(k, ref[k], got[k], BF16_CHAIN_TOL)


def _check_bboxes(ref, got):
    for f in ("valid", "labels", "boxes", "scores"):
        _check(f"det.{f}", getattr(ref, f), getattr(got, f), BF16_CHAIN_TOL)
    assert int(got.valid.sum()) > 0


def test_one_task_forward_and_losses_match_jax(one_task):
    jloss, out, _, _, _ = one_task["ref"][1.0]
    loss, got, _ = one_task["got"][1.0]
    _check_forward(out, got, 1)
    _check("cls_logits", out["cls_logits"], got["cls_logits"], BF16_CHAIN_TOL)
    _check_losses(out["losses"], got["losses"])
    assert "loss_cls" in got["losses"] and not any("task" in k for k in got["losses"])
    assert float(got["losses"]["num_pos"]) > 0
    _check("total", jloss, loss, BF16_CHAIN_TOL)


def test_one_task_train_form_step_losses_and_bn_statistics_match_jax(one_task):
    """The port's ``train_step`` (train-form BN, AdamW) against the JAX
    package's FSD train forward: the segmentor's loss terms and every BN
    statistic the step leaves. The detection terms are not held here: in
    train form an ulp apart in the bf16 UNet moves foreground scores across
    their threshold (on this scene 23 foreground points in the port against
    19, 11 clusters against 9, ``loss_cls`` 5.9 % apart, the segmentor terms
    5e-5); the eval-form cases hold them."""
    jlosses, jstats = one_task["ref"][1.0][3]
    loss, losses, m = one_task["train"]
    assert set(jlosses) == set(losses)
    for k in ("loss_sem_seg", "loss_vote"):
        _check(k, jlosses[k], losses[k], BF16_CHAIN_TOL)
    assert all(np.isfinite(float(v)) for v in losses.values()) and np.isfinite(float(loss))
    ref = from_jax_variables({"batch_stats": jstats})
    sd = m.state_dict()
    assert len(ref) > 10
    for k, v in ref.items():
        _check(k, v.numpy(), sd[k], STATS_TOL)
    old = from_jax_variables({"batch_stats": one_task["jvars"]["batch_stats"]})
    assert any(not torch.equal(sd[k], old[k]) for k in ref)


def test_one_task_get_bboxes_matches_jax(one_task):
    _check_bboxes(one_task["jdet"], one_task["det"])


def test_detection_weight_zero_leaves_the_head_without_gradient_in_both(one_task):
    """At weight 0 every head term is 0 and the cluster head's gradients
    are exactly 0, in both packages; the segmentor terms are weight 1's."""
    jloss, out, jgrads, _, _ = one_task["ref"][0.0]
    loss, got, m = one_task["got"][0.0]
    _check_losses(out["losses"], got["losses"])
    for k, v in got["losses"].items():
        if "loss" in k and k not in ("loss_sem_seg", "loss_vote"):
            assert float(v.detach()) == 0.0 and float(out["losses"][k]) == 0.0, k
    jhead = from_jax_variables({"params": {"query_branch": {"bbox_head": jgrads}}})
    head = {n: p for n, p in m.named_parameters() if n.startswith("query_branch.bbox_head.")}
    assert head and set(head) == {k for k in jhead if k.startswith("query_branch.bbox_head.")}
    for n, p in head.items():
        assert not jhead[n].any(), n
        assert p.grad is None or not p.grad.any(), n
    seg = m.segmentor.VoteSegHead_0.Dense_0.weight.grad
    assert float(seg.abs().sum()) > 0


def test_six_task_forward_matches_jax(six_tasks):
    _check_forward(six_tasks["jout"], six_tasks["out"], 6)
    assert "cls_logits" not in six_tasks["out"]
    for t, names in enumerate(NUSC_GROUPS):
        assert six_tasks["out"]["cls_logits_tasks"][t].shape[1] == len(names)


def test_six_task_losses_match_jax(six_tasks):
    got = six_tasks["out"]["losses"]
    _check_losses(six_tasks["jout"]["losses"], got)
    assert {k.split("_")[0] for k in got if k.startswith("task")} == {f"task{t}" for t in range(6)}
    assert sum(float(got[f"task{t}_num_pos"]) > 0 for t in range(6)) >= 2
    _check("total", six_tasks["jloss"], six_tasks["loss"], BF16_CHAIN_TOL)


def test_six_task_gradient_tree_matches_jax(six_tasks):
    ref = from_jax_variables({"params": six_tasks["jgrads"]})
    grads = six_tasks["grads"]
    assert set(ref) == set(grads)
    num = den = 0.0
    for k, g in ref.items():
        got = grads[k]
        d, n = float((got - g).norm()), float(g.norm())
        assert d <= LEAF_TOL * n + 1e-6, (k, d / max(n, 1e-12))
        num, den = num + d * d, den + n * n
    assert (num / den) ** 0.5 <= TOTAL_TOL
    for t in range(6):
        assert float(grads[f"query_branch.bbox_head.SeparateHead_{t}.MLP_4.Dense_2.weight"]
                     .abs().sum()) > 0, t


def test_six_task_parameters_after_adamw_match_jax(six_tasks):
    """The parameters after one step of the JAX package's AdamW and of the
    port's. The first AdamW step is ~lr · g / (|g| + eps) per entry, so an
    entry whose gradient is near 0 can step by up to lr either way while the
    gradients agree: every entry within ``OPT_TOL`` + 2 · lr · mult, and at
    most ``OPT_FLIP_SHARE`` of all entries beyond ``OPT_TOL``."""
    ref = from_jax_variables({"params": six_tasks["jparams"]})
    start = from_jax_variables({"params": six_tasks["jvars"]["params"]})
    params = dict(six_tasks["model"].named_parameters())
    assert set(ref) == set(params)
    moved, off, total = {}, 0, 0
    for k, v in ref.items():
        lr = 1e-4 * (LR_RULES[CORE] if k.startswith(CORE) else 1.0)
        diff = (params[k].detach() - v).abs()
        assert float(diff.max()) <= OPT_TOL + 2 * lr, k
        off, total = off + int((diff > OPT_TOL).sum()), total + diff.numel()
        moved[k] = float((v - start[k]).abs().max())
    assert off <= OPT_FLIP_SHARE * total
    assert max(v for k, v in moved.items() if k.startswith(CORE)) < \
        max(v for k, v in moved.items() if k.startswith("query_branch."))


def test_six_task_get_bboxes_matches_jax(six_tasks):
    det = six_tasks["det"]
    _check_bboxes(six_tasks["jdet"], det)
    assert det.valid.shape == (2, 6 * six_tasks["model"].cfg.head.max_num)
