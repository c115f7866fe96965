"""The port's six-task ``SingleStageFSD`` (the six nuScenes class-group
tasks) against the JAX package's on the CPU, with the helpers, inputs and
tolerances of ``test_torch_fsd.py``.

``six_tasks`` compiles one JAX step per module: eval-form BN,
``value_and_grad`` of the summed loss and the JAX package's AdamW
(``parallel.train.make_optimizer``, the segmentor core at 0.2): forward,
the loss dict with its ``task{t}_`` keys, the gradient tree, the
parameters after the step and ``get_bboxes``. A file of its own so that
each file holds at most five tests (``test_torch_fsd.py`` says why).
"""
import jax
import numpy as np
import optax
import pytest
import torch

from fullysparsefusion_tpu.config import NUSC_GROUPS
from fullysparsefusion_tpu.parallel import train as jtrain
from fullysparsefusion_tpu_torch.parallel import train as T
from fullysparsefusion_tpu_torch.weights import build_fsd, from_jax_variables
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)
from test_torch_fsd import (BF16_CHAIN_TOL, CORE, LEAF_TOL, LR_RULES, OPT_FLIP_SHARE, OPT_TOL,
                            TOTAL_TOL, _check, _check_bboxes, _check_forward, _check_losses,
                            _inputs, _jax_bboxes)
from test_torch_fsf import FAST_COMPILE


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
