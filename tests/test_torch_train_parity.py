"""The tiny FSF's train-form forward, losses, BN statistics and gradient tree
against the JAX package's train step on the CPU: tests of
``test_torch_train.py``'s fixture, at its tolerances. A file of at most five
tests, so that xdist's ``--dist loadfile`` (files with more tests first)
queues it behind ``tests/test_train.py``, the run's longest file.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from fullysparsefusion_tpu.core.assigners import hybrid_assign as j_hybrid_assign
from fullysparsefusion_tpu_torch.core.assigners import hybrid_assign
from fullysparsefusion_tpu_torch.utils.containers import PointBatch
from fullysparsefusion_tpu_torch.weights import from_jax_variables
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)
from test_torch_train import F32_TOL, LEAF_TOL, LOSS_TOL, STATS_TOL, TOTAL_TOL, _close, _t, parity


def test_loss_dict_matches_jax(parity):
    jl, tl = parity["jout"]["losses"], parity["out"]["losses"]
    assert set(jl) == set(tl)
    assert any(k.startswith(p) for k in tl for p in ("frustum_", "fsd_", "stage0_"))
    for k in jl:
        if "num_pos" in k or "recall" in k:
            assert float(tl[k]) == float(jl[k]), k
        else:
            _close(tl[k], jl[k], LOSS_TOL)
    _close(parity["loss"], parity["jloss"], LOSS_TOL)
    assert float(tl["fsd_num_pos"]) > 0 and float(tl["stage0_num_pos"]) > 0


def test_train_forward_integer_outputs_and_assignments_match_jax(parity):
    jo, to = parity["jout"], parity["out"]
    for name, a, b in (
            ("seg valid", jo["seg_out"]["valid"], to["seg_out"]["valid"]),
            ("obj_valid", jo["frustum"]["obj_valid"], to["frustum"]["obj_valid"]),
            ("cluster_valid", jo["fsd"]["cluster_valid"], to["fsd"]["cluster_valid"]),
            ("num_fg_points", jo["fsd"]["num_fg_points"], to["fsd"]["num_fg_points"]),
            ("q_batch", jo["final"]["q_batch"], to["final"]["q_batch"])):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    # the refinement stage's hybrid assignment, each side on its own outputs
    st_j, st_t = jo["stages"][0], to["stages"][0]
    fr_j, fr_t = jo["frustum"], to["frustum"]
    c = parity["model"].cfg
    pad = np.zeros((c.caps.clusters, 9), np.float32)
    ja = j_hybrid_assign(
        jnp.asarray(st_j["centers"]), jnp.asarray(jo["final"]["q_batch"]),
        jnp.asarray(jo["final"]["q_valid"]),
        jnp.concatenate([jnp.asarray(fr_j["preds_2d"]), pad]), parity["jgt"], parity["jgt"],
        parity["jcam"].lidar2img, parity["jcam"].img_w, parity["jcam"].img_h,
        query_logits=jnp.asarray(st_j["cls_logits"]), max_dist_per_class=c.refine_max_dist)
    ta = hybrid_assign(
        st_t["centers"].detach(), to["final"]["q_batch"], to["final"]["q_valid"],
        torch.cat([fr_t["preds_2d"], torch.from_numpy(pad)]), parity["tgt"], parity["tgt"],
        parity["tcam"].lidar2img, parity["tcam"].img_w, parity["tcam"].img_h,
        query_logits=st_t["cls_logits"].detach(), max_dist_per_class=c.refine_max_dist)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert (ta >= 0).sum() >= 2


def test_losses_on_the_jax_forward_outputs_match_jax(parity):
    """The port's loss functions fed the JAX forward's own outputs: no bf16
    chain between them, so f32 within F32_TOL."""
    jo = parity["jout"]
    tt = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), jo)
    tt["frustum"]["out"] = {k: v[0] for k, v in tt["frustum"]["out"].items()}
    jpb = parity["jpb"]
    pb_inner = PointBatch(points=_t(jpb.points[:, :-3]), batch_idx=_t(jpb.batch_idx),
                          valid=_t(jpb.valid))
    got = parity["model"]._losses(pb_inner, parity["tcam"], parity["tgt"], parity["tgt"], tt)
    assert set(got) == set(jo["losses"])
    for k, v in jo["losses"].items():
        _close(got[k], v, F32_TOL)


def test_updated_batch_stats_match_jax(parity):
    ref = from_jax_variables({"batch_stats": parity["jstats"]})
    sd = parity["model"].state_dict()
    assert len(ref) > 20
    for k, v in ref.items():
        _close(sd[k], v, STATS_TOL)
    # the statistics moved: the train form updated them
    old = from_jax_variables({"batch_stats": parity["jvars"]["batch_stats"]})
    assert any(not torch.equal(sd[k], old[k]) for k in ref)


def test_gradient_tree_matches_jax(parity):
    ref = from_jax_variables({"params": parity["jgrads"]})
    params = dict(parity["model"].named_parameters())
    assert set(ref) == set(params)
    num = den = 0.0
    for k, g in ref.items():
        got = params[k].grad
        assert got is not None and got.shape == g.shape, k
        d, n = float((got - g).norm()), float(g.norm())
        assert d <= LEAF_TOL * n + 1e-6, (k, d / max(n, 1e-12))
        num, den = num + d * d, den + n * n
    assert (num / den) ** 0.5 <= TOTAL_TOL
