"""FSF training in the PyTorch port against the JAX package on the CPU: the
train-form BN, the sparse convs' gradients, the optimizer, and one tiny-config
train forward + backward against one JAX ``value_and_grad`` (``train=True``,
``mutable=["batch_stats"]``) with the JAX variable tree carried across by
``weights.from_jax_variables`` — the gradient tree too.

The tiny-config run takes every UNet conv through the gather path (K1's and
``dw_per_tap``'s plain versions, forward and backward) on both sides:
``unet_dense_min_occupancy`` is set above 1. On the dense path XLA's and
PyTorch's bf16 conv3d round their outputs one bf16 ulp apart here and there
(both are within an ulp of the exact sum), and the train-form BN, which
renormalises every layer to unit scale, carries those ulps deep enough to
flip a few foreground decisions of the LiDAR branch. The dense path's
gradients are compared on their own (``test_conv_gradients_match_jax``).

Tolerances (measured worst case in brackets):

* integers and bools (validity, counts, assignments, ``num_pos``): equal;
* losses of the bf16 chain: ``LOSS_TOL`` 4e-3 relative [2.3e-4];
* losses recomputed by the port from the JAX forward's own outputs:
  ``F32_TOL`` 1e-5 relative;
* updated BN running statistics: ``STATS_TOL`` 1e-5 [1.2e-6 absolute];
* gradients: ``LEAF_TOL`` 5e-2 relative L2 per leaf [2.4e-2, the RoI SIR's
  position MLP] and ``TOTAL_TOL`` 1e-2 over the whole tree [6.9e-3];
* one sparse conv's gradients: 1e-5 of the magnitude for f32 results (bf16
  products, f32 sums in another order), 4e-3 (one bf16 ulp) for bf16 ones;
* the optimizer fed the same gradients: ``OPT_TOL`` 1e-6 on the parameters.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fixtures import make_camera_data, make_scene, with_noaug_channels
from fullysparsefusion_tpu.config import tiny_fsf_config as j_tiny_fsf_config
from fullysparsefusion_tpu.core.assigners import hybrid_assign as j_hybrid_assign
from fullysparsefusion_tpu.models.fsf import FSF as JFSF
from fullysparsefusion_tpu.models.layers import MaskedBatchNorm as JMaskedBatchNorm
from fullysparsefusion_tpu.ops import sparse_conv as jsc
from fullysparsefusion_tpu.parallel import train as jtrain
from fullysparsefusion_tpu.train.hooks import RuntimeSchedule as JRuntimeSchedule
from fullysparsefusion_tpu_torch import synthetic as S
from fullysparsefusion_tpu_torch.config import tiny_fsf_config
from fullysparsefusion_tpu_torch.core.assigners import hybrid_assign
from fullysparsefusion_tpu_torch.models.layers import MaskedBatchNorm
from fullysparsefusion_tpu_torch.models.sparse_unet import SubmRulebook
from fullysparsefusion_tpu_torch.ops import sparse_conv as tsc
from fullysparsefusion_tpu_torch.parallel import train as ttrain
from fullysparsefusion_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from fullysparsefusion_tpu_torch.train.hooks import RuntimeSchedule
from fullysparsefusion_tpu_torch.utils.containers import PointBatch
from fullysparsefusion_tpu_torch.weights import build_fsf, from_jax_variables
from test_torch_fsf import FAST_COMPILE, _numpy_variables
from test_torch_sparse_conv import _active_set, _strided
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)

LOSS_TOL = 4e-3
F32_TOL = 1e-5
STATS_TOL = 1e-5
LEAF_TOL = 5e-2
TOTAL_TOL = 1e-2
K1_TOL = 1e-5
BF16_TOL = 4e-3
OPT_TOL = 1e-6
K, STRIDE, PAD = (3, 3, 3), (2, 2, 2), (1, 1, 1)


def _gather_only(cfg):
    seg = dataclasses.replace(cfg.fsd.segmentor, unet_dense_min_occupancy=2.0)
    return dataclasses.replace(cfg, fsd=dataclasses.replace(cfg.fsd, segmentor=seg))


def _np(x):
    return x.detach().float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, ref, tol):
    ref = _np(ref)
    np.testing.assert_allclose(_np(got), ref, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(ref).max(initial=0))))


@pytest.fixture(scope="module")
def parity():
    """One JAX value_and_grad of the tiny FSF (batch 2, the fixture scene,
    its own GT as gt and no-aug GT) and the port's forward + backward."""
    cfg = _gather_only(j_tiny_fsf_config())
    pb, gt = make_scene(seed=0, n_cap=cfg.caps.points, max_gt=cfg.caps.max_gt)
    cam = make_camera_data(pb, gt, num_classes=cfg.num_classes)
    pb = with_noaug_channels(pb)
    model = JFSF(cfg=cfg)
    shapes = jax.eval_shape(
        lambda k: model.init(k, pb, cam, 2, None, None, False,
                             method=lambda m, *a, **kw: m(*a, **kw)),
        jax.random.key(0))
    jvars = _numpy_variables(shapes)

    def run(params, stats):
        def loss_fn(p):
            out, upd = model.apply({"params": p, "batch_stats": stats}, pb, cam, 2, gt, gt, True,
                                   0.0, 1.0, mutable=["batch_stats"])
            return jtrain.total_loss(out["losses"]), (out, upd["batch_stats"])

        (loss, (out, new_stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return loss, out, new_stats, grads

    jloss, jout, jstats, jgrads = jax.tree_util.tree_map(
        np.asarray, jax.jit(run, compiler_options=FAST_COMPILE)(jvars["params"],
                                                                jvars["batch_stats"]))

    tcfg = _gather_only(tiny_fsf_config())
    sc = S.make_scene_arrays(seed=0, n_cap=tcfg.caps.points, max_gt=tcfg.caps.max_gt)
    camd = S.make_camera_arrays(sc["gt_boxes"], sc["gt_labels"], sc["gt_valid"],
                                num_classes=tcfg.num_classes)
    tpb, tcam = S.fsf_inputs(sc, camd, device="cpu")
    tgt = S.to_ground_truth(sc, device="cpu")
    m = build_fsf(tcfg, device="cpu", jax_variables=jvars)
    out = m(tpb, tcam, 2, tgt, tgt, train=True)
    loss = ttrain.total_loss(out["losses"])
    loss.backward()
    return dict(jvars=jvars, jloss=jloss, jout=jout, jstats=jstats, jgrads=jgrads, jgt=gt,
                jcam=cam, jpb=pb, model=m, out=out, loss=loss, tgt=tgt, tcam=tcam, tpb=tpb)


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


def test_all_branches_receive_gradient():
    """The port's version of the JAX package's test of the same name, with
    the tiny config as it is (its deep stage on the dense path)."""
    cfg = tiny_fsf_config()
    sc = S.make_scene_arrays(seed=3, n_cap=cfg.caps.points, max_gt=cfg.caps.max_gt)
    cam = S.make_camera_arrays(sc["gt_boxes"], sc["gt_labels"], sc["gt_valid"],
                               num_classes=cfg.num_classes)
    pb, cd = S.fsf_inputs(sc, cam, device="cpu")
    gt = S.to_ground_truth(sc, device="cpu")
    m = build_fsf(cfg, seed=0, device="cpu").train()
    ttrain.total_loss(m(pb, cd, 2, gt, gt)["losses"]).backward()
    must_train = [
        "frustum_head", "fsd_branch", "combine_frustum_mlp", "combine_fsd_mlp",
        "refine_sir_0", "refined_head_0", "out_proj_0", "position_encoder_0",
        "lidar_img_mlp_0", "refine_img_mlp_0", "frustum", "seg_enhance_mlp", "seg_core",
    ]
    for name in must_train:
        sub = getattr(m, name)
        norm = sum(float(p.grad.norm()) ** 2 for p in sub.parameters() if p.grad is not None)
        assert norm > 0.0, f"zero gradient reaching {name}"


# ---------------------------------------------------------------------------
# train-form BN
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["masked", "no_mask", "all_invalid", "bf16"])
def test_masked_batchnorm_train_form_matches_jax(case):
    rng = np.random.default_rng(1)
    n, c = 300, 24
    x = (rng.normal(2.0, 3.0, (n, c))).astype(np.float32)
    valid = rng.random(n) > 0.3
    if case == "all_invalid":
        valid[:] = False
    if case == "bf16":
        x = x.astype(jnp.bfloat16).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=c)).astype(np.float32)
    bias = (0.1 * rng.normal(size=c)).astype(np.float32)
    stats = dict(mean=rng.normal(size=c).astype(np.float32),
                 var=rng.uniform(0.5, 1.5, c).astype(np.float32))
    cot = rng.normal(size=(n, c)).astype(np.float32)
    jv = None if case == "no_mask" else jnp.asarray(valid)
    jx = jnp.asarray(x, jnp.bfloat16 if case == "bf16" else jnp.float32)
    bn = JMaskedBatchNorm()

    def f(params, xx):
        return bn.apply({"params": params, "batch_stats": stats}, xx, jv, True,
                        mutable=["batch_stats"])

    y, upd = f(dict(scale=scale, bias=bias), jx)
    _, vjp = jax.vjp(lambda p, xx: f(p, xx)[0], dict(scale=scale, bias=bias), jx)
    dparams, dx = vjp(jnp.asarray(cot))

    m = MaskedBatchNorm(c).train()
    m.load_state_dict({k[1:]: v for k, v in from_jax_variables(
        {"params": {"scale": scale, "bias": bias}, "batch_stats": stats}).items()})
    tx = _t(x).to(torch.bfloat16 if case == "bf16" else torch.float32).requires_grad_(True)
    ty = m(tx, None if case == "no_mask" else _t(valid))
    ty.backward(_t(cot))
    _close(ty, y, F32_TOL)
    _close(m.running_mean, upd["batch_stats"]["mean"], F32_TOL)
    _close(m.running_var, upd["batch_stats"]["var"], F32_TOL)
    _close(m.weight.grad, dparams["scale"], F32_TOL)
    _close(m.bias.grad, dparams["bias"], F32_TOL)
    _close(tx.grad, dx, BF16_TOL if case == "bf16" else F32_TOL)
    assert tx.grad.dtype == tx.dtype
    # eval form: the running statistics
    m.eval()
    ye = bn.apply({"params": {"scale": scale, "bias": bias}, "batch_stats": stats}, jx, jv, False)
    m.running_mean.copy_(_t(stats["mean"]))
    m.running_var.copy_(_t(stats["var"]))
    _close(m(tx.detach(), None), ye, F32_TOL)


# ---------------------------------------------------------------------------
# sparse conv gradients
# ---------------------------------------------------------------------------


def _conv_case(kind, dtype, cin=32, cout=48):
    """(JAX fn(feats, w) -> out, port fn(feats, w) -> out, feats, w, cotangent)."""
    jst, tst = _active_set(4, cin)
    (jc, jb, jv, jdims), (tc, tb, tv, tdims) = _strided(jst, tst)
    rng = np.random.default_rng(5)
    w = (rng.normal(size=(27, cin, cout)) / np.sqrt(27 * cin)).astype(np.float32)
    feats = np.asarray(jst.feats, np.float32)
    bf = dict(compute_dtype=jnp.bfloat16)
    if kind == "subm":
        rb = jsc.build_subm_rulebook(jst)
        rows = tsc.build_subm_rulebook(tst)

        def jf(f, ww):
            return jsc.subm_conv_apply(f, jst.valid, rb, ww, None, identity_tap=13, **bf)

        def tf(f, ww):
            return tsc.subm_conv_apply(f, tst.valid, rows, ww, tsc.plan_rulebook(rows, 512))
    elif kind == "strided":
        def jf(f, ww):
            return jsc.sparse_conv3d(jst.replace(feats=f), ww, None, K, STRIDE, PAD, 256,
                                     **bf).feats

        def tf(f, ww):
            return tsc.sparse_conv3d(tst.replace(feats=f), ww, K, STRIDE, PAD, 256).feats
    elif kind == "inverse":
        feats = (rng.normal(size=(256, cin)) * np.asarray(jv)[:, None]).astype(np.float32)
        jco = jsc.SparseTensor(feats=None, coords=jc, batch=jb, valid=jv, dims=jdims,
                               batch_size=2)
        tco = tsc.SparseTensor(feats=None, coords=tc, batch=tb, valid=tv, dims=tdims,
                               batch_size=2)

        def jf(f, ww):
            return jsc.sparse_inverse_conv3d(jco.replace(feats=f), jst.coords, jst.batch,
                                             jst.valid, jst.dims, ww, None, K, STRIDE, PAD,
                                             **bf).feats

        def tf(f, ww):
            return tsc.sparse_inverse_conv3d(tco.replace(feats=f), tst, ww, K, STRIDE, PAD).feats
    elif kind == "subm_dense":
        def jf(f, ww):
            return jsc.subm_conv_dense(jst.replace(feats=f), ww, None, K)

        def tf(f, ww):
            return tsc.subm_conv_dense(tst.replace(feats=f), ww, K)
    else:   # strided_dense
        def jf(f, ww):
            return jsc.sparse_conv3d_dense(jst.replace(feats=f), ww, None, K, STRIDE, PAD,
                                           256).feats

        def tf(f, ww):
            return tsc.sparse_conv3d_dense(tst.replace(feats=f), ww, K, STRIDE, PAD, 256).feats
    if dtype == "bf16":
        feats = feats.astype(jnp.bfloat16)
    return jf, tf, feats, w, rng


@pytest.mark.parametrize("kind,dtype", [
    ("subm", "f32"), ("subm", "bf16"), ("strided", "bf16"), ("inverse", "bf16"),
    ("subm_dense", "bf16"), ("strided_dense", "bf16")])
def test_conv_gradients_match_jax(kind, dtype):
    """d_feats and d_w of one conv against ``jax.vjp`` of the JAX package's
    (the custom VJPs on the gather path, autodiff of the dense conv)."""
    jf, tf, feats, w, rng = _conv_case(kind, dtype)
    jout, vjp = jax.vjp(jf, jnp.asarray(feats), jnp.asarray(w))
    cot = rng.normal(size=jout.shape).astype(np.float32)
    jdf, jdw = vjp(jnp.asarray(cot, jout.dtype))
    tfeats = _t(np.asarray(feats, np.float32)).to(
        torch.bfloat16 if dtype == "bf16" else torch.float32).requires_grad_(True)
    tw = _t(w).requires_grad_(True)
    tout = tf(tfeats, tw)
    tout.backward(_t(cot).to(tout.dtype))
    dense = kind.endswith("dense")
    _close(tout, jout, BF16_TOL if dense else K1_TOL)
    _close(tw.grad, jdw, BF16_TOL if dense else K1_TOL)
    assert tfeats.grad.dtype == tfeats.dtype
    _close(tfeats.grad, jdf, BF16_TOL if dtype == "bf16" or dense else K1_TOL)
    assert float(tw.grad.abs().sum()) > 0 and float(tfeats.grad.abs().sum()) > 0


def test_backward_plans_counted_and_the_mirrored_plan_shared():
    """A stage's mirrored rulebook and plan are made once, at the first
    backward, and are ``plan_rulebook(rows.flip(0))``; each strided and
    inverse conv makes one backward plan per call."""
    jst, tst = _active_set(6, 16)
    rb = SubmRulebook(tst)
    feats = tst.feats.float().requires_grad_(True)
    w1 = torch.randn(27, 16, 16, requires_grad=True)
    w2 = torch.randn(27, 16, 16, requires_grad=True)
    y = tsc.subm_conv_apply(feats, tst.valid, rb.rows, w1, rb.plan, rb.mirror)
    y = tsc.subm_conv_apply(y, tst.valid, rb.rows, w2, rb.plan, rb.mirror)
    before = tsc.plan_rulebook.calls
    y.sum().backward()
    assert tsc.plan_rulebook.calls - before == 1
    rows_m, plan_m = rb.mirror()
    ref = tsc.plan_rulebook(rb.rows.flip(0), tst.capacity)
    assert torch.equal(rows_m, rb.rows.flip(0))
    assert torch.equal(plan_m.masks, ref.masks) and torch.equal(plan_m.order, ref.order)
    out = tsc.sparse_conv3d(tst.replace(feats=feats), w1, K, STRIDE, PAD, 256)
    before = tsc.plan_rulebook.calls
    out.feats.sum().backward()
    assert tsc.plan_rulebook.calls - before == 1


# ---------------------------------------------------------------------------
# optimizer, schedules, checkpoints
# ---------------------------------------------------------------------------


def test_optimizer_matches_optax_on_shared_gradients():
    """clip(35) + AdamW + cyclic lr + the segmentor-core multiplier over 3
    steps, both fed the same gradients: the first step is clipped (global
    norm 100), the others not."""
    rng = np.random.default_rng(7)
    shapes = {"seg_core": {"a": (4, 3), "b": (5,)}, "head": {"c": (3, 3), "d": (2,)}}
    params = {g: {n: rng.normal(size=s).astype(np.float32) for n, s in v.items()}
              for g, v in shapes.items()}
    grads = []
    for norm in (100.0, 0.5, 20.0):
        g = {gk: {n: rng.normal(size=s).astype(np.float32) for n, s in v.items()}
             for gk, v in shapes.items()}
        tot = np.sqrt(sum(float((x ** 2).sum()) for v in g.values() for x in v.values()))
        grads.append(jax.tree_util.tree_map(lambda x: (x * norm / tot).astype(np.float32), g))
    rules = {"seg_core": 0.2}
    tx = jtrain.make_optimizer(base_lr=1e-3, total_steps=10, lr_mult_rules=rules)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)

    module = torch.nn.Module()
    for g, v in params.items():
        setattr(module, g, torch.nn.ParameterDict({n: torch.nn.Parameter(_t(x))
                                                   for n, x in v.items()}))
    opt = ttrain.make_optimizer(module, base_lr=1e-3, total_steps=10, lr_mult_rules=rules)
    assert sorted(g["lr_mult"] for g in opt.param_groups) == [0.2, 1.0]
    for step, g in enumerate(grads):
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
        for name, p in module.named_parameters():
            gk, n = name.split(".")
            p.grad = _t(g[gk][n])
        gnorm = ttrain.optimizer_step(opt, step)
        assert abs(float(gnorm) - (100.0, 0.5, 20.0)[step]) < 1e-3
        for name, p in module.named_parameters():
            gk, n = name.split(".")
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[gk][n]), rtol=0,
                                       atol=OPT_TOL, err_msg=f"{name} step {step}")
    moved = [float((p.detach() - _t(params[n.split(".")[0]][n.split(".")[1]])).abs().max())
             for n, p in module.named_parameters()]
    assert min(moved) > 1e-4


def test_cyclic_lr_schedule_and_runtime_schedule_match_jax():
    for base, total in ((1e-4, 100), (2e-3, 37), (1e-3, 1)):
        js, ts = jtrain.cyclic_lr_schedule(base, total), ttrain.cyclic_lr_schedule(base, total)
        for step in (0, 1, total // 3, int(total * 0.4), total // 2, total - 1, total, total + 5):
            np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-6, atol=0)
    for kw in (dict(), dict(enable_detection_step=5, threshold_buffer_start=0.2,
                            threshold_buffer_end_step=15, disable_aug_step=12)):
        j, t = JRuntimeSchedule(**kw), RuntimeSchedule(**kw)
        for step in range(0, 20, 3):
            assert t.enable_detection(step) == j.enable_detection(step)
            assert t.threshold_buffer(step) == j.threshold_buffer(step)
            assert t.augmentation_enabled(step) == j.augmentation_enabled(step)


def test_train_steps_lower_the_loss_and_checkpoint_round_trips(tmp_path):
    """Three tiny-config train steps on one batch lower the summed loss; a
    checkpoint taken after them restores model, optimizer and step, and the
    restored copy's next step matches the original's (the forward bitwise;
    the parameters within ``OPT_TOL``, since the CPU backward sums gathered
    rows' gradients in a thread-dependent order)."""
    cfg = tiny_fsf_config()
    sc = S.make_scene_arrays(seed=1, n_cap=cfg.caps.points, max_gt=cfg.caps.max_gt)
    cam = S.make_camera_arrays(sc["gt_boxes"], sc["gt_labels"], sc["gt_valid"],
                               num_classes=cfg.num_classes)
    pb, cd = S.fsf_inputs(sc, cam, device="cpu")
    gt = S.to_ground_truth(sc, device="cpu")
    batch = ttrain.Batch(pb, cd, gt, gt)
    sched = RuntimeSchedule()

    def fresh():
        m = build_fsf(cfg, seed=0, device="cpu")
        return m, ttrain.make_optimizer(m, base_lr=1e-4, total_steps=100,
                                        lr_mult_rules={"seg_core": 0.2})

    m, opt = fresh()
    losses = [float(ttrain.train_step(m, opt, sched, batch, s)[0]) for s in range(3)]
    assert losses[-1] < losses[0]
    path = str(tmp_path / "ck.pt")
    save_checkpoint(path, m, opt, 3)
    m2, opt2 = fresh()
    assert load_checkpoint(path, m2, opt2) == 3
    for (k, a), b in zip(m.state_dict().items(), m2.state_dict().values()):
        assert torch.equal(a, b), k
    s1, s2 = opt.state_dict(), opt2.state_dict()
    assert s1["param_groups"] == s2["param_groups"]
    for i, st in s1["state"].items():
        for k, v in st.items():
            assert torch.equal(v, s2["state"][i][k]), (i, k)
    a = ttrain.train_step(m, opt, sched, batch, 3)
    b = ttrain.train_step(m2, opt2, sched, batch, 3)
    assert torch.equal(a[0], b[0])
    for p, q in zip(m.parameters(), m2.parameters()):
        np.testing.assert_allclose(q.detach().numpy(), p.detach().numpy(), rtol=0, atol=OPT_TOL)
