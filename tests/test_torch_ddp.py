"""Data-parallel FSF training in the PyTorch port against the JAX package
on the CPU: the port's two gloo ranks x batch 1 (``sharded_train_step``,
rank functions in ``tests/test_torch_ddp_port.py``) against the JAX
package's ``shard_map`` step on a two-device sub-mesh of the eight CPU
devices (``fsf_forward_fn`` under ``layers.bn_axis("dp")``, the gradient of
the ``pmean`` of ``total_loss``, as ``tests/test_train.py`` builds it for
FSD), from the same weights (``weights.from_jax_variables``) and scenes.
One JAX compile serves every case: the detection weight is a traced
argument.

Cases: detection weight 1, and detection weight 0 (the segmentor-pretrain
phase of ``RuntimeSchedule``), where the detection heads' gradients are
exactly 0 on both sides. Then a rank whose scene has no valid point (weight
0): both ranks must finish the step (the ranks issue the same collectives
whatever their data; ``spawn_ranks`` times out otherwise), with the JAX
package's losses and updated BN statistics. Its gradient tree and counts are
not held to the JAX package's: with one scene in the batch, train-form BN
leaves values near 0 ahead of the VFE's max-reduce and ReLUs, where f32
noise reroutes gradients, and the JAX package's own unsharded step on the
one valid scene moves the VFE's first weight gradient by about a third
between two compilations (inputs as arguments or as constants,
``tools/ddp_equivalence.py``). ``tests/test_torch_ddp_port.py`` holds the
port's empty rank to one process on the other scene, to f32 sum order.
Then ``MaskedBatchNorm`` alone on two ranks against the JAX package's under
``shard_map``.

Every UNet conv runs on the gather path (see ``tests/test_torch_train.py``)
and the tolerances are that file's: integers and counts equal, losses
``LOSS_TOL``, gradients ``LEAF_TOL`` per leaf and ``TOTAL_TOL`` over the
tree (relative L2), updated BN running statistics ``STATS_TOL``, one BN
layer ``F32_TOL``.

``test_torch_ddp_grads.py`` holds more tests of this module's helpers and
fixtures, at its tolerances, in files of at most five tests, so that xdist's
``--dist loadfile`` (files with more tests first) queues them behind
``tests/test_train.py``, the Tier-1 run's longest file. The JAX step's
results are computed once per test session and shared by the two files
(``test_torch_av2.session_cached``); the port's ranks run in each.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from fullysparsefusion_tpu.config import tiny_fsf_config as j_tiny_fsf_config
from fullysparsefusion_tpu.models import layers as JL
from fullysparsefusion_tpu.models.camera import CameraData as JCameraData
from fullysparsefusion_tpu.models.fsf import FSF as JFSF
from fullysparsefusion_tpu.parallel import train as jtrain
from fullysparsefusion_tpu.utils.containers import GroundTruth as JGroundTruth
from fullysparsefusion_tpu.utils.containers import PointBatch as JPointBatch
from fullysparsefusion_tpu_torch import synthetic as S
from fullysparsefusion_tpu_torch.weights import from_jax_variables
from test_torch_ddp_port import (SCENE_SEEDS, bn_inputs, bn_rank, case_scenes, fsf_step_rank,
                                 rank_config, run_jobs, scene_arrays, spawn, torch_one_thread)
from test_torch_av2 import session_cached
from test_torch_fsf import FAST_COMPILE, _numpy_variables

LOSS_TOL = 4e-3
F32_TOL = 1e-5
STATS_TOL = 1e-5
LEAF_TOL = 5e-2
TOTAL_TOL = 1e-2
# name -> (detection weight, rank 0's scene has no valid point)
CASES = {"detection": (1.0, False), "segmentor_pretrain": (0.0, False),
         "rank_all_invalid": (0.0, True)}
HELD = ["detection", "segmentor_pretrain"]
# one BN layer's rows on each rank (equal counts: shard_map splits evenly)
BN_INPUTS = bn_inputs(rows=(200, 200))


def jax_inputs(sc, cam):
    """The JAX package's containers of one (scene, camera) arrays pair."""
    pb = JPointBatch(points=jnp.asarray(S.with_noaug_channels_array(sc["points"])),
                     batch_idx=jnp.asarray(sc["batch_idx"]), valid=jnp.asarray(sc["valid"]))
    gt = JGroundTruth(boxes=jnp.asarray(sc["gt_boxes"]), labels=jnp.asarray(sc["gt_labels"]),
                      valid=jnp.asarray(sc["gt_valid"]))
    return pb, JCameraData.build(cam["masks"], cam["anno"], cam["lidar2img"]), gt


def sharded_layout(scenes):
    """Each rank's (point batch, cameras, GT) concatenated along axis 0:
    what ``shard_map`` splits into one scene per device."""
    parts = [jax_inputs(*s) for s in scenes]
    return tuple(jax.tree_util.tree_map(lambda *xs: jnp.concatenate(xs), *[p[i] for p in parts])
                 for i in range(3))


@pytest.fixture(scope="module")
def mesh2():
    return Mesh(np.array(jax.devices()[:2]), ("dp",))


@pytest.fixture(scope="module")
def parity(mesh2, tmp_path_factory):
    """Every case on both sides: the JAX step (one compile) and one spawn of
    the port's two ranks, which also runs ``BN_INPUTS`` through one BN
    layer."""
    jcfg, cfg = rank_config(tiny=j_tiny_fsf_config), rank_config()
    model = JFSF(cfg=jcfg)
    pb0, cam0, _ = jax_inputs(*scene_arrays(SCENE_SEEDS[0], cfg))
    shapes = jax.eval_shape(
        lambda k: model.init(k, pb0, cam0, 1, None, None, False,
                             method=lambda m, *a, **kw: m(*a, **kw)),
        jax.random.key(0))
    jvars = _numpy_variables(shapes)
    fwd = jtrain.fsf_forward_fn(model, 1)

    def local(params, stats, pb, cam, gt, det_weight):
        def loss_fn(p):
            with JL.bn_axis("dp"):
                losses, new_stats = fwd(p, stats, pb, cam, gt, gt, 0.0, det_weight)
            return jax.lax.pmean(jtrain.total_loss(losses), "dp"), (losses, new_stats)

        (loss, (losses, new_stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return (loss, jax.lax.pmean(losses, "dp"), grads,
                jax.lax.pmean(new_stats, "dp"))

    def run_cases(variables, layouts):
        step = jax.jit(shard_map(local, mesh=mesh2,
                                 in_specs=(P(), P(), P("dp"), P("dp"), P("dp"), P()),
                                 out_specs=(P(), P(), P(), P())), compiler_options=FAST_COMPILE)
        return {name: jax.tree_util.tree_map(np.asarray, step(
                    variables["params"], variables["batch_stats"], *layout,
                    jnp.float32(CASES[name][0])))
                for name, layout in layouts.items()}

    layouts = {name: sharded_layout(case_scenes(cfg, all_invalid))
               for name, (_, all_invalid) in CASES.items()}
    # the JAX half once per session: test_torch_ddp_grads.py uses it too
    jres = session_cached(tmp_path_factory, "ddp_parity", run_cases, jvars, layouts)

    state = {k: v.numpy() for k, v in from_jax_variables(jvars).items()}
    cases = [(det_weight, True, case_scenes(cfg, all_invalid))
             for det_weight, all_invalid in CASES.values()]
    fsf, bn = zip(*spawn(run_jobs, 2, tmp_path_factory.mktemp("ddp_jax"),
                         [(fsf_step_rank, (cfg, state, cases)), (bn_rank, ([BN_INPUTS],))]))
    return dict(jvars=jvars, jax=jres, bn=[r[0] for r in bn],
                port={name: [r[i] for r in fsf] for i, name in enumerate(CASES)})


def _close(got, ref, tol, what):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=tol,
                               atol=tol * max(1.0, float(np.abs(ref).max(initial=0))),
                               err_msg=what)


@pytest.mark.parametrize("case", HELD)
def test_two_ranks_loss_dict_matches_jax_shard_map(parity, case):
    jres, tres = parity["jax"], parity["port"]
    jloss, jl, _, _ = jres[case]
    r0, r1 = tres[case]
    assert r0["losses"] == r1["losses"]
    assert set(r0["losses"]) == set(jl)
    for k in jl:
        if "num_pos" in k or "recall" in k:
            assert r0["losses"][k] == float(jl[k]), k
        else:
            _close(r0["losses"][k], jl[k], LOSS_TOL, k)
    _close(r0["total"], jloss, LOSS_TOL, "total")
    assert r0["losses"]["fsd_num_pos"] > 0 and r0["losses"]["stage0_num_pos"] > 0


def test_sync_batchnorm_two_ranks_matches_jax_shard_map(mesh2, parity):
    xs, valids, cot = BN_INPUTS
    ranks = parity["bn"]
    c = xs[0].shape[1]
    params = dict(scale=np.linspace(0.5, 1.5, c, dtype=np.float32),
                  bias=np.linspace(-0.2, 0.2, c, dtype=np.float32))
    stats = dict(mean=np.zeros(c, np.float32), var=np.ones(c, np.float32))
    bn = JL.MaskedBatchNorm()

    def local(p, x, valid, g):
        def f(p, x):
            with JL.bn_axis("dp"):
                y, upd = bn.apply({"params": p, "batch_stats": stats}, x, valid, True,
                                  mutable=["batch_stats"])
            return jax.lax.psum(jnp.sum(y * g), "dp"), (y, upd["batch_stats"])

        (_, (y, upd)), (dp, dx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(p, x)
        return y, dx, dp, jax.lax.pmean(upd, "dp")

    y, dx, dp, upd = jax.tree_util.tree_map(np.asarray, jax.jit(shard_map(
        local, mesh=mesh2, in_specs=(P(), P("dp"), P("dp"), P("dp")),
        out_specs=(P("dp"), P("dp"), P(), P())))(
            params, np.concatenate(xs), np.concatenate(valids), np.concatenate(cot)))
    _close(np.concatenate([r["y"] for r in ranks]), y, F32_TOL, "y")
    _close(np.concatenate([r["dx"] for r in ranks]), dx, F32_TOL, "dx")
    # the port averages parameter gradients over the ranks; JAX's are the psum'd loss's
    for r in ranks:
        _close(2 * r["dweight"], dp["scale"], F32_TOL, "scale")
        _close(2 * r["dbias"], dp["bias"], F32_TOL, "bias")
        _close(r["running_mean"], upd["mean"], F32_TOL, "mean")
        _close(r["running_var"], upd["var"], F32_TOL, "var")
