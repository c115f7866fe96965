"""How far a two-rank FSF train step lands from one process on the whole
batch, in the JAX package and in the PyTorch port, on the CPU.

Uses the scenes, capacities and weights of ``tests/test_torch_ddp_port.py``
and ``tests/test_torch_ddp.py`` (tiny FSF config, every UNet conv on the
gather path, scenes of seeds 100 and 101, one per rank):

1. the JAX package: its ``shard_map`` step on two CPU devices (SyncBN and
   synced loss normalizers under ``bn_axis``, the gradient of the
   ``pmean``'d loss) against one ``value_and_grad`` at batch 2 with twice
   the capacities, train-form BN, detection weight 1;
2. the port: two gloo ranks of ``sharded_train_step`` against one process
   at batch 2, the same;
3. the JAX package's unsharded step on the seed-101 scene alone (detection
   weight 0), compiled twice: inputs as arguments and as constants.

For each it prints the worst relative loss-term difference and the worst
relative gradient-norm differences per leaf, beside
``tests/test_train.py::test_sharded_losses_match_single_device``'s bounds
(1e-2 per term, 1.5e-1 per leaf).

    JAX_PLATFORMS=cpu python tools/ddp_equivalence.py    # ~4 min on 8 cores
"""
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")


def worst(got: dict, ref: dict, n: int = 3):
    """The ``n`` largest relative differences of ``got`` against ``ref``."""
    import numpy as np

    rel = []
    for k, v in ref.items():
        a, b = np.asarray(got[k], np.float64), np.asarray(v, np.float64)
        den = float(np.linalg.norm(b))
        if den > 0:
            rel.append((round(float(np.linalg.norm(a - b)) / den, 6), k))
    return sorted(rel, reverse=True)[:n]


def jax_rows():
    import jax
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    from fullysparsefusion_tpu.config import tiny_fsf_config
    from test_torch_ddp import JFSF, JL, Mesh, P, jax_inputs, jtrain, shard_map, sharded_layout
    from test_torch_ddp_port import SCENE_SEEDS, concat_scenes, rank_config, scene_arrays
    from test_torch_fsf import _numpy_variables

    cfg = rank_config()
    scenes = [scene_arrays(s, cfg) for s in SCENE_SEEDS]
    m1, m2 = (JFSF(cfg=rank_config(k, tiny=tiny_fsf_config)) for k in (1, 2))
    pb0, cam0, _ = jax_inputs(*scenes[0])
    jvars = _numpy_variables(jax.eval_shape(
        lambda k: m1.init(k, pb0, cam0, 1, None, None, False,
                          method=lambda m, *a, **kw: m(*a, **kw)), jax.random.key(0)))
    params, stats = jvars["params"], jvars["batch_stats"]

    def grads_of(params, fwd, inputs, dw):
        def lf(p):
            losses, _ = fwd(p, stats, *inputs[:2], inputs[2], inputs[2], 0.0, dw)
            return jtrain.total_loss(losses), losses
        return jax.value_and_grad(lf, has_aux=True)(params)

    flat = lambda t: {jax.tree_util.keystr(k): np.asarray(v)
                      for k, v in jax.tree_util.tree_leaves_with_path(t)}
    (_, l1), g1 = jax.jit(lambda p, x: grads_of(p, jtrain.fsf_forward_fn(m2, 2), x, 1.0))(
        params, jax_inputs(*concat_scenes(scenes)))
    fwd = jtrain.fsf_forward_fn(m1, 1)

    def local(params, pb, cam, gt):
        def lf(p):
            with JL.bn_axis("dp"):
                losses, _ = fwd(p, stats, pb, cam, gt, gt, 0.0, 1.0)
            return jax.lax.pmean(jtrain.total_loss(losses), "dp"), losses
        (_, losses), g = jax.value_and_grad(lf, has_aux=True)(params)
        return jax.lax.pmean(losses, "dp"), g

    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
    l2, g2 = jax.jit(shard_map(local, mesh=mesh, in_specs=(P(),) + (P("dp"),) * 3,
                               out_specs=(P(), P())))(params, *sharded_layout(scenes))
    leaf = [(round(abs(float(np.linalg.norm(b)) / float(np.linalg.norm(a)) - 1), 6), k)
            for k, a in flat(g1).items() for b in [flat(g2)[k]] if np.linalg.norm(a) > 1e-6]
    yield {"case": "jax_two_devices_vs_one_process", "worst_terms":
           worst({k: v for k, v in l2.items() if "loss" in k},
                 {k: v for k, v in l1.items() if "loss" in k}),
           "worst_leaf_norms": sorted(leaf, reverse=True)[:3]}

    one = jax_inputs(*scenes[1])
    _, ga = jax.jit(lambda p, x: grads_of(p, fwd, x, 0.0))(params, one)
    _, gb = jax.jit(lambda p: grads_of(p, fwd, one, 0.0))(params)
    yield {"case": "jax_one_scene_arguments_vs_constants",
           "worst_leaves": worst(flat(gb), flat(ga))}


def port_row():
    import numpy as np

    from fullysparsefusion_tpu_torch.parallel.launch import spawn_ranks
    from fullysparsefusion_tpu_torch.weights import build_fsf
    from test_torch_ddp_port import (SCENE_SEEDS, fsf_step_rank, rank_config, scene_arrays,
                                     single_process_reference, state_arrays)

    cfg = rank_config()
    state = state_arrays(build_fsf(cfg, seed=0, device="cpu"))
    scenes = [scene_arrays(s, cfg) for s in SCENE_SEEDS]
    with tempfile.TemporaryDirectory() as d:
        (r0,), _ = spawn_ranks(fsf_step_rank, 2, os.path.join(d, "rendezvous"),
                               (cfg, state, [(1.0, True, scenes)]), backend="gloo",
                               device="cpu")
    ref = single_process_reference(scenes, state)
    leaf = [(round(abs(float(np.linalg.norm(r0["grads"][k])) / float(np.linalg.norm(g)) - 1),
                   6), k) for k, g in ref["grads"].items() if np.linalg.norm(g) > 1e-6]
    return {"case": "port_two_ranks_vs_one_process",
            "worst_terms": worst({k: v for k, v in r0["losses"].items() if "loss" in k},
                                 {k: v for k, v in ref["losses"].items() if "loss" in k}),
            "worst_leaf_norms": sorted(leaf, reverse=True)[:3]}


if __name__ == "__main__":
    for row in jax_rows():
        print(json.dumps(row), flush=True)
    print(json.dumps(port_row()), flush=True)
