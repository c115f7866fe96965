"""Train-form ``MaskedBatchNorm`` and AdamW against the JAX package on the CPU:
tests of ``test_torch_train.py``, at its tolerances. A file of at most five
tests, so that xdist's ``--dist loadfile`` (files with more tests first)
queues it behind ``tests/test_train.py``, the run's longest file.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fullysparsefusion_tpu.models.layers import MaskedBatchNorm as JMaskedBatchNorm
from fullysparsefusion_tpu.parallel import train as jtrain
from fullysparsefusion_tpu_torch.models.layers import MaskedBatchNorm
from fullysparsefusion_tpu_torch.parallel import train as ttrain
from fullysparsefusion_tpu_torch.weights import from_jax_variables
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)
from test_torch_train import BF16_TOL, F32_TOL, OPT_TOL, _close, _t


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
