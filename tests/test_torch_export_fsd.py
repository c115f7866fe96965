"""Whole-model export of the LiDAR-only FSD (``cli/export_model.py``) on the
CPU, against the JAX package's ``tools/export_model.py``.

The CLI exports the tiny FSD (batch 2, the seed-0 test scene, weights from
seed 0) to a ``.pt2`` in a temporary directory and checks it (``--check``);
then the artifact is loaded in a fresh process that imports only the op
registration (``cli/serve_exported.py``), loaded here with another
checkpoint's weights (the JAX variables carried across, a second seed), and
its graph is read for the ``fsf::`` ops. The JAX side is the tool's
``build("fsd", tiny=True, config=None)``, its forward jitted once with
``FAST_COMPILE``; its ``model.init`` is replaced for that call by weights
drawn with numpy into the variable tree's shapes (``jax.eval_shape``,
``test_torch_fsf._numpy_variables``): an eager init costs ~80 s, and drawn
BN statistics are not the identity.

Tolerances:

* the artifact against the port's eager forward on the same weights and
  inputs: bitwise (on the CPU the program runs the same ops, the kernels'
  plain versions through the same ``fsf::`` ops);
* the CLI's ``--check``: the JAX tool's ``rtol = atol = 1e-5`` (it reports
  bitwise too);
* against the JAX forward on the same weights: ``BF16_CHAIN_TOL`` 4e-3,
  relative and absolute, the bf16 UNet chain's (``tests/test_torch_fsf.py``).

``test_torch_export_fsf.py`` runs the same cases on FSF with its cameras.
"""
import contextlib
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from fullysparsefusion_tpu.models.fsd import SingleStageFSD as JFSD
from fullysparsefusion_tpu.models.fsf import FSF as JFSF
from fullysparsefusion_tpu_torch.cli import export_model as E
from fullysparsefusion_tpu_torch.cli.serve_exported import request_dict
from fullysparsefusion_tpu_torch.ops import segment, sparse_conv
from fullysparsefusion_tpu_torch.weights import build_fsd, build_fsf, from_jax_variables
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)
from test_torch_fsf import BF16_CHAIN_TOL, FAST_COMPILE, _Count, _numpy_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_MODELS = {"fsd": JFSD, "fsf": JFSF}
BUILDERS = {"fsd": build_fsd, "fsf": build_fsf}


@contextlib.contextmanager
def numpy_init(cls):
    """``cls.init`` gives weights drawn with numpy into its variable tree's
    shapes inside the block."""
    orig = cls.init

    def init(self, key, *args, **kw):
        return _numpy_variables(jax.eval_shape(lambda k: orig(self, k, *args, **kw), key))

    cls.init = init
    try:
        yield
    finally:
        del cls.init


def jax_reference(model_name):
    """(variables, outputs as NumPy) of the JAX tool's ``build()`` forward,
    jitted. ``sys.path``, which the tool extends when imported, is restored
    after it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(os.path.join(REPO, "tools"))
        import export_model as EM

        with numpy_init(JAX_MODELS[model_name]):
            fwd, args = EM.build(model_name, tiny=True, config=None)
    out = jax.jit(fwd, compiler_options=FAST_COMPILE)(*args)
    return args[0], [np.asarray(o) for o in out]


def export_case(model_name, tmp_path_factory):
    """The JAX reference, the CLI's export and check of the tiny model, the
    live model (seed 0, the CLI's weights) and its inputs, and the artifact
    loaded here."""
    jvars, jout = jax_reference(model_name)
    pt2 = str(tmp_path_factory.mktemp("export") / f"{model_name}.pt2")
    cli = E.main(["--model", model_name, "--tiny", "--device", "cpu", "--out", pt2, "--check"])
    model, inputs = E.build(model_name, True, None, "cpu")
    return dict(name=model_name, jvars=jvars, jout=jout, pt2=pt2, cli=cli, model=model,
                inputs=inputs, program=torch.export.load(pt2).module())


def assert_bitwise(got, want):
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


def eager(model, inputs):
    return E.run(E.serving_module(model, E.BATCH), inputs)


def check_cli(case):
    cli = case["cli"]
    assert cli["check"]["outputs"] == 3 and cli["check"]["bitwise"]
    assert cli["mb"] > 1 and cli["nodes"] > 1000


def check_fresh_process(case, tmp_path):
    """The artifact in a process that imports only the op registration."""
    requests, outputs, report = (str(tmp_path / n) for n in
                                 ("requests.pt", "outputs.pt", "report.json"))
    torch.save([request_dict(*case["inputs"])], requests)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    subprocess.run([sys.executable, "-m", "fullysparsefusion_tpu_torch.cli.serve_exported",
                    "--pt2", case["pt2"], "--requests", requests, "--out", outputs,
                    "--report", report, "--device", "cpu"],
                   cwd=REPO, env=env, check=True, timeout=600)
    with open(report) as f:
        rep = json.load(f)
    assert rep["model_modules"] == []
    (req,) = rep["requests"]
    assert set(req["launches"].values()) == {0}           # the CPU launches no kernel
    (got,) = torch.load(outputs, weights_only=True)
    assert_bitwise(got, eager(case["model"], case["inputs"]))


def check_jax_weights(case):
    """The JAX variables loaded into the artifact: bitwise the port's model
    built from them, within BF16_CHAIN_TOL of the JAX forward."""
    program = case["program"]
    program.load_state_dict(from_jax_variables(case["jvars"]))
    got = E.run(program, case["inputs"])
    model = BUILDERS[case["name"]](case["model"].cfg, device="cpu", jax_variables=case["jvars"])
    assert_bitwise(got, eager(model, case["inputs"]))
    for g, j in zip(got, case["jout"]):
        assert g.shape == j.shape
        np.testing.assert_allclose(g.numpy(), j, rtol=BF16_CHAIN_TOL, atol=BF16_CHAIN_TOL)


def check_second_seed(case):
    model = BUILDERS[case["name"]](case["model"].cfg, seed=1, device="cpu")
    program = case["program"]
    program.load_state_dict(model.state_dict())
    assert_bitwise(E.run(program, case["inputs"]), eager(model, case["inputs"]))


def check_ops_in_graph(case):
    """The program calls K1 as often as the eager forward calls its wrapper,
    K2 once, the segment sum as often as the eager forward sums through a
    ``SegmentInfo``, and no other ``fsf::`` op (no decode: no K3; no
    gradient)."""
    ops = {}
    for node in case["program"].graph.nodes:
        if node.op == "call_function" and str(node.target).startswith("fsf."):
            ops[str(node.target)] = ops.get(str(node.target), 0) + 1
    with _Count(sparse_conv, "gather_conv") as k1, _Count(segment.SegmentInfo, "sum") as sums:
        eager(case["model"], case["inputs"])
    assert k1.n > 0 and sums.n > 0
    assert ops == {"fsf.gather_conv.default": k1.n, "fsf.ccl_roots.default": 1,
                   "fsf.segment_sum.default": sums.n}


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    return export_case("fsd", tmp_path_factory)


def test_cli_export_check_passes(exported):
    check_cli(exported)


def test_fresh_process_serves_the_artifact_without_model_code(exported, tmp_path):
    check_fresh_process(exported, tmp_path)


def test_artifact_with_jax_weights_matches_jax(exported):
    check_jax_weights(exported)


def test_artifact_with_a_second_seed_matches_that_model(exported):
    check_second_seed(exported)


def test_artifact_calls_the_fsf_ops(exported):
    check_ops_in_graph(exported)
