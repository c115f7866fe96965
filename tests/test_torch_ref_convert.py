"""Reference checkpoints through the port's ``cli/convert_checkpoint.py`` and
``train/checkpoint.load_torch_state_dict`` against the JAX package's tool
on the CPU:

* ``load_torch_state_dict`` reads mmcv's ``{"meta", "state_dict"}`` layout
  and a bare state dict as the JAX package's does, bitwise, and raises,
  naming the file, on one it cannot read;
* a tiny FSF whose weights went reference layout → ``.pth`` → the convert
  CLI → ``load_jax_variables`` serves as the JAX FSF on the same converted
  tree, at ``test_torch_fsf.py``'s tolerances (one ``FAST_COMPILE`` jit);
* the CLI's ``--list``, ``--out`` (the JAX tool's pickle, bitwise, when the
  checkpoint fills every leaf) and ``--export`` (the state dict back,
  bitwise);
* the one deliberate difference: leaves the checkpoint lacks are zeros in
  the JAX tool's output (its ``eval_shape`` skeleton) and the seeded
  model's values in the port's; ``convert_state_dict`` given the JAX tool's
  skeleton gives the JAX tool's tree bitwise.
"""
import os
import pickle
import sys

import jax
import numpy as np
import pytest
import torch

from fixtures import make_camera_data, make_scene, with_noaug_channels
from fullysparsefusion_tpu.config import tiny_fsf_config as j_tiny_fsf_config
from fullysparsefusion_tpu.models.fsf import FSF as JFSF
from fullysparsefusion_tpu.train import checkpoint as jckpt
from fullysparsefusion_tpu.train import torch_map as jmap
from fullysparsefusion_tpu_torch import synthetic as S
from fullysparsefusion_tpu_torch.cli import convert_checkpoint as C
from fullysparsefusion_tpu_torch.config import tiny_fsd_config, tiny_fsf_config
from fullysparsefusion_tpu_torch.train import checkpoint as ckpt
from fullysparsefusion_tpu_torch.train import torch_map as tmap
from fullysparsefusion_tpu_torch.weights import build_fsd, build_fsf, to_jax_variables
from test_torch_data_nuscenes import jax_tools
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)
from test_torch_fsf import BF16_CHAIN_TOL, FAST_COMPILE, PHASES, _check, _numpy_variables
from test_torch_ref_checkpoint import _assert_trees_equal, _leaves


@pytest.fixture(scope="module")
def jax_tool():
    """The JAX package's ``tools/convert_checkpoint.py`` and its tiny FSF
    skeleton (``jax.eval_shape``: shapes only)."""
    with jax_tools():
        import convert_checkpoint as tool
    return tool, tool.build_skeleton("fsf", None, True)


def _save(path, sd, mmcv=True):
    tensors = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    torch.save({"meta": {"epoch": 6, "iter": 100, "mmdet_version": "2.x"},
                "state_dict": tensors} if mmcv else tensors, path)


def _run_jax_tool(jax_tool, monkeypatch, argv):
    """The JAX tool's ``main`` on ``argv``, its tiny FSF skeleton shared
    from the module's fixture instead of traced again."""
    tool, skeleton = jax_tool

    def build_skeleton(model_name, config_path, tiny):
        assert (model_name, config_path, tiny) == ("fsf", None, True)
        return skeleton

    monkeypatch.setattr(tool, "build_skeleton", build_skeleton)
    monkeypatch.setattr(sys, "argv", ["convert_checkpoint.py", *argv])
    tool.main()


def test_load_torch_state_dict_reads_mmcv_and_bare_files(tmp_path):
    sd = tmap.synthesize_state_dict(
        to_jax_variables(build_fsd(tiny_fsd_config(), device="cpu")), "fsd")
    for mmcv in (True, False):
        path = str(tmp_path / f"sd_{mmcv}.pth")
        _save(path, sd, mmcv)
        got, want = ckpt.load_torch_state_dict(path), jckpt.load_torch_state_dict(path)
        assert list(got) == list(want) == list(sd)
        for k in sd:
            assert got[k].dtype == want[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], want[k])
            np.testing.assert_array_equal(got[k], sd[k])
    bad = tmp_path / "not_a_checkpoint.pth"
    bad.write_bytes(b"no torch file here")
    with pytest.raises(ValueError, match="not_a_checkpoint.pth"):
        ckpt.load_torch_state_dict(str(bad))
    torch.save({"state_dict": {"a": [1, 2]}}, str(tmp_path / "lists.pth"))
    with pytest.raises(ValueError, match="lists.pth"):
        ckpt.load_torch_state_dict(str(tmp_path / "lists.pth"))


def test_converted_tiny_fsf_serves_as_jax_on_the_same_tree(jax_tool, tmp_path):
    _, skeleton = jax_tool
    jvars = jax.tree_util.tree_map(np.asarray, _numpy_variables(skeleton))
    pth, pkl = str(tmp_path / "fsf.pth"), str(tmp_path / "fsf_vars.pkl")
    _save(pth, jmap.synthesize_state_dict(jvars, "fsf"))
    report = C.main(["--pth", pth, "--model", "fsf", "--tiny", "--out", pkl])["report"]
    assert report["filled"] == report["total"]
    assert report["missing"] == report["unmapped"] == report["mismatch"] == []
    with open(pkl, "rb") as f:
        converted = pickle.load(f)
    _assert_trees_equal(converted, jvars)

    cfg = tiny_fsf_config()
    sc = S.make_scene_arrays(seed=0, n_cap=cfg.caps.points, max_gt=cfg.caps.max_gt)
    cam = S.make_camera_arrays(sc["gt_boxes"], sc["gt_labels"], sc["gt_valid"],
                               num_classes=cfg.num_classes)
    pb, cd = S.fsf_inputs(sc, cam, device="cpu")
    model = build_fsf(cfg, seed=5, device="cpu")
    ckpt.load_jax_variables(pkl, model)
    with torch.no_grad():
        out = model(pb, cd, 2)
        det = model.get_bboxes(out, 2)

    jcfg = j_tiny_fsf_config()
    jpb, jgt = make_scene(seed=0, n_cap=jcfg.caps.points, max_gt=jcfg.caps.max_gt)
    jcam = make_camera_data(jpb, jgt, num_classes=jcfg.num_classes)
    jpb = with_noaug_channels(jpb)
    jmodel = JFSF(cfg=jcfg)

    def run(v):
        o = jmodel.apply(v, jpb, jcam, 2, None, None, False)
        return o, jmodel.apply(v, o, 2, method=JFSF.get_bboxes)

    jout, jdet = jax.tree_util.tree_map(
        np.asarray, jax.jit(run, compiler_options=FAST_COMPILE)(converted))
    for phase in PHASES.values():
        ref, got = phase(jout), phase(out)
        assert set(ref) == set(got)
        for name in ref:
            _check(name, ref[name], got[name], BF16_CHAIN_TOL)
    assert int(np.asarray(jdet.valid).sum()) > 0
    for f in ("valid", "labels", "boxes", "scores"):
        _check(f"det.{f}", getattr(jdet, f), getattr(det, f), BF16_CHAIN_TOL)


def test_convert_cli_list_out_and_export_match_the_jax_tool(jax_tool, tmp_path, monkeypatch,
                                                            capsys):
    sd = tmap.synthesize_state_dict(
        to_jax_variables(build_fsf(tiny_fsf_config(), seed=3, device="cpu")), "fsf")
    pth = str(tmp_path / "fsf.pth")
    _save(pth, sd)
    keys = C.main(["--pth", pth, "--list"])["keys"]
    assert keys == {k: v.shape for k, v in sd.items()}
    printed = capsys.readouterr().out.splitlines()
    assert len(printed) == len(sd) and printed[0].split()[0] == next(iter(sd))

    ours, theirs = str(tmp_path / "ours.pkl"), str(tmp_path / "theirs.pkl")
    C.main(["--pth", pth, "--model", "fsf", "--tiny", "--out", ours])
    _run_jax_tool(jax_tool, monkeypatch,
                  ["--pth", pth, "--model", "fsf", "--tiny", "--out", theirs])
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        _assert_trees_equal(pickle.load(f), pickle.load(g))

    back = str(tmp_path / "back.pth")
    assert C.main(["--export", ours, "--model", "fsf", "--out", back])["exported"] == len(sd)
    exported = torch.load(back, weights_only=True)
    assert list(exported) == ["state_dict"] and list(exported["state_dict"]) == list(sd)
    for k, v in exported["state_dict"].items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), sd[k])
    jback = str(tmp_path / "jback.pth")
    _run_jax_tool(jax_tool, monkeypatch, ["--export", theirs, "--model", "fsf", "--out", jback])
    for k, v in torch.load(jback, weights_only=True)["state_dict"].items():
        assert torch.equal(v, exported["state_dict"][k]), k


def test_unfilled_leaves_are_jax_zeros_and_port_seeded_values(jax_tool, tmp_path, monkeypatch):
    """An FSD pretrain into FSF: the FSF-only leaves are missing from the
    checkpoint."""
    _, skeleton = jax_tool
    fsd_sd = tmap.synthesize_state_dict(
        to_jax_variables(build_fsd(tiny_fsd_config(), seed=1, device="cpu")), "fsd")
    pth, ours, theirs = (str(tmp_path / n) for n in ("fsd.pth", "ours.pkl", "theirs.pkl"))
    _save(pth, fsd_sd)
    report = C.main(["--pth", pth, "--model", "fsf", "--tiny", "--seed", "2", "--out",
                     ours])["report"]
    _run_jax_tool(jax_tool, monkeypatch,
                  ["--pth", pth, "--model", "fsf", "--tiny", "--out", theirs])
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        port, jax_out = _leaves(pickle.load(f)), _leaves(pickle.load(g))
    seeded = _leaves(to_jax_variables(build_fsf(tiny_fsf_config(), seed=2, device="cpu")))
    filled = {(e.col, *e.path) for e in tmap.build_entries(to_jax_variables(
        build_fsf(tiny_fsf_config(), device="cpu"))["params"], "fsf") if e.torch_key in fsd_sd}
    assert port.keys() == jax_out.keys() == seeded.keys()
    assert len(filled) == report["filled"] and report["missing"]
    unfilled = [k for k in port if k not in filled]
    assert len(unfilled) == len(report["missing"])
    for k in filled:
        np.testing.assert_array_equal(port[k], jax_out[k])
    for k in unfilled:
        assert not jax_out[k].any(), k                          # the JAX tool: zeros
        np.testing.assert_array_equal(port[k], seeded[k])       # the port: seeded values
    # e.g. every LayerNorm scale of the FSF-only modules
    scales = [k for k in unfilled if k[-1] == "scale"]
    assert scales and all((port[k] == 1).all() for k in scales)
    # the function itself is the JAX package's: the same skeleton, the same tree
    same, _ = tmap.convert_state_dict(fsd_sd, skeleton, "fsf")
    assert _leaves(same).keys() == jax_out.keys()
    for k, v in _leaves(same).items():
        assert v.dtype == jax_out[k].dtype and np.array_equal(v, jax_out[k]), k
