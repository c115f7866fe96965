"""The reference-checkpoint map of the PyTorch port against the JAX package on
the CPU, for the tiny FSF, the tiny FSD and HTC at ``test_torch_htc.TINY``:

* ``weights.to_jax_variables`` gives the JAX init's leaf paths and shapes
  (the JAX tree from ``jax.eval_shape`` of ``init``: no compile), and
  ``from_jax_variables`` loads it back strictly and bitwise;
* the port's ``train/torch_map.build_entries`` equals the JAX package's,
  entry for entry;
* ``synthesize_state_dict`` then ``convert_state_dict`` is a bitwise round
  trip with every tensor filled, and both packages' functions give the same
  arrays;
* an FSD state dict converted against the FSF skeleton (the warm start from
  an FSD pretrain) gives the JAX package's report and tree.

All exact: the same NumPy arithmetic on both sides.
"""
import jax
import numpy as np
import pytest

from fixtures import make_camera_data, make_scene, with_noaug_channels
from fullysparsefusion_tpu import config as jcfg
from fullysparsefusion_tpu.models import htc as jhtc
from fullysparsefusion_tpu.models.fsd import SingleStageFSD as JFSD
from fullysparsefusion_tpu.models.fsf import FSF as JFSF
from fullysparsefusion_tpu.train import torch_map as jmap
from fullysparsefusion_tpu_torch.config import tiny_fsd_config, tiny_fsf_config
from fullysparsefusion_tpu_torch.train import torch_map as tmap
from fullysparsefusion_tpu_torch.weights import (build_fsd, build_fsf, build_htc,
                                                 from_jax_variables, to_jax_variables)
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)
from test_torch_htc import HW, TINY, _variable_shapes


def _jax_fsf_shapes():
    cfg = jcfg.tiny_fsf_config()
    pb, gt = make_scene(seed=0, n_cap=cfg.caps.points, max_gt=cfg.caps.max_gt)
    cam = make_camera_data(pb, gt, num_cams=cfg.num_cams, num_classes=cfg.num_classes)
    model = JFSF(cfg=cfg)
    return jax.eval_shape(lambda k: model.init(k, with_noaug_channels(pb), cam, 2, gt, gt, False,
                                               method=lambda m, *a, **kw: m(*a, **kw)),
                          jax.random.key(0))


def _jax_fsd_shapes():
    cfg = jcfg.tiny_fsd_config()
    pb, gt = make_scene(seed=0, n_cap=cfg.caps.points, max_gt=cfg.caps.max_gt)
    model = JFSD(cfg=cfg)
    return jax.eval_shape(lambda k: model.init(k, pb, 2, gt, False,
                                               method=lambda m, *a, **kw: m(*a, **kw)),
                          jax.random.key(0))


MODELS = {
    "fsf": (_jax_fsf_shapes, lambda **kw: build_fsf(tiny_fsf_config(), device="cpu", **kw)),
    "fsd": (_jax_fsd_shapes, lambda **kw: build_fsd(tiny_fsd_config(), device="cpu", **kw)),
    "htc": (lambda: _variable_shapes(jhtc.HTC(**TINY), HW),
            lambda **kw: build_htc(device="cpu", **TINY, **kw)),
}


def _leaves(tree):
    """{(collection, path...): leaf} of a nested dict."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[tuple(p.key for p in path)] = leaf
    return out


def _entries(entries):
    return [(e.torch_key, e.col, tuple(e.path), e.transform) for e in entries]


def _assert_trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype, k
        np.testing.assert_array_equal(la[k], lb[k], err_msg="/".join(k))


@pytest.mark.parametrize("name", list(MODELS))
def test_variables_entries_and_round_trip_match_jax(name):
    jax_shapes, build = MODELS[name]
    shapes = jax_shapes()
    model = build(seed=0)
    tree = to_jax_variables(model)
    # the JAX init's leaf paths and shapes (a collection the JAX model lacks
    # is empty here)
    want = {k: tuple(v.shape) for k, v in _leaves(dict(shapes)).items()}
    got = {k: v.shape for k, v in _leaves(tree).items()}
    assert got == want
    assert all(v.dtype == np.float32 and v.flags.c_contiguous for v in _leaves(tree).values())
    # back into a fresh model, strictly and bitwise
    again = build(jax_variables=tree).state_dict()
    ref = model.state_dict()
    assert again.keys() == ref.keys()
    for k in ref:
        assert again[k].equal(ref[k]), k
    assert from_jax_variables(tree).keys() == ref.keys()
    # the checkpoint map, entry for entry
    entries = tmap.build_entries(tree["params"], name)
    assert _entries(entries) == _entries(jmap.build_entries(shapes["params"], name))
    # reference layout and back
    sd = tmap.synthesize_state_dict(tree, name)
    jsd = jmap.synthesize_state_dict(tree, name)
    assert sd.keys() == jsd.keys()
    for k in sd:
        assert sd[k].shape == jsd[k].shape and np.array_equal(sd[k], jsd[k]), k
    out, report = tmap.convert_state_dict(sd, tree, name)
    assert report["filled"] == report["total"] == len(entries) == len(sd)
    assert report["missing"] == report["unmapped"] == report["mismatch"] == []
    _assert_trees_equal(out, tree)
    jout, jreport = jmap.convert_state_dict(sd, tree, name)
    assert jreport == report
    _assert_trees_equal(jout, out)


def test_fsd_state_dict_against_the_fsf_skeleton_gives_the_jax_report():
    """The warm start FSF's recipe makes: an FSD pretrain's state dict
    converted against FSF's variables fills the segmentor and the LiDAR
    branch and reports the FSF-only modules as missing."""
    fsd_sd = tmap.synthesize_state_dict(
        to_jax_variables(build_fsd(tiny_fsd_config(), seed=1, device="cpu")), "fsd")
    skeleton = to_jax_variables(build_fsf(tiny_fsf_config(), seed=0, device="cpu"))
    out, report = tmap.convert_state_dict(fsd_sd, skeleton, "fsf")
    jout, jreport = jmap.convert_state_dict(fsd_sd, skeleton, "fsf")
    assert report == jreport
    _assert_trees_equal(out, jout)
    assert report["unmapped"] == [] and report["mismatch"] == []
    assert 0 < report["filled"] < report["total"]
    assert report["total"] - report["filled"] == len(report["missing"])
    assert all(not k.startswith(("segmentor.", "backbone.", "bbox_head."))
               for k in report["missing"])
    # filled leaves carry the FSD's values, missing ones the skeleton's
    filled = {(e.col, *e.path) for e in tmap.build_entries(skeleton["params"], "fsf")
              if e.torch_key in fsd_sd}
    for k, v in _leaves(out).items():
        src = _leaves(skeleton)[k]
        assert (k in filled) or np.array_equal(v, src), k
    assert any(not np.array_equal(_leaves(out)[k], _leaves(skeleton)[k]) for k in filled)
