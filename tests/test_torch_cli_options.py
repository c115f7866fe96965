"""The port's entry-point options (``cli/``) in-process on the CPU, on the
tiny tree of ``tests/test_torch_cli.py``:

- ``--init-from``: a pickle of JAX variables (the JAX package's tree for
  the tiny FSF at the reader's point width, from ``jax.eval_shape``, no
  compile, weights drawn with numpy) loads strictly, and a tree with a
  leaf missing raises.
- ``--synthetic`` runs the JAX tools' smoke runs.
- Without ``--cpu`` and without a card the entry points raise (no CPU
  fallback).
- ``--ranks 2`` trains on two gloo processes.

At most five tests, for the reason ``tests/test_torch_cli.py`` gives.
"""
import json
import os
import pickle

import numpy as np
import pytest
import torch

from fullysparsefusion_tpu_torch.cli import common
from fullysparsefusion_tpu_torch.cli import test as T
from fullysparsefusion_tpu_torch.cli import train as TR
from fullysparsefusion_tpu_torch.config import tiny_fsf_config
from fullysparsefusion_tpu_torch.train import checkpoint as ckpt
from fullysparsefusion_tpu_torch.weights import from_jax_variables
from test_torch_cli import _data, tree  # noqa: F401 (module fixture)
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)


def _jax_variables(tree):
    """The JAX package's variable tree for the tiny FSF at the reader's point
    width (``eval_shape`` of ``init`` on the JAX reader's sample 0, no
    compile), weights drawn with numpy."""
    import jax
    import jax.numpy as jnp

    from fullysparsefusion_tpu.config import tiny_fsf_config as j_tiny
    from fullysparsefusion_tpu.data.masks import load_sample_masks, pack_mask_scores
    from fullysparsefusion_tpu.data.nuscenes import NuScenesReader as JReader
    from fullysparsefusion_tpu.data.pipelines import collate_scene as j_collate
    from fullysparsefusion_tpu.models.camera import CameraData as JCameraData
    from fullysparsefusion_tpu.models.fsf import FSF as JFSF
    from fullysparsefusion_tpu.utils.containers import PointBatch as JPointBatch
    from test_torch_fsf import _numpy_variables

    cfg = j_tiny()
    s = JReader(tree["info"], tree["root"], cfg.fsd.class_names, training=False,
                with_cbgs=False).sample(0, augment=False)
    batch = j_collate([s], cfg.caps.points, cfg.caps.max_gt)
    l2i = s["lidar2img"].copy()
    masks, anno = load_sample_masks(tree["masks"], s["token"], 6, 10, (128, 224), downsample=2)
    l2i[:, :2] /= 2
    cam = JCameraData.build(pack_mask_scores(masks, anno)[None], anno[None], l2i[None])
    pb = JPointBatch(points=jnp.asarray(batch["points"]), batch_idx=jnp.asarray(batch["batch_idx"]),
                     valid=jnp.asarray(batch["valid"]))
    model = JFSF(cfg=cfg)
    shapes = jax.eval_shape(lambda k: model.init(k, pb, cam, 1, None, None, False,
                                                 method=lambda m, *a, **kw: m(*a, **kw)),
                            jax.random.key(0))
    return jax.tree_util.tree_map(np.asarray, _numpy_variables(shapes, seed=4))


def test_init_from_jax_pickle_loads_strictly(tree, tmp_path):
    jvars = _jax_variables(tree)
    path = str(tmp_path / "init.pkl")
    with open(path, "wb") as f:
        pickle.dump(jvars, f)
    want = from_jax_variables(jvars)
    # lr 0: the step moves no parameter, so they stay what was loaded
    out = TR.run(tiny_fsf_config(), TR.parse_args(
        ["--model", "fsf", "--tiny", "--cpu", "--max-steps", "1", "--lr", "0", "--init-from",
         path, "--work-dir", str(tmp_path / "work"), *_data(tree)]))
    got = dict(out["model"].named_parameters())
    assert set(got) < set(want)
    for k, p in got.items():
        assert torch.equal(p.detach(), want[k]), k
    jvars["params"].pop(sorted(jvars["params"])[0])
    with open(path, "wb") as f:
        pickle.dump(jvars, f)
    model = common.build_model(
        "fsf", common.model_config(tiny_fsf_config(), "fsf", common.READER_POINT_WIDTH), 0, "cpu")
    with pytest.raises(RuntimeError, match="Missing key"):
        ckpt.load_jax_variables(path, model)


def test_synthetic_smoke_runs(tmp_path, capsys):
    out = TR.run(tiny_fsf_config(), TR.parse_args(
        ["--synthetic", "--tiny", "--cpu", "--max-steps", "1", "--model", "fsd",
         "--work-dir", str(tmp_path)]))
    assert len(out["steps"]) == 1 and np.isfinite(out["steps"][0]["loss"])
    T.main(["--synthetic", "--cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["mode"] == "synthetic"


def test_entry_points_refuse_to_fall_back_to_the_cpu(tree, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--cpu"):
        T.run(tiny_fsf_config(), T.parse_args(["--model", "fsf", "--tiny", *_data(tree)]))
    with pytest.raises(RuntimeError, match="--cpu"):
        TR.main(["--synthetic", "--tiny", "--max-steps", "1"])


def test_train_cli_two_ranks(tree, tmp_path):
    """``--ranks 2``: two gloo processes, each on its stride of the dataset,
    step through ``sharded_train_step``; the averaged loss is the same on
    both, and rank 0 alone writes the log and the checkpoint."""
    work = str(tmp_path / "work")
    out = TR.run(tiny_fsf_config(), TR.parse_args(
        ["--model", "fsf", "--tiny", "--cpu", "--max-steps", "1", "--ranks", "2", "--work-dir",
         work, "--log-interval", "1", *_data(tree)]))
    r0, r1 = out["ranks"]
    assert [s["step"] for s in r0["steps"]] == [s["step"] for s in r1["steps"]] == [1]
    assert np.isfinite(r0["steps"][0]["loss"]) and r0["steps"][0]["loss"] == r1["steps"][0]["loss"]
    assert "allreduce_ms" in r0["steps"][0]
    assert sorted(os.listdir(work)) == ["step_00000001.pt", "train_log.jsonl"]
