"""The port's entry points (``cli/``) in-process on the CPU (``--tiny
--cpu``), on a tiny nuScenes tree written by the port's
``cli/make_fake_nuscenes.py``.

- ``cli.create_gt_database`` writes the database the JAX tool writes
  (bitwise, the same pickle contents).
- ``cli.train``: 2 steps of tiny FSF (CBGS, GT paste, masks) with their
  records, log and checkpoint; ``--resume`` restores the saved parameters
  and optimizer state bitwise and runs one more step.
- ``cli.test --checkpoint --eval`` (with ``--tmpdir`` shard files): its JSON
  is bitwise the model loaded from that checkpoint called directly on the
  reader's collated samples and their masks; with ``--tta`` bitwise the
  direct variants' union fused by ``tta.fuse_union``.

``tests/test_torch_cli_options.py`` holds the other options. Each file
keeps at most five tests, so that ``--dist loadfile`` hands them out after
``tests/test_train.py``, the Tier-1 run's longest file (it hands out files
with more tests first).
"""
import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from fullysparsefusion_tpu_torch.cli import common
from fullysparsefusion_tpu_torch.cli import create_gt_database as G
from fullysparsefusion_tpu_torch.cli import make_fake_nuscenes as M
from fullysparsefusion_tpu_torch.cli import test as T
from fullysparsefusion_tpu_torch.cli import train as TR
from fullysparsefusion_tpu_torch.config import tiny_fsf_config
from fullysparsefusion_tpu_torch.data import tta
from fullysparsefusion_tpu_torch.data.nuscenes import NuScenesReader
from fullysparsefusion_tpu_torch.data.pipelines import collate_scene
from fullysparsefusion_tpu_torch.models.camera import CameraData
from fullysparsefusion_tpu_torch.train import checkpoint as ckpt
from test_torch_data_nuscenes import assert_same, jax_tools
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)

IMG = ["--img-h", "128", "--img-w", "224"]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nusc"))
    info, masks = M.write_dataset(root, n_samples=2, n_sweeps=2, extent=12.0)
    db = os.path.join(root, "gt_db.pkl")
    counts = G.run(G.parse_args(["--info-pkl", info, "--data-root", root, "--out", db]))
    return dict(root=root, info=info, masks=masks, db=db, counts=counts)


def _data(tree):
    return ["--info-pkl", tree["info"], "--data-root", tree["root"], "--mask-dir", tree["masks"],
            *IMG]


@pytest.fixture(scope="module")
def trained(tree, tmp_path_factory):
    work = str(tmp_path_factory.mktemp("work"))
    args = TR.parse_args(["--model", "fsf", "--tiny", "--cpu", "--max-steps", "2",
                          "--work-dir", work, "--gt-db", tree["db"], "--log-interval", "1",
                          *_data(tree)])
    out = TR.run(tiny_fsf_config(), args)
    return dict(out, work=work, args=args)


def test_create_gt_database_matches_the_jax_tool(tree, monkeypatch, tmp_path):
    out = str(tmp_path / "jax_db.pkl")
    monkeypatch.setattr(sys, "argv", ["create_gt_database.py", "--info-pkl", tree["info"],
                                      "--data-root", tree["root"], "--out", out])
    with jax_tools():
        import create_gt_database as jtool

        jtool.main()
    with open(out, "rb") as f, open(tree["db"], "rb") as g:
        assert_same(pickle.load(g), pickle.load(f))
    assert sum(tree["counts"].values()) > 0


def test_train_cli_steps_log_and_checkpoint(trained):
    steps = trained["steps"]
    assert [r["step"] for r in steps] == [1, 2] and trained["start"] == 0
    for r in steps:
        assert np.isfinite(r["loss"]) and all(np.isfinite(v) for v in r["losses"].values())
        assert set(r["host_ms"]) == {"read", "paste", "collate", "masks", "input"}
        assert {"forward_ms", "backward_ms", "optimizer_ms"} <= set(r)
        assert r["launches"] == {k: 0 for k in r["launches"]}  # plain versions on the CPU
    assert sum(r["host_ms"]["paste"] for r in steps) > 0
    with open(os.path.join(trained["work"], "train_log.jsonl")) as f:
        log = [json.loads(line) for line in f]
    assert [r["step"] for r in log] == [1, 2] and log[0]["loss"] == round(steps[0]["loss"], 4)
    path = ckpt.latest_checkpoint(trained["work"])
    assert path == ckpt.checkpoint_path(trained["work"], 2)
    saved = torch.load(path, weights_only=True)
    assert saved["step"] == 2
    assert_same({k: v.numpy() for k, v in saved["model"].items()},
                {k: v.numpy() for k, v in trained["model"].state_dict().items()})


@pytest.fixture(scope="module")
def resumed(trained, tree):
    """``--resume`` for one more step; what ``load_checkpoint`` restored."""
    restored = []
    load = ckpt.load_checkpoint

    def snapshot(path, model, opt):
        step = load(path, model, opt)
        restored.append((step, {k: v.clone() for k, v in model.state_dict().items()},
                         pickle.loads(pickle.dumps(opt.state_dict()))))
        return step

    saved_opt = pickle.loads(pickle.dumps(trained["opt"].state_dict()))
    ckpt.load_checkpoint = snapshot
    try:
        out = TR.run(tiny_fsf_config(), TR.parse_args(
            ["--model", "fsf", "--tiny", "--cpu", "--max-steps", "3", "--resume", "--work-dir",
             trained["work"], "--gt-db", tree["db"], *_data(tree)]))
    finally:
        ckpt.load_checkpoint = load
    return dict(out, restored=restored, saved_opt=saved_opt)


def test_train_cli_resume_restores_the_saved_state_bitwise(trained, resumed):
    (step, model_state, opt_state), = resumed["restored"]
    assert step == 2 and resumed["start"] == 2 and [r["step"] for r in resumed["steps"]] == [3]
    assert_same({k: v.numpy() for k, v in model_state.items()},
                {k: v.detach().numpy() for k, v in trained["model"].state_dict().items()})

    def host(obj):
        if torch.is_tensor(obj):
            return obj.numpy()
        if isinstance(obj, dict):
            return {k: host(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return [host(v) for v in obj]
        return obj

    assert_same(host(opt_state), host(resumed["saved_opt"]))
    assert ckpt.latest_checkpoint(trained["work"]) == ckpt.checkpoint_path(trained["work"], 3)


def _direct(model, tree, tta_variants=None, n=2):
    """The model called directly on the first ``n`` reader samples (eval
    form)."""
    cfg = tiny_fsf_config()
    reader = NuScenesReader(tree["info"], tree["root"], cfg.fsd.class_names, training=False,
                            with_cbgs=False)
    out = []
    for i in range(n):
        s = reader.sample(i, augment=False)
        cam = CameraData.build(*common.load_masks([s], tree["masks"], cfg.num_classes, (128, 224),
                                                  2), device="cpu")

        def infer(points):
            batch = collate_scene([dict(s, points=points)], cfg.caps.points, cfg.caps.max_gt)
            with torch.inference_mode():
                det = model.get_bboxes(model(common.point_batch(batch, "cpu"), cam, 1), 1)
            det = [t[0].numpy() for t in det]
            return det[0][det[3]], det[1][det[3]], det[2][det[3]]

        if tta_variants is None:
            boxes, scores, labels = infer(s["points"])
        else:
            tail = s["points"][:, -3:]
            union = tta.run_tta(s["points"][:, :-3], tta_variants,
                                lambda live: infer(np.concatenate([live, tail], 1)))
            h = cfg.fsd.head
            res = tta.fuse_union(*union, cfg.num_classes, h.nms_thr, h.score_thr, h.max_num,
                                 device="cpu")
            v = res.valid.numpy()
            boxes, scores, labels = res.boxes.numpy()[v], res.scores.numpy()[v], \
                res.labels.numpy()[v]
        out.append(dict(token=s["token"], boxes=boxes.tolist(), scores=scores.tolist(),
                        labels=labels.tolist()))
    return out


def _checkpoint_model(path):
    cfg = common.model_config(tiny_fsf_config(), "fsf", common.READER_POINT_WIDTH)
    model = common.build_model("fsf", cfg, 0, "cpu")
    assert ckpt.load_model_vars(path, model) == 3
    return model


@pytest.mark.parametrize("tta_flag", [False, True])
def test_test_cli_json_equals_direct_calls(tree, trained, resumed, tmp_path, tta_flag):
    path = ckpt.checkpoint_path(trained["work"], 3)
    out_json = str(tmp_path / "dets.json")
    argv = ["--model", "fsf", "--tiny", "--cpu", "--checkpoint", path, "--eval", "--out",
            out_json, "--tmpdir", str(tmp_path / "shards"), *_data(tree)]
    # TTA: sample 0 only (four forwards a sample)
    res = T.run(tiny_fsf_config(),
                T.parse_args(argv + (["--tta", "--max-samples", "1"] if tta_flag else [])))
    with open(out_json) as f:
        written = json.load(f)
    assert os.listdir(tmp_path / "shards") == ["results_rank000.json"]
    want = _direct(_checkpoint_model(path), tree, tta.tta_grid() if tta_flag else None,
                   n=1 if tta_flag else 2)
    assert written == res["results"] == want
    assert sum(len(r["scores"]) for r in written) > 0
    assert np.isfinite(res["metrics"]["mAP"]) and np.isfinite(res["metrics"]["NDS"])
    for rec in res["samples"]:
        assert rec["read_ms"] > 0 and rec["mask_ms"] > 0 and rec["gpu_ms"] > 0
        assert ("union" in rec) == tta_flag
