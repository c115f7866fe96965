"""The port's host tooling on the CPU: ``utils/profiling.py`` (spans off
and on, a ``torch.profiler`` trace that carries them, the spans of the tiny
FSF's forward and train step), ``utils/visualize.py``
against the JAX package's module (the same PNG bytes for the same inputs;
matplotlib is optional, as in ``tests/test_visualize.py``), HTC activation
dumps read across the packages (bitwise), and ``--config`` / ``--vis-dir``
of the train and test entry points.
"""
import json
import os
import time

import numpy as np
import pytest
import torch

from fullysparsefusion_tpu.utils import htc_parity as jparity
from fullysparsefusion_tpu_torch.cli import make_fake_nuscenes as M
from fullysparsefusion_tpu_torch.cli import test as T
from fullysparsefusion_tpu_torch.cli import train as TR
from fullysparsefusion_tpu_torch.config import (av2_fsf_config, nusc_fsf_config,
                                                tiny_fsf_config)
from fullysparsefusion_tpu_torch.config_compat import load_fsf_config
from fullysparsefusion_tpu_torch.utils import htc_parity as tparity
from fullysparsefusion_tpu_torch.utils import profiling
from test_torch_config_compat import FILES
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)


def _annotations(prof):
    return {e.name for e in prof.events()}


def test_span_off_is_the_shared_null_context_and_records_nothing():
    assert profiling._active is None
    first = profiling.span("seg_core")
    assert first is profiling.span("decode") is profiling._NULL
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("span_left_off"):
            torch.arange(10.0).sum()
    assert "span_left_off" not in _annotations(prof)
    with profiling.tracing() as tr:
        pass
    with profiling.span("after_tracing"):
        pass
    assert tr.spans == [] and tr.summary() == {}


def test_tracing_records_parents_host_and_self_time():
    x = torch.arange(1000.0)
    with profiling.tracing() as tr:
        for _ in range(2):
            with profiling.span("outer"):
                with profiling.span("inner"):
                    (x * 2).sum()
                with profiling.span("inner"):
                    time.sleep(0.002)
        with profiling.tracing() as nested:
            assert nested is tr
            with profiling.span("alone"):
                pass
    assert profiling.span("outer") is profiling._NULL
    assert [(s.name, s.parent and s.parent.name) for s in tr.spans[:3]] == [
        ("outer", None), ("inner", "outer"), ("inner", "outer")]
    summary = tr.summary()
    assert list(summary) == ["outer", "inner", "alone"]
    assert summary["outer"]["parent"] is None and summary["inner"]["parent"] == "outer"
    assert [len(summary[k]["host_ms"]) for k in summary] == [2, 4, 1]
    assert all(v["device_ms"] == [] for v in summary.values())
    inner = summary["inner"]["host_ms"]
    for i, (host, own) in enumerate(zip(summary["outer"]["host_ms"], summary["outer"]["self_ms"])):
        assert host >= 2.0 and own >= 0
        assert own == pytest.approx(host - inner[2 * i] - inner[2 * i + 1], abs=1e-6)
    assert summary["inner"]["self_ms"] == summary["inner"]["host_ms"]


def test_device_trace_carries_the_spans(tmp_path):
    x = torch.arange(1000.0)
    with profiling.device_trace(str(tmp_path / "trace")) as tr:
        with profiling.span("fsf_request_span"):
            with profiling.span("fsf_request_child"):
                (x @ x).item()
    assert list(tr.summary()) == ["fsf_request_span", "fsf_request_child"]
    assert profiling._active is None
    with open(tmp_path / "trace" / "trace.json") as f:
        trace = json.load(f)
    names = {ev.get("name") for ev in trace["traceEvents"] if ev.get("cat") == "user_annotation"}
    assert {"fsf_request_span", "fsf_request_child"} <= names


SERVING_SPANS = [("seg_core", None), ("vfe", "seg_core"), ("sparse_unet", "seg_core"),
                 ("seg_head", None), ("camera_queries", None), ("lidar_queries", None),
                 ("foreground", "lidar_queries"), ("clustering", "foreground"),
                 ("fusion", None), ("refine", None), ("roi_points", "refine"), ("decode", None)]


@pytest.fixture(scope="module")
def tiny_fsf():
    from fullysparsefusion_tpu_torch import synthetic as S
    from fullysparsefusion_tpu_torch.weights import build_fsf

    cfg = tiny_fsf_config()
    sc = S.make_scene_arrays(seed=0, n_cap=cfg.caps.points, max_gt=cfg.caps.max_gt)
    cam = S.make_camera_arrays(sc["gt_boxes"], sc["gt_labels"], sc["gt_valid"])
    pb, cd = S.fsf_inputs(sc, cam, device="cpu")
    return build_fsf(cfg, device="cpu"), pb, cd, S.to_ground_truth(sc, device="cpu")


def test_fsf_serving_spans_in_order_and_outputs_unchanged(tiny_fsf):
    model, pb, cam, _ = tiny_fsf
    model.eval()
    with torch.inference_mode():
        off = model.get_bboxes(model(pb, cam, 2), 2)
        with profiling.tracing() as tr:
            on = model.get_bboxes(model(pb, cam, 2), 2)
    for k in off._fields:
        assert torch.equal(getattr(off, k), getattr(on, k)), k
    assert [(s.name, s.parent and s.parent.name) for s in tr.spans] == SERVING_SPANS
    summary = tr.summary()
    top = sum(summary[k]["host_ms"][0] for k, parent in SERVING_SPANS if parent is None)
    assert all(len(v["host_ms"]) == 1 for v in summary.values()) and top > 0


def test_train_step_spans_and_marks(tiny_fsf):
    from fullysparsefusion_tpu_torch.parallel.train import Batch, make_optimizer, train_step
    from fullysparsefusion_tpu_torch.train.hooks import RuntimeSchedule

    model, pb, cam, gt = tiny_fsf
    opt = make_optimizer(model, total_steps=10)
    marks = []

    def mark(phase):
        marks.append((phase, profiling._active.open[:]))

    with profiling.tracing() as tr:
        loss, _, _ = train_step(model, opt, RuntimeSchedule(), Batch(pb, cam, gt, gt), 0, mark)
    assert torch.isfinite(loss)
    assert [(p, o) for p, o in marks] == [("forward", []), ("backward", []), ("optimizer", [])]
    top = [s.name for s in tr.spans if s.parent is None]
    assert top == ["step.forward", "step.backward", "step.optimizer"]
    parents = {s.name: s.parent and s.parent.name for s in tr.spans}
    assert parents["losses"] == "step.forward" and parents["seg_core"] == "step.forward"
    assert "step.allreduce" not in parents
    ends = {s.name: (s.t0, s.t1) for s in tr.spans if s.parent is None}
    assert ends["step.forward"][1] <= ends["step.backward"][0] <= ends["step.backward"][1] \
        <= ends["step.optimizer"][0]


def test_visual_dumps_are_the_jax_modules_bytes(tmp_path):
    pytest.importorskip("matplotlib")
    from fullysparsefusion_tpu.utils import visualize as jvis
    from fullysparsefusion_tpu_torch.utils import visualize as tvis

    rng = np.random.default_rng(0)
    pts = rng.uniform(-20, 20, (500, 3)).astype(np.float32)
    valid = rng.random(500) > 0.1
    gt = np.array([[0, 0, 0, 4, 2, 1.5, 0.3, 0, 0, 1]], np.float32)
    pred = np.array([[0.5, 0.2, 0, 4, 2, 1.5, 0.25, 0, 0, 1],
                     [8, 8, 0, 2, 2, 2, 0, 0, 0, 1]], np.float32)
    lab = np.where(rng.random(500) < 0.2, rng.integers(0, 5, 500), -1)
    fg = rng.random(500) < 0.1
    np.testing.assert_array_equal(tvis.bev_corners(pred), jvis.bev_corners(pred))
    plane = np.zeros((60, 100, 3), np.uint16)
    plane[10:30, 20:50, 0] = 1 | (200 << 8)
    plane[35:55, 60:90, 2] = 2 | (90 << 8)
    for mod in (tvis, jvis):
        d = tmp_path / mod.__name__.split(".")[0]
        mod.dump_bev(str(d / "bev.png"), pts, point_valid=valid, gt_boxes=gt, pred_boxes=pred,
                     pred_scores=np.array([0.9, 0.4]), cluster_labels=lab, fg_mask=fg,
                     extent=25.0, title="scene")
        mod.dump_camera_assignment(str(d / "cam.png"), plane,
                                   boxes2d=np.array([[18, 8, 52, 32]], np.float32),
                                   boxes2d_gt=np.array([[20, 10, 50, 30]], np.float32),
                                   title="cam0")
    for name in ("bev.png", "cam.png"):
        ours = (tmp_path / "fullysparsefusion_tpu_torch" / name).read_bytes()
        theirs = (tmp_path / "fullysparsefusion_tpu" / name).read_bytes()
        assert ours[:8] == b"\x89PNG\r\n\x1a\n" and ours == theirs, name


def test_htc_activation_dumps_read_across_packages(tmp_path):
    rng = np.random.default_rng(0)
    acts = {k: rng.normal(size=(1, 3, 4, 2)).astype(np.float32)
            for k in tparity.ACTIVATION_ORDER[:5]}
    acts["roi.bbox_feats0"] = rng.normal(size=(6, 7, 7, 8)).astype(np.float16)
    tparity.save_activations(acts, str(tmp_path / "torch.npz"))
    jparity.save_activations(acts, str(tmp_path / "jax.npz"))
    for src, load in (("torch", jparity.load_activations), ("jax", tparity.load_activations),
                      ("torch", tparity.load_activations)):
        got = load(str(tmp_path / f"{src}.npz"))
        assert list(got) == list(acts)
        for k, v in acts.items():
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), (src, k)


def test_entry_points_take_the_config_file_given(monkeypatch):
    """``main`` of the train and the test CLI builds
    ``load_fsf_config(--config)``; ``--tiny`` / ``--synthetic`` win over it;
    neither gives ``nusc_fsf_config()``. ``run`` is captured, not executed
    at full width."""
    nusc, av2 = FILES["nuscenes"][0], FILES["av2"][0]
    for cli in (TR, T):
        seen = []
        monkeypatch.setattr(cli, "run", lambda cfg, args: seen.append((cfg, args)) or {})
        for argv in (["--config", av2], ["--config", nusc, "--tiny"],
                     ["--config", av2, "--synthetic"], []):
            cli.main(argv + ["--cpu"])
        got = [cfg for cfg, _ in seen]
        assert got[0] == load_fsf_config(av2) == av2_fsf_config()
        assert got[1] == got[2] == tiny_fsf_config()
        assert got[3] == nusc_fsf_config()
        assert seen[0][1].config == av2 and seen[0][1].cpu


def test_vis_dir_writes_the_entry_points_dumps(tmp_path):
    pytest.importorskip("matplotlib")
    root = str(tmp_path / "nusc")
    info, masks = M.write_dataset(root, n_samples=1, n_sweeps=1, extent=12.0)
    data = ["--info-pkl", info, "--data-root", root, "--mask-dir", masks, "--img-h", "128",
            "--img-w", "224", "--model", "fsf", "--tiny", "--cpu"]
    vis = str(tmp_path / "vis")
    TR.run(tiny_fsf_config(), TR.parse_args(
        data + ["--max-steps", "2", "--work-dir", str(tmp_path / "work"), "--vis-dir", vis,
                "--vis-interval", "1"]))
    res = T.run(tiny_fsf_config(), T.parse_args(
        data + ["--out", str(tmp_path / "dets.json"), "--vis-dir", vis, "--vis-max", "1"]))
    token = res["results"][0]["token"]
    assert sorted(os.listdir(vis)) == sorted(
        ["step000000_bev.png", "step000001_bev.png", f"{token}_bev.png", f"{token}_cam0.png"])
    for f in os.listdir(vis):
        with open(os.path.join(vis, f), "rb") as fh:
            assert fh.read(8) == b"\x89PNG\r\n\x1a\n"
