"""A checkout of the benchmark at a size that a CPU test holds: a copy of
``benchmark/`` with the tiny FSF configuration and two cells that use it."""
from __future__ import annotations

import dataclasses
import json
import os
import shutil

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

# the tiny cells' limits: on one CPU thread the program's plain path reads 0
# on every number (it serves the reference's detections and takes its steps
# bitwise); seeds 1-3 of the control read 0.06 or more on moved_share,
# 1.5e-3 to 5.5e-3 on seg_loss_gap, 0.28 to 0.41 on grad_leaf_gap and 0.84
# to 0.87 on grad_diff_gap; the backward's faults (dw_per_tap's taps
# reversed, the input gradients times 1.25) 0.73 to 1.38 on grad_diff_gap; a
# state left unchanged reads 1 on grad_leaf_gap and change_leaf_gap
TINY_LIMITS = dict(moved_share=0.02, seg_loss_gap=5e-4, grad_leaf_gap=0.1,
                   change_leaf_gap=0.4, grad_diff_gap=0.2)

def tiny_config() -> dict:
    from benchmark.reference.config import tiny_fsf_config

    return json.loads(json.dumps(dict(
        name="tiny", family="fsf", model=dataclasses.asdict(tiny_fsf_config()),
        scene=dict(generator="lidar_scene", point_dim=5, extent=10.0, n_rings=4,
                   pts_per_ring=300, n_walls=2, sweeps=2),
        cameras=dict(num_cams=2, img_h=64, img_w=96, max_anno=32, fx=40.0),
        train=dict(base_lr=1e-4, total_steps=100, weight_decay=0.01, grad_clip_norm=35.0,
                   lr_mult_rules={"seg_core": 0.2}, enable_detection_step=3),
        limits=TINY_LIMITS)))


def make_checkout(tmp: str) -> str:
    """A checkout under ``tmp`` (the benchmark's files and a manifest with
    ``tiny.stream`` and ``tiny.train`` added); returns its root."""
    root = os.path.join(tmp, "checkout")
    shutil.copytree(BENCH, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(root, "benchmark", "configs", "tiny.json"), "w") as f:
        json.dump(tiny_config(), f)
    for name, base in (("tiny_stream", "stream"), ("tiny_train", "train_av2")):
        with open(os.path.join(BENCH, "traffic", base + ".json")) as f:
            t = json.load(f)
        t.update(pool=3, objects=[3, 5], traced_units=1)
        if base == "stream":
            t["judged_units"] = 3
        with open(os.path.join(root, "benchmark", "traffic", name + ".json"), "w") as f:
            json.dump(t, f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["configs"].append(dict(name="tiny", source="tests", file="benchmark/configs/tiny.json",
                             reduced=[], why="CPU tests"))
    b["workloads"] += [dict(name="tiny.stream", config="tiny", traffic="tiny_stream", chips=1,
                            why="CPU tests"),
                       dict(name="tiny.train", config="tiny", traffic="tiny_train", chips=1,
                            why="CPU tests")]
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m:
            m["workloads"] += ["tiny.stream", "tiny.train"]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    return root


def run(root: str, cell: str, seed: int = 2**31 + 11, seconds: float = 1.0, trace=False):
    import time

    from benchmark.harness import cell as cells

    return cells.run_cell(root, cell, seed, seconds, trace, "cpu", time.perf_counter(),
                          os.path.join(root, "benchmark"))
