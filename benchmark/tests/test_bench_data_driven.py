"""The benchmark is driven by data: a configuration, a traffic mix and a
per-layer metric added as new files, with entries in a new manifest, are
found by name, and no existing file changes; so is a second model family
(``fsd_family.py``), served with ``correct`` true. A traffic mix with a key
or a value that the harness does not run is refused, and so are, before
set-up, a configuration that names no family and a cell whose family does
not run its mode. Without a CUDA device, or without the program in the
checkout, the harness exits non-zero and prints no result."""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from benchmark.harness import cell as cells, manifest, traffic
from benchmark.tests import tiny

ROOT = tiny.ROOT


def snapshot(directory):
    out = {}
    for dirpath, _, files in os.walk(directory):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, directory)] = fh.read()
    return out


def test_new_files_are_found_by_name(tmp_path):
    root = tiny.make_checkout(str(tmp_path))
    bench = os.path.join(root, "benchmark")
    before = snapshot(bench)
    with open(os.path.join(bench, "configs", "tiny.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "tiny_wide"
    with open(os.path.join(bench, "configs", "tiny_wide.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "traffic", "tiny_burst.json"), "w") as f:
        json.dump(dict(mode="serve", pool=2, objects=[4, 4], points_on="host",
                       traced_units=1, judged_units=1), f)
    with open(os.path.join(bench, "metrics", "answers_per_window.py"), "w") as f:
        f.write("def read(r):\n    return float(r['units'])\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["configs"].append(dict(name="tiny_wide", source="tests",
                             file="benchmark/configs/tiny_wide.json", reduced=[], why="tests"))
    b["workloads"].append(dict(name="tiny_wide.burst", config="tiny_wide", traffic="tiny_burst",
                               chips=1, why="tests"))
    b["per_layer"].append(dict(name="answers_per_window", unit="1", better="higher",
                               source="host_clock", layer="frame / step", moves="frame_ms",
                               workloads=["tiny_wide.burst"]))
    for m in b["end_to_end"]:
        if "frame_ms" in m["name"] and "workloads" in m:
            m["workloads"].append("tiny_wide.burst")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    after = snapshot(bench)
    assert all(after[k] == v for k, v in before.items())     # no file changed

    m = manifest.load(root)
    cell = manifest.cell(m, "tiny_wide.burst")
    assert manifest.config_file(m, cell, root)["name"] == "tiny_wide"
    assert manifest.traffic_file(cell, bench)["pool"] == 2
    assert [x["name"] for x in manifest.metrics(m, "tiny_wide.burst", "per_layer")] \
        == ["answers_per_window"]
    res = tiny.run(root, "tiny_wide.burst", trace=True)
    assert res["metrics"]["answers_per_window"]["value"] >= 1
    res = tiny.run(root, "tiny_wide.burst")
    assert set(res["metrics"]) == {"frame_ms", "frame_ms_p90", "setup_s"}
    assert res["correct"]


# two task groups that partition nuScenes' ten classes
FSD_TASKS = [["car", "truck", "construction_vehicle", "bus", "trailer"],
             ["barrier", "motorcycle", "bicycle", "pedestrian", "traffic_cone"]]


def tiny_fsd_config() -> dict:
    from benchmark.reference.config import tiny_fsd_config as fsd

    scene = {k: v for k, v in tiny.tiny_config()["scene"].items() if k != "generator"}
    return json.loads(json.dumps(dict(
        name="tiny_fsd", family="fsd", model=dataclasses.asdict(fsd(tasks=FSD_TASKS)),
        scene=scene, limits=dict(moved_share=tiny.TINY_LIMITS["moved_share"]))))


def add_fsd_family(root: str) -> None:
    """The FSD family as files and entries: its family file, configuration,
    a mix and the cell ``tiny_fsd.stream``; and two cells the harness
    refuses: ``tiny_fsd.train`` (the family only serves) and
    ``tiny_nofamily.stream`` (its configuration names no family)."""
    bench = os.path.join(root, "benchmark")
    shutil.copy(os.path.join(tiny.BENCH, "tests", "fsd_family.py"),
                os.path.join(bench, "families", "fsd.py"))
    nofamily = tiny.tiny_config()
    del nofamily["family"]
    nofamily["name"] = "tiny_nofamily"
    for cfg in (tiny_fsd_config(), nofamily):
        with open(os.path.join(bench, "configs", cfg["name"] + ".json"), "w") as f:
            json.dump(cfg, f)
    with open(os.path.join(bench, "traffic", "tiny_fsd_stream.json"), "w") as f:
        json.dump(dict(mode="serve", pool=3, objects=[3, 5], points_on="host", traced_units=1,
                       judged_units=3), f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        b = json.load(f)
    for name in ("tiny_fsd", "tiny_nofamily"):
        b["configs"].append(dict(name=name, source="tests", file=f"benchmark/configs/{name}.json",
                                 reduced=[], why="tests"))
    b["workloads"] += [dict(name="tiny_fsd.stream", config="tiny_fsd",
                            traffic="tiny_fsd_stream", chips=1, why="tests"),
                       dict(name="tiny_fsd.train", config="tiny_fsd", traffic="tiny_train",
                            chips=1, why="tests"),
                       dict(name="tiny_nofamily.stream", config="tiny_nofamily",
                            traffic="tiny_stream", chips=1, why="tests")]
    for m in b["end_to_end"]:
        if "frame_ms" in m["name"] and "workloads" in m:
            m["workloads"].append("tiny_fsd.stream")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)


@pytest.fixture(scope="module")
def fsd_root(tmp_path_factory):
    """A checkout with the FSD family added; (its root, the benchmark's
    files before, after)."""
    root = tiny.make_checkout(str(tmp_path_factory.mktemp("fsd")))
    before = snapshot(os.path.join(root, "benchmark"))
    add_fsd_family(root)
    return root, before, snapshot(os.path.join(root, "benchmark"))


def test_second_family_joins_by_files_alone(fsd_root):
    root, before, after = fsd_root
    assert all(after[k] == v for k, v in before.items())     # no file changed
    assert "families/fsd.py" in after and "families/fsd.py" not in before
    res = tiny.run(root, "tiny_fsd.stream")
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"frame_ms", "frame_ms_p90", "setup_s"}
    assert res["checks"] and all(k.startswith("moved_share.frame") for k in res["checks"])


@pytest.mark.parametrize("cell,match", [("tiny_nofamily.stream", "names no model family"),
                                        ("tiny_fsd.train", "runs \\['serve'\\], not 'train'")])
def test_cell_is_refused_before_set_up(fsd_root, cell, match):
    root = fsd_root[0]
    with pytest.raises(ValueError, match=match):
        cells.Run(root, cell, 2**31 + 5, 1.0, False, "cpu", time.perf_counter(),
                  os.path.join(root, "benchmark"))


def test_a_mix_may_hold_the_keys_its_family_reads():
    with open(os.path.join(tiny.BENCH, "traffic", "stream.json")) as f:
        t = dict(json.load(f), sweeps=3)
    traffic.check(t, family_keys=("sweeps",))
    with pytest.raises(ValueError):
        traffic.check(t)


@pytest.mark.parametrize("change", [dict(batch=4), dict(in_flight=2), dict(mode="offline"),
                                    dict(points_on="disk"), dict(judged_units=None)])
def test_traffic_the_harness_cannot_run_is_refused(change):
    with open(os.path.join(tiny.BENCH, "traffic", "stream.json")) as f:
        t = json.load(f)
    traffic.check(t)
    t.update(change)
    t = {k: v for k, v in t.items() if v is not None}
    with pytest.raises(ValueError):
        traffic.check(t)


def run_py(root, *extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, os.path.join(root, "benchmark", "run.py"),
                           "--workload", "fsf_nusc.stream", "--seed", str(2**31 + 3),
                           "--seconds", "1", "--trace", "0", *extra],
                          capture_output=True, text=True, env=env, cwd=root)


def test_no_card_no_result():
    out = run_py(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_only_the_benchmark_no_result(tmp_path):
    root = str(tmp_path / "bare")
    shutil.copytree(os.path.join(ROOT, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    out = run_py(root)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
