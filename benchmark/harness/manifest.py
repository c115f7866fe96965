"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration (``benchmark/configs/<file>`` as the manifest
gives it) and a traffic mix (``benchmark/traffic/<traffic>.json``); every
metric is read by ``benchmark/metrics/<name>.py``. Adding a cell, a
configuration, a traffic mix or a metric is adding files and entries: no
file here changes."""
from __future__ import annotations

import importlib.util
import json
import os
from typing import Any, Callable, Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load(root: str = ROOT) -> Dict[str, Any]:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _named(entries: List[Dict[str, Any]], name: str, what: str) -> Dict[str, Any]:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(manifest, name: str) -> Dict[str, Any]:
    return _named(manifest["workloads"], name, "workload")


def config_file(manifest, cell_entry, root: str = ROOT) -> Dict[str, Any]:
    entry = _named(manifest["configs"], cell_entry["config"], "config")
    with open(os.path.join(root, entry["file"])) as f:
        return json.load(f)


def traffic_file(cell_entry, bench_dir: str = BENCH_DIR) -> Dict[str, Any]:
    with open(os.path.join(bench_dir, "traffic", cell_entry["traffic"] + ".json")) as f:
        return json.load(f)


def metrics(manifest, cell_name: str, kind: str) -> List[Dict[str, Any]]:
    """The ``end_to_end`` or ``per_layer`` metrics that cell ``cell_name``
    reports: those without a ``workloads`` key, and those that list it."""
    return [m for m in manifest[kind] if cell_name in m.get("workloads", [cell_name])]


def reader(name: str, bench_dir: str = BENCH_DIR) -> Callable:
    """``read`` of ``benchmark/metrics/<name>.py``."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
