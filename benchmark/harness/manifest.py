"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration (``benchmark/configs/<file>`` as the manifest
gives it) and a traffic mix (``benchmark/traffic/<traffic>.json``); the
configuration names its model family (``"family"``), whose code is
``benchmark/families/<family>.py``; every metric is read by
``benchmark/metrics/<name>.py``. Adding a cell, a configuration, a traffic
mix, a metric or a model family is adding files and entries: no file here
changes."""
from __future__ import annotations

import importlib.util
import json
import os
import sys
from types import ModuleType
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


def _module(path: str, name: str) -> ModuleType:
    """The file at ``path`` executed as module ``name`` (in ``sys.modules``,
    where dataclasses look their module up)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, bench_dir: str = BENCH_DIR) -> Callable:
    """``read`` of ``benchmark/metrics/<name>.py``."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    return _module(path, "benchmark_metric_" + name.replace(".", "_")).read


def family(cfg_file: Dict[str, Any], bench_dir: str = BENCH_DIR) -> ModuleType:
    """``benchmark/families/<family>.py`` of a configuration file, loaded
    anew; ValueError where the configuration names none, or no such file."""
    name = cfg_file.get("family")
    path = os.path.join(bench_dir, "families", f"{name}.py")
    if not isinstance(name, str) or not os.path.isfile(path):
        raise ValueError(f"configuration {cfg_file.get('name')!r} names no model family "
                         f"(\"family\": {name!r}): it needs the name of a file under "
                         "benchmark/families/")
    return _module(path, "benchmark_family_" + name)
