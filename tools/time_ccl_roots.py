#!/usr/bin/env python3
"""The CCL-roots kernel (K2) of this checkout against another checkout's, on
one NVIDIA GPU, in one process.

    python3 tools/time_ccl_roots.py --other DIR   # DIR: root of another checkout

Loads this checkout's ``fullysparsefusion_tpu_torch`` and DIR's (under another
module name, so each builds its own ``csrc/ccl.cu`` into its own ``build/``),
then takes the K2 call of one bench-scale request of ``chip_smoke.py``
(full-width FSF, random weights, scene seed 0) and the problems of
``chip_smoke.CCL_ADVERSARIAL``. On each, both kernels must equal this
checkout's plain version bitwise, and each is timed by ``chip_smoke.time_ms``
(CUDA-graph replay of 20 calls) in the order other, this, this, other (the
other only where it takes the problem's N); then
``torch.profiler`` gives the mean device time of each kernel that each
checkout launches (over 10 eager calls; a launch the profiler drops does not
bias the mean). Last, each of ``chip_smoke.CCL_KNOWN_CASES`` (50,000 nodes,
``parent[]`` past shared memory) runs ``KNOWN_RUNS`` times on each side
against its known components: a race in the union-find shows as runs with
wrong roots, which are counted for the other checkout and fail this one.

Prints one JSON object per problem, then the card's name and power limit;
exits non-zero without a CUDA device or on a mismatch.
"""
from __future__ import annotations

import argparse
import functools
import importlib
import importlib.util
import json
import os
import re
import subprocess
import sys
from collections import defaultdict

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

KNOWN_RUNS = 50


def load_other_package(root: str, name: str = "fsf_other"):
    """Import ``root/fullysparsefusion_tpu_torch`` as package ``name``."""
    pkg = os.path.join(os.path.abspath(root), "fullysparsefusion_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"), submodule_search_locations=[pkg])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return importlib.import_module(f"{name}.ops.ccl")


def request_call():
    """(xy, batch, valid) of the K2 call of one bench-scale request."""
    import chip_smoke
    from fullysparsefusion_tpu_torch.ops import ccl
    from fullysparsefusion_tpu_torch.weights import build_fsf

    cfg = chip_smoke.bench_config()
    model = build_fsf(cfg, seed=0, device="cuda")
    calls = []
    with torch.no_grad(), chip_smoke.capture_calls(ccl, "ccl_roots", calls):
        model.get_bboxes(model(*chip_smoke.bench_request(0, cfg), 1), 1)
    torch.cuda.synchronize()
    (call,) = calls
    return call


def kernel_split(fn, reps: int = 10) -> dict:
    """Mean device ms per launch of each kernel that ``fn()`` launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ms = defaultdict(list)
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            name = re.search(r"ccl_[a-z_]+", ev.name)
            ms[name.group(0) if name else ev.name[:40]].append(ev.time_range.elapsed_us() / 1e3)
    return {k: round(sum(v) / len(v), 5) for k, v in ms.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, help="root of the other checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_ccl_roots: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from fullysparsefusion_tpu_torch import synthetic as S
    from fullysparsefusion_tpu_torch.ops import ccl

    other = load_other_package(args.other)
    problems = [("request", request_call())]
    for case, g, n in chip_smoke.CCL_ADVERSARIAL:
        problems.append((f"{case}_g{g}_n{n}", tuple(
            torch.as_tensor(a, device="cuda") for a in S.ccl_problem_arrays(case, g, n))))
    for name, (xy, batch, valid) in problems:
        ref = ccl.ccl_roots_plain(xy, batch, valid)
        row = {"problem": name, "G": valid.shape[0], "N": valid.shape[1],
               "valid_nodes": int(valid.sum()), "plain_sweeps": ccl.ccl_roots_plain.sweeps,
               "other_ms": [], "this_ms": []}
        mods = (("other", other), ("this", ccl), ("this", ccl), ("other", other))
        try:
            other.ccl_roots(xy, batch, valid)
        except ValueError as e:                # an older checkout's size cap
            row["other_refused"] = str(e)
            mods = mods[1:3]
        for key, mod in mods:
            if not torch.equal(mod.ccl_roots(xy, batch, valid), ref):
                raise SystemExit(f"time_ccl_roots: {key} kernel differs on {name}")
            row[f"{key}_ms"].append(chip_smoke.time_ms(
                functools.partial(mod.ccl_roots, xy, batch, valid), 20))
        for key, mod in dict(mods).items():
            row[f"{key}_kernels"] = kernel_split(functools.partial(mod.ccl_roots, xy, batch, valid))
        print(json.dumps(row), flush=True)
    n = chip_smoke.CCL_KNOWN_N
    for chain, _ in chip_smoke.CCL_KNOWN_CASES:
        xy, batch, valid, roots = (torch.as_tensor(a, device="cuda")
                                   for a in S.ccl_known_components(n, chain=chain))
        row = {"problem": f"known_components_chain{chain}_g1_n{n}", "runs": KNOWN_RUNS}
        for key, mod in (("other", other), ("this", ccl)):
            try:
                wrong = [int((mod.ccl_roots(xy, batch, valid) != roots).sum())
                         for _ in range(KNOWN_RUNS)]
            except ValueError as e:            # an older checkout's size cap
                row[f"{key}_refused"] = str(e)
                continue
            row[f"{key}_wrong_runs"] = sum(w > 0 for w in wrong)
            row[f"{key}_most_wrong_nodes"] = max(wrong)
        print(json.dumps(row), flush=True)
        if row["this_wrong_runs"]:
            raise SystemExit(f"time_ccl_roots: this kernel misses the known components of {row}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
