#!/usr/bin/env python3
"""Where the weight-gradient kernel's time goes, call by call, on the train
step's own inputs, on one NVIDIA GPU.

    python3 tools/time_dw_per_tap.py [--other DIR]   # DIR: root of another checkout

Captures the ``dw_per_tap`` calls of one full-width train step of
``chip_smoke.py`` (random weights, seed-0 bench scene with its own GT, after
one warm-up step), then for each call times by CUDA-graph replay
(``chip_smoke.time_ms``, 20 calls): the whole wrapper (``ms``) and its
work-list kernels alone (``list_ms``); and with ``torch.profiler`` the mean
device time of each kernel the wrapper launches (10 eager calls). With
``--other`` the other checkout's ``dw_per_tap`` (imported under another
module name, built into its own ``build/``) is held to this checkout's plain
version and both wrappers are timed in the order other, this, this, other.

Prints one JSON object per call and one with the sums, then the card's name
and power limit; exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import functools
import importlib
import json
import os
import re
import subprocess
import sys
from collections import defaultdict

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def train_dw_calls():
    """(feats, rows, g, plan) of every dw_per_tap call of one train step."""
    import chip_smoke
    from fullysparsefusion_tpu_torch.ops import sparse_conv
    from fullysparsefusion_tpu_torch.parallel.train import train_step
    from fullysparsefusion_tpu_torch.train.hooks import RuntimeSchedule

    model, opt, batch = chip_smoke.train_setup(chip_smoke.bench_config())
    train_step(model, opt, RuntimeSchedule(), batch, 0)
    calls = []
    with chip_smoke.capture_calls(sparse_conv, "dw_per_tap", calls):
        train_step(model, opt, RuntimeSchedule(), batch, 1)
    torch.cuda.synchronize()
    del model, opt, batch
    torch.cuda.empty_cache()
    return calls


def kernel_split(fn, reps: int = 10) -> dict:
    """Mean device ms per launch, and launches per call, of each kernel
    that ``fn()`` launches."""
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
            name = re.search(r"(gather_conv_dw|sum_chunks|dw_tile_or|dw_lists)_kernel", ev.name)
            ms[name.group(0) if name else ev.name[:48]].append(ev.time_range.elapsed_us() / 1e3)
    return {k: [round(sum(v) / len(v), 5), len(v) / reps] for k, v in ms.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="root of another checkout to time beside this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_dw_per_tap: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from fullysparsefusion_tpu_torch.ops import sparse_conv

    other = None
    if args.other:
        from time_ccl_roots import load_other_package
        load_other_package(args.other)
        other = importlib.import_module("fsf_other.ops.sparse_conv")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    tot = defaultdict(float)
    for i, (feats, rows, g, plan) in enumerate(train_dw_calls()):
        n_src, cin = feats.shape
        k3, n_out = rows.shape
        cout = g.shape[1]
        chip_smoke.check_dw_per_tap(feats, rows, g, plan)
        n_chunks = sparse_conv.dw_chunk_slots(cin, cout, sms, k3)
        work = sparse_conv.dw_work_list(plan, k3, n_chunks)
        call = functools.partial(sparse_conv.dw_per_tap, feats, rows, g, plan)
        row = {"call": i, "n_out": n_out, "cin": cin, "cout": cout,
               "hits": int((rows < n_src).sum()), "hit_tiles": int(work.tap_tiles.sum()),
               "chunks": int((work.chunks[:, 2] > 0).sum()),
               "ms": chip_smoke.time_ms(call, 20),
               "list_ms": chip_smoke.time_ms(
                   functools.partial(sparse_conv.dw_work_list, plan, k3, n_chunks), 20),
               "kernels": kernel_split(call)}
        if other is not None:
            ref = sparse_conv.dw_per_tap_plain(feats, rows, g)
            got = other.dw_per_tap(feats, rows, g, plan)
            err = (got - ref).flatten(1).norm(dim=1) / ref.flatten(1).norm(dim=1).clamp(min=1e-30)
            if float(err.max()) > chip_smoke.DW_RTOL:
                raise SystemExit(f"time_dw_per_tap: the other kernel is off on call {i}")
            ab = {"other_ms": [], "this_ms": []}
            for key, fn in (("other_ms", other.dw_per_tap), ("this_ms", sparse_conv.dw_per_tap),
                            ("this_ms", sparse_conv.dw_per_tap), ("other_ms", other.dw_per_tap)):
                ab[key].append(chip_smoke.time_ms(functools.partial(fn, feats, rows, g, plan), 20))
            row.update(ab)
            tot["other_ms"] += sum(ab["other_ms"]) / 2
        for k in ("ms", "list_ms"):
            tot[k] += row[k]
        for k, (ms, _) in row["kernels"].items():
            tot[k] += ms
        print(json.dumps(row), flush=True)
    print(json.dumps({"sum": dict(tot)}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
