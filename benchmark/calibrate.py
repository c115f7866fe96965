"""The readings that the limits of ``correct`` are set from (see PERF.md).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds 3]

For each seed of ``--seeds`` it makes a run of the cell as ``run.py`` does,
with a short window, and prints the numbers compared; for each seed of
``--control-seeds`` it makes the same run with the control in the
program's place: the reference in the precision one step below the
configuration's (``reference/precision.py``). Everything runs in one
process, one run after the other. Needs the cell's CUDA devices. The
control, the witness and the faults below are context managers of the
configuration's family (``benchmark/families/<family>.py``), entered
around each run.

The witness of a training cell's discrete decisions (PERF.md):
``--detection-from 0`` checks steps that detect, and ``--program-path``
runs the program with its sparse convolutions' plain arithmetic in place of
K1 and dw_per_tap (``plain``: the reference's order of the taps;
``plain_reversed``: the taps summed in the reverse order, a change of
rounding alone).

``--fault`` plants a fault in the program's backward for the training
cells' upper readings: ``dw_taps_reversed`` (dw_per_tap's weight gradient
with its taps in reverse order) or ``dfeats_scaled`` (each sparse
convolution's input gradient times 1.25)."""
import argparse
import contextlib
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def _variant(name: str, *args):
    """The runs inside the block with the family's context manager ``name``
    entered around each (``cell.Run.variants``)."""
    from benchmark.harness import cell

    saved = cell.Run.variants
    cell.Run.variants = saved + ((name, *args),)
    try:
        yield
    finally:
        cell.Run.variants = saved


def control():
    """The control in the program's place inside the block: the reference
    in the precision one step down, built as the program would be; the
    judge's own reference runs in the configuration's precision."""
    return _variant("control")


def program_path(kind: str):
    """The program's K1 and dw_per_tap as ``kind`` says inside the block."""
    return contextlib.nullcontext() if kind == "kernels" else _variant("program_path", kind)


def fault(kind: str):
    """The program's backward with fault ``kind`` inside the block."""
    return contextlib.nullcontext() if kind == "none" else _variant("fault", kind)


def detection_from(step):
    """The detection terms counted from ``step`` inside the block (None:
    the configuration's step)."""
    return contextlib.nullcontext() if step is None else _variant("detection_from", step)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--leaves", default="",
                   help="write each training run's per-leaf norms, one JSON line a run")
    p.add_argument("--detection-from", type=int, default=None,
                   help="the step from which the detection terms count (witness only)")
    p.add_argument("--program-path", default="kernels",
                   choices=("kernels", "plain", "plain_reversed"))
    p.add_argument("--fault", default="none", choices=("none", "dw_taps_reversed", "dfeats_scaled"))
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 3
    from benchmark.harness import cell

    for kind, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        for seed in [int(s) for s in seeds.split(",") if s]:
            t0 = time.perf_counter()
            with detection_from(args.detection_from), \
                    control() if kind == "control" else program_path(args.program_path), \
                    fault(args.fault):
                res, readings = cell.measure(ROOT, args.workload, seed, args.seconds, False,
                                             "cuda", t0)
            print(json.dumps({"workload": args.workload, "side": kind, "seed": seed,
                              "path": args.program_path, "detection_from": args.detection_from,
                              "fault": args.fault,
                              "correct": res["correct"], "checks": res["checks"],
                              "not_compared": res.get("not_compared"),
                              "detail": readings.get("detail"),
                              "seconds": round(time.perf_counter() - t0, 2)}), flush=True)
            if args.leaves and "leaves" in readings:
                with open(args.leaves, "a") as f:
                    f.write(json.dumps({"side": kind, "seed": seed, **readings["leaves"]}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
