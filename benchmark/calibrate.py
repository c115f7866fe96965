"""The readings that the limits of ``correct`` are set from (see PERF.md).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds 3]

For each seed of ``--seeds`` it makes a run of the cell as ``run.py`` does,
with a short window, and prints the numbers compared; for each seed of
``--control-seeds`` it makes the same run with the control in the
program's place: the reference in the precision one step below the
configuration's (``reference/precision.py``). Everything runs in one
process, one run after the other. Needs the cell's CUDA devices.

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
def control():
    """The control in the program's place inside the block: the reference
    in the precision one step down, built as the program would be; the
    judge's own reference runs in the configuration's precision."""
    from benchmark.harness import cell, sides
    from benchmark.reference import precision

    saved = (sides.program_model, sides.program_inputs, cell._judge_serve, cell._judge_train)
    judge_serve, judge_train = saved[2], saved[3]

    def lowered(cfg_file, state, device):
        m = sides.reference_model(cfg_file, device)
        m.load_state_dict(state, strict=True)
        return precision.lower_linears(m).eval()

    def judged(fn):
        def run(*a, **k):
            precision.LOW = False
            return fn(*a, **k)
        return run

    sides.program_model, sides.program_inputs = lowered, sides.reference_inputs
    cell._judge_serve, cell._judge_train = judged(judge_serve), judged(judge_train)
    precision.LOW = True
    try:
        yield
    finally:
        sides.program_model, sides.program_inputs, cell._judge_serve, cell._judge_train = saved
        precision.LOW = False


def _plain_gather(reverse: bool):
    def gather_conv(feats, rows, w, plan=None):
        n_src, cin = feats.shape
        f_z = torch.cat([feats, feats.new_zeros(1, cin)]).float()
        wf = w.float()
        out = torch.zeros(rows.shape[1], w.shape[2], dtype=torch.float32, device=feats.device)
        taps = range(rows.shape[0])
        for k in (reversed(taps) if reverse else taps):
            out += f_z[rows[k].long()] @ wf[k]
        return out

    gather_conv.launches = 0
    return gather_conv


@contextlib.contextmanager
def program_path(kind: str):
    """The program's K1 and dw_per_tap as ``kind`` says inside the block."""
    if kind == "kernels":
        yield
        return
    from fullysparsefusion_tpu_torch.ops import sparse_conv

    saved = sparse_conv.gather_conv, sparse_conv.dw_per_tap

    def dw_per_tap(feats, rows, g, plan=None):
        return sparse_conv.dw_per_tap_plain(feats, rows, g)

    dw_per_tap.launches = 0
    sparse_conv.gather_conv = _plain_gather(kind == "plain_reversed")
    sparse_conv.dw_per_tap = dw_per_tap
    try:
        yield
    finally:
        sparse_conv.gather_conv, sparse_conv.dw_per_tap = saved


@contextlib.contextmanager
def fault(kind: str):
    """The program's backward with fault ``kind`` inside the block."""
    if kind == "none":
        yield
        return
    from fullysparsefusion_tpu_torch.ops import sparse_conv

    fn = sparse_conv.GatherConvFunction
    saved = sparse_conv.dw_per_tap, fn.backward
    if kind == "dw_taps_reversed":
        def dw_per_tap(*a, **k):
            return saved[0](*a, **k).flip(0)

        dw_per_tap.launches = 0
        sparse_conv.dw_per_tap = dw_per_tap
    elif kind == "dfeats_scaled":
        def backward(ctx, g):
            d_feats, *rest = saved[1](ctx, g)
            return (None if d_feats is None else d_feats * 1.25, *rest)

        fn.backward = staticmethod(backward)
    else:
        raise ValueError(f"unknown fault {kind!r}")
    try:
        yield
    finally:
        sparse_conv.dw_per_tap, fn.backward = saved[0], staticmethod(saved[1])


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

    cell.Run.detection_from_override = args.detection_from
    for kind, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        for seed in [int(s) for s in seeds.split(",") if s]:
            t0 = time.perf_counter()
            with control() if kind == "control" else program_path(args.program_path), \
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
