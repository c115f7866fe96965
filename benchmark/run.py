"""The benchmark of ``fullysparsefusion_tpu_torch``: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``. It needs as many
CUDA devices as the cell asks for and exits non-zero without them, printing
no result. The last line of standard output is the result's JSON object;
the last lines of standard error are the numbers compared, each beside its
limit. Kernels build into ``build/`` inside the checkout."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "fullysparsefusion_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, os.path.join(ROOT, "build", sub))
    sys.path.insert(0, ROOT)
    if not os.path.isdir(os.path.join(ROOT, "fullysparsefusion_tpu_torch")):
        print("benchmark: the program (fullysparsefusion_tpu_torch) is not in this checkout",
              file=sys.stderr)
        return 2
    from benchmark.harness import manifest

    cell = manifest.cell(manifest.load(ROOT), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    from benchmark.harness import cell as cells

    res, readings = cells.measure(ROOT, args.workload, args.seed, args.seconds,
                                  bool(args.trace), "cuda", T_START)
    found = forbidden_modules()
    if found:
        print(f"benchmark: modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 4
    print("set-up phases (s): " + json.dumps({k: round(v, 3) for k, v in
                                             readings["setup_phases"].items()}), file=sys.stderr)
    for name, c in res.get("not_compared", {}).items():
        print(f"not compared: {name} {c!r}", file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
