"""idle_share.serve: 100 × (1 − union of device intervals / wall time) of the traced frames."""
from benchmark.harness import readers


def read(r):
    return readers.idle_share(r, "serve")
