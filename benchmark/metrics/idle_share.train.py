"""idle_share.train: 100 × (1 − union of device intervals / wall time) of the traced steps."""
from benchmark.harness import readers


def read(r):
    return readers.idle_share(r, "train")
