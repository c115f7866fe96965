"""launches_per_step: device kernel events per step in the traced stretch."""
from benchmark.harness import readers


def read(r):
    return readers.launches(r, "train")
