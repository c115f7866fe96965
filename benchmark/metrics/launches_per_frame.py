"""launches_per_frame: device kernel events per frame in the traced stretch."""
from benchmark.harness import readers


def read(r):
    return readers.launches(r, "serve")
