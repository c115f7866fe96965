"""mfu.serve: 100 × a frame's counted operations over (its traced time × 989
TFLOP/s, the H100's dense bf16 peak)."""
from benchmark.harness import readers


def read(r):
    return readers.mfu(r, "serve")
