"""mfu.train: 100 × a step's counted operations (forward, backward) over
(its traced time × 989 TFLOP/s, the H100's dense bf16 peak)."""
from benchmark.harness import readers


def read(r):
    return readers.mfu(r, "train")
