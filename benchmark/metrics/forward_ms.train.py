"""forward_ms.train: median CUDA-event ms from a step's start to the train
step's mark("forward") (forward and losses)."""
from benchmark.harness import readers


def read(r):
    return readers.span_ms(r, "forward", "train")
