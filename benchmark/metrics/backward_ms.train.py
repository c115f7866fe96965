"""backward_ms.train: median CUDA-event ms from mark("forward") to mark("backward")."""
from benchmark.harness import readers


def read(r):
    return readers.span_ms(r, "backward", "train")
