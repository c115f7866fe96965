"""foreground_ms.serve: median CUDA-event ms of the foreground extraction that
the FSD branch calls (``fsd_branch.extract_foreground``) per frame."""
from benchmark.harness import readers


def read(r):
    return readers.span_ms(r, "foreground", "serve")
