"""seg_core_ms.serve: median CUDA-event ms of the segmentor core (voxelize,
VFE, sparse UNet: the program's ``seg_core`` module) per frame."""
from benchmark.harness import readers


def read(r):
    return readers.span_ms(r, "seg_core", "serve")
