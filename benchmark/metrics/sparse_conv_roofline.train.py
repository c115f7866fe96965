"""sparse_conv_roofline.train: 100 × the least time of a step's sparse
convolutions, forward, input gradient and weight gradient (every rulebook
hit, whichever path runs it; counted from the reference's pass) over the
device time of the kernels that compute them: K1, dw_per_tap's four, and
the dense path's cuDNN convolutions (forward, dgrad, wgrad)."""
from benchmark.harness import readers

KERNELS = ("gather_conv_kernel", "gather_conv_dw_kernel", "sum_chunks_kernel",
           "dw_lists_kernel", "dw_tile_or_kernel", "implicit_gemm", "convolve")


def read(r):
    return readers.roofline(r, "train", KERNELS, ("conv_fwd_s", "conv_bwd_s", "dw_s"))
