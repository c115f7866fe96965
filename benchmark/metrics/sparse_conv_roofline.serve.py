"""sparse_conv_roofline.serve: 100 × the least time of a frame's sparse
convolutions (every rulebook hit, whichever path runs it; counted from the
reference's pass) over the device time of the kernels that compute them:
K1 and the dense path's cuDNN convolutions."""
from benchmark.harness import readers

KERNELS = ("gather_conv_kernel", "implicit_gemm", "convolve")


def read(r):
    return readers.roofline(r, "serve", KERNELS, ("conv_fwd_s",))
