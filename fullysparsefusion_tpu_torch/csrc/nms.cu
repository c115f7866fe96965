// Greedy NMS keep masks for all class channels in one launch, sm_90a.
//
// Replaces: fullysparsefusion_tpu/ops/pallas_kernels.py::nms_scan_pallas
// (Pallas body _nms_kernel), reached from ops/nms.py:50-54 and run once per
// class by multiclass_nms_bev_batched. Contract, per class c: walking the
// rows in that class's descending-score order, row i is kept iff it is
// valid and no earlier kept row has IoU > thr with it.
//
// What bounds it: the scan is sequential in i; each kept row reads its
// IoU row once (N floats, gathered through the class's order), so a class
// reads at most N x N floats and the wall time is N block-wide steps.
//
// Design: one block per class channel. Inputs are the shared IoU matrix
// [N, N] in the boxes' original order, each class's stable score order
// order[C, N] and its sorted validity; the block keeps the suppressed set in
// shared memory and, for each kept row, its threads mark
// iou[order[i], order[j]] > thr for j > i in parallel, then synchronise.
// Rows that cannot be kept cost no barrier. No permuted copy of the IoU
// matrix is built for any class.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
nms_keep_kernel(const float* __restrict__ iou, const int* __restrict__ order,
                const uint8_t* __restrict__ valid_sorted, int n, float thr,
                uint8_t* __restrict__ keep_sorted) {
  extern __shared__ uint8_t sup[];
  const int c = blockIdx.x;
  const int* ord = order + (size_t)c * n;
  const uint8_t* vs = valid_sorted + (size_t)c * n;
  uint8_t* keep = keep_sorted + (size_t)c * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    sup[j] = 0;
    keep[j] = 0;
  }
  __syncthreads();
  for (int i = 0; i < n; ++i) {
    // uniform across the block: sup[i] was last written before a barrier
    if (!vs[i] || sup[i]) continue;
    if (threadIdx.x == 0) keep[i] = 1;
    const float* row = iou + (size_t)ord[i] * n;
    for (int j = i + 1 + threadIdx.x; j < n; j += blockDim.x)
      if (row[ord[j]] > thr) sup[j] = 1;
    __syncthreads();
  }
}

}  // namespace

// iou [n, n] f32, order [c, n] i32, valid_sorted [c, n] u8,
// keep_sorted [c, n] u8. Returns cudaGetLastError().
extern "C" int fsf_nms_keep(const void* iou, const void* order,
                            const void* valid_sorted, int c, int n, float thr,
                            void* keep_sorted, void* stream) {
  if (c > 0 && n > 0) {
    if (n > 48 * 1024)
      cudaFuncSetAttribute(nms_keep_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, n);
    nms_keep_kernel<<<c, THREADS, n, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(iou), static_cast<const int*>(order),
        static_cast<const uint8_t*>(valid_sorted), n, thr,
        static_cast<uint8_t*>(keep_sorted));
  }
  return static_cast<int>(cudaGetLastError());
}
