// Connected-component roots over a BEV distance graph, sm_90a.
//
// Replaces: fullysparsefusion_tpu/ops/pallas_kernels.py::ccl_sweeps_pallas
// (Pallas body _ccl_kernel), reached from ops/ccl.py:61-76. Contract, per
// problem g: nodes i, j are adjacent iff both are valid, share a batch id
// and dx*dx + dy*dy < 1 (coordinates pre-scaled by the connect distance);
// every valid node is adjacent to itself. roots[g, i] is the minimum node
// index reachable from i, or -1 for an invalid node. Compact relabelling is
// the caller's.
//
// What bounds it: the distance tests, N^2 per sweep per problem, on the
// CUDA cores; the inputs and outputs are a few KB. Only G problems exist
// (6 groups x batch), so at most G SMs are busy: latency, not throughput.
//
// Design: one block per problem; xy, batch, validity and labels live in
// shared memory (N = 1024 -> 16 KB) and the adjacency is recomputed on the
// fly, never stored. Each sweep is min-label propagation over neighbours
// followed by a pointer jump (label = label[label]); labels only decrease
// and always name a node of the same component, so in-place updates are
// safe, and sweeping until a block-wide flag stays clear gives exactly the
// component minimum (the JAX while_loop's converged result). The distance
// is computed with __fmul_rn/__fadd_rn so no FMA contraction changes which
// near-threshold pairs join.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;

__global__ void __launch_bounds__(THREADS)
ccl_roots_kernel(const float* __restrict__ xy, const int* __restrict__ batch,
                 const uint8_t* __restrict__ valid, int n,
                 int* __restrict__ roots) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sx = reinterpret_cast<float*>(smem);
  float* sy = sx + n;
  int* sb = reinterpret_cast<int*>(sy + n);
  volatile int* lab = sb + n;          // labels, n for invalid nodes
  __shared__ int changed;

  const int g = blockIdx.x;
  const float* gxy = xy + (size_t)g * n * 2;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    sx[i] = gxy[2 * i];
    sy[i] = gxy[2 * i + 1];
    const bool v = valid[(size_t)g * n + i] != 0;
    sb[i] = v ? batch[(size_t)g * n + i] : -1;
    lab[i] = v ? i : n;
  }
  __syncthreads();

  while (true) {
    if (threadIdx.x == 0) changed = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int bi = sb[i];
      if (bi < 0) continue;
      const float xi = sx[i], yi = sy[i];
      int m = lab[i];
      for (int j = 0; j < n; ++j) {
        if (sb[j] != bi) continue;       // also skips invalid j (batch -1)
        const float dx = __fsub_rn(xi, sx[j]);
        const float dy = __fsub_rn(yi, sy[j]);
        const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
        if (d2 < 1.0f) {
          const int lj = lab[j];
          m = lj < m ? lj : m;
        }
      }
      const int jumped = lab[m];           // pointer jump
      m = jumped < m ? jumped : m;
      if (m < lab[i]) {
        lab[i] = m;
        changed = 1;
      }
    }
    __syncthreads();
    const int again = changed;   // every thread reads before the next reset
    __syncthreads();
    if (!again) break;
  }

  for (int i = threadIdx.x; i < n; i += blockDim.x)
    roots[(size_t)g * n + i] = sb[i] < 0 ? -1 : lab[i];
}

}  // namespace

// xy [g, n, 2] f32, batch [g, n] i32, valid [g, n] u8, roots [g, n] i32.
// Returns cudaGetLastError().
extern "C" int fsf_ccl_roots(const void* xy, const void* batch, const void* valid,
                             int g, int n, void* roots, void* stream) {
  if (g > 0 && n > 0) {
    const size_t smem = (size_t)n * (2 * sizeof(float) + 2 * sizeof(int));
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(ccl_roots_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    ccl_roots_kernel<<<g, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(xy), static_cast<const int*>(batch),
        static_cast<const uint8_t*>(valid), n, static_cast<int*>(roots));
  }
  return static_cast<int>(cudaGetLastError());
}
