// Sorted segment sum, sm_90a: out[s, c] = the sum over the rows of segment s,
// in ascending row order and from 0, of feat[row, c], for s < capacity.
//
// Replaces: no Pallas kernel. The JAX package leaves segment sums to XLA
// (jax.ops.segment_sum, fullysparsefusion_tpu/ops/segment.py:221); the port's
// segment_sum ran index_put_(accumulate=True) into capacity + 1 rows, whose
// CUDA kernel walks each run of equal ids one row at a time with a
// read-modify-write of the output row in device memory, the trash run of
// invalid and overflow rows included (tens of thousands of dependent round
// trips per call on Argoverse 2's pre-voxelisation).
//
// Input: the CSR of the segment ids, which the caller has without a sort of
// its own (ops/segment.py): order[N] holds the rows stably sorted by segment
// id, so a segment's rows come in ascending row order and the trash rows
// last; segment s is order[offsets[s] .. offsets[s + 1]). The trash rows lie
// past offsets[capacity] and are never read.
//
// What bounds it: bytes. Each valid row's width is read once and each
// segment's written once: (valid rows x width + capacity x width) x 4 bytes,
// plus 4 bytes of order per row and of offsets per segment, over 3.35 TB/s.
// Argoverse 2's pre-voxelisation, five calls of widths 4, 27, 81, 131 and 81
// (324 columns) from ~64k valid rows of 131,072 into 98,304 segments, reads
// ~82 MB and writes ~127 MB: ~0.06 ms. The output, zeros of empty segments
// included, is most of it.
//
// Design: one thread per (segment, group of VEC columns). VEC is 4 (16-byte
// loads and stores) where the width, the row stride and the base pointer
// allow it, else 2, else 1. Lanes run over the columns of a segment's row,
// coalesced; a segment narrower than a warp shares the warp with its
// neighbours (width 4: 32 segments a warp; width 1: 32), so a run of short
// segments costs one warp, and a wide segment (128 columns, VEC 4) takes a
// warp alone. Each thread sums its columns in f32 registers over the
// segment's rows in ascending row order and stores once: the plain version's
// arithmetic (ops/segment.segment_sum_plain), bitwise, with no atomics and no
// tree. The row loop is unrolled (8 rows at VEC 4, 16 below) so that its
// loads are in flight together, and the next rows' indices are loaded while
// those loads are waited for: a long segment (a cluster of a few thousand
// rows) costs about one memory latency per unrolled step. Empty segments
// store 0.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  typedef float T;
  static __device__ __forceinline__ T zero() { return 0.0f; }
  static __device__ __forceinline__ void add(T& a, T b) { a = a + b; }
};
template <>
struct Vec<2> {
  typedef float2 T;
  static __device__ __forceinline__ T zero() { return make_float2(0.0f, 0.0f); }
  static __device__ __forceinline__ void add(T& a, T b) {
    a.x = a.x + b.x;
    a.y = a.y + b.y;
  }
};
template <>
struct Vec<4> {
  typedef float4 T;
  static __device__ __forceinline__ T zero() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
  static __device__ __forceinline__ void add(T& a, T b) {
    a.x = a.x + b.x;
    a.y = a.y + b.y;
    a.z = a.z + b.z;
    a.w = a.w + b.w;
  }
};

// groups = width / VEC column groups a row; total = capacity * groups threads
template <int VEC, int UNROLL>
__global__ void __launch_bounds__(THREADS)
segment_sum_kernel(const float* __restrict__ feat, long long ld, int groups,
                   const int* __restrict__ order, const int* __restrict__ offsets,
                   long long total, float* __restrict__ out) {
  typedef Vec<VEC> V;
  typedef typename V::T T;
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= total) return;
  const long long s = t / groups;
  const int g = static_cast<int>(t - s * groups);
  const int begin = offsets[s], end = offsets[s + 1];
  const float* col = feat + (long long)g * VEC;
  T acc = V::zero();
  int idx[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) idx[u] = begin + u < end ? order[begin + u] : 0;
  for (int k = begin; k < end; k += UNROLL) {
    T v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      v[u] = k + u < end ? *reinterpret_cast<const T*>(col + idx[u] * ld) : V::zero();
    const int next = k + UNROLL;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) idx[u] = next + u < end ? order[next + u] : 0;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (k + u < end) V::add(acc, v[u]);
  }
  *reinterpret_cast<T*>(out + t * VEC) = acc;
}

template <int VEC, int UNROLL>
int launch(const float* feat, long long ld, int width, const int* order, const int* offsets,
           int capacity, float* out, cudaStream_t st) {
  const int groups = width / VEC;
  const long long total = (long long)capacity * groups;
  const long long blocks = (total + THREADS - 1) / THREADS;
  segment_sum_kernel<VEC, UNROLL><<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(
      feat, ld, groups, order, offsets, total, out);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, long long ld, int width, int vec) {
  return reinterpret_cast<uintptr_t>(p) % (4 * vec) == 0 && ld % vec == 0 && width % vec == 0;
}

}  // namespace

// feat: rows of `width` f32 columns, row r at feat + r * ld; order [N] i32;
// offsets [capacity + 1] i32; out [capacity, width] f32, contiguous.
extern "C" int fsf_segment_sum(const void* feat, long long ld, int width, const void* order,
                               const void* offsets, int capacity, void* out, void* stream) {
  if (capacity <= 0 || width <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(feat);
  const int* o = static_cast<const int*>(order);
  const int* off = static_cast<const int*>(offsets);
  float* y = static_cast<float*>(out);
  if (aligned(f, ld, width, 4) && aligned(y, width, width, 4))
    return launch<4, 8>(f, ld, width, o, off, capacity, y, st);
  if (aligned(f, ld, width, 2) && aligned(y, width, width, 2))
    return launch<2, 16>(f, ld, width, o, off, capacity, y, st);
  return launch<1, 16>(f, ld, width, o, off, capacity, y, st);
}
