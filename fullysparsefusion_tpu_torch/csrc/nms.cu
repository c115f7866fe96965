// Greedy NMS keep masks for all class channels, sm_90a: a parallel bitmask
// pass, then one warp per class scanning the bits.
//
// Replaces: fullysparsefusion_tpu/ops/pallas_kernels.py::nms_scan_pallas
// (Pallas body _nms_kernel), reached from ops/nms.py:50-54 and run once per
// class by multiclass_nms_bev_batched. Contract, per class c: walking the
// rows in that class's descending-score order, row i is kept iff it is
// valid and no earlier kept row has IoU > thr with it.
//
// What bounds it: the bytes of the IoU matrix (read once) and of the orders
// and validities; the compares are few. Between the two stands the scan's
// dependence of row i on every earlier row.
//
// Design:
// (a) nms_mask_kernel, a grid over (class, block of 8 rows), one warp per
//     valid row i (the class's order in shared memory up to 12,288 rows,
//     read through L1 past that): it writes mask[c, i, w], the 64 bits of
//     the rows j > i in word w with iou[order[c, i], order[c, j]] > thr,
//     for every word w >= i / 64 (the scan reads no other). The warp's
//     reads stay inside the IoU row of order[c, i], so after its first
//     touch of a line they hit L1. Invalid rows are never kept and are not
//     written.
// (b) nms_scan_kernel, one warp per class, no block barriers: it walks the
//     words in order, the block of 64 rows of word wb (64 x W words, one
//     contiguous range) brought into shared memory by cp.async while the
//     previous block is scanned. Where two such blocks do not fit in a
//     block's shared memory (N past ~14,700 on an H100), the warp reads
//     each block where the mask pass left it, in device memory (L2), and
//     only the removed words stay in shared memory: any N whose C * N^2 / 8
//     bytes of mask fit on the card. Within a block the candidates are the
//     valid rows not yet removed; one that no candidate's diagonal word
//     removes is kept at once (warp OR-reductions over the lanes, which
//     hold the diagonal words), the others are resolved in order with a
//     shuffle per kept row. Then each lane ORs the kept rows' words into the
//     removed words it owns.
//     Both choices are template parameters, so each instance's loads know
//     their address space (as run-time choices through generic loads the
//     request's call took 0.042 ms instead of 0.034 in chip_smoke.py on an
//     NVIDIA H100 80GB HBM3 at 700 W).
// The compares are the same `>` on the same floats as nms_keep_plain, so the
// keep masks equal it bit for bit, ties included.
#include <cuda_runtime.h>
#include <stdint.h>

#include "device.cuh"

namespace {

typedef unsigned long long u64;

constexpr unsigned FULL = 0xffffffffu;
constexpr int MASK_THREADS = 256;
constexpr int MASK_ROWS = MASK_THREADS / 32;   // one warp per row in the mask pass
constexpr int MASK_SMEM_ROWS = 12 * 1024;       // orders staged in the default 48 KB

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ORD_SMEM: the class's order is copied to shared memory (N <= 12,288, under
// the default 48 KB); past that the warps read it through L1
template <bool ORD_SMEM>
__global__ void __launch_bounds__(MASK_THREADS)
nms_mask_kernel(const float* __restrict__ iou, const int* __restrict__ order,
                const uint8_t* __restrict__ valid_sorted, int n, int words, float thr,
                u64* __restrict__ mask) {
  extern __shared__ int ord_smem[];
  const int c = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31;
  const int i = blockIdx.x * MASK_ROWS + (tid >> 5);   // this warp's row
  const int* oc = order + static_cast<size_t>(c) * n;
  if (ORD_SMEM) {
    for (int j = tid; j < n; j += MASK_THREADS) ord_smem[j] = oc[j];
    __syncthreads();
  }
  auto ord = [&](int j) { return ORD_SMEM ? ord_smem[j] : __ldg(oc + j); };
  if (i >= n || !valid_sorted[static_cast<size_t>(c) * n + i]) return;
  const float* row = iou + static_cast<size_t>(ord(i)) * n;
  u64* out = mask + (static_cast<size_t>(c) * 64 * words + i) * words;
  for (int w = i >> 6; w < words; ++w) {
    const int j0 = w * 64 + lane, j1 = j0 + 32;
    const bool b0 = j0 > i && j0 < n && __ldg(row + ord(j0)) > thr;
    const bool b1 = j1 > i && j1 < n && __ldg(row + ord(j1)) > thr;
    const unsigned lo = __ballot_sync(FULL, b0);
    const unsigned hi = __ballot_sync(FULL, b1);
    if (lane == 0) out[w] = (static_cast<u64>(hi) << 32) | lo;
  }
}

// STAGED: the 64-row blocks pass through shared memory (a compile-time
// choice, so that the scan's loads know their address space)
template <bool STAGED>
__global__ void __launch_bounds__(32)
nms_scan_kernel(const u64* __restrict__ mask, const uint8_t* __restrict__ valid_sorted, int n,
                int words, bool* __restrict__ keep_sorted) {
  extern __shared__ u64 smem64[];
  const int chunk = 64 * words;             // words of one block of 64 rows
  u64* buf = smem64;                        // [2, 64, words] where staged
  u64* rem = smem64 + (STAGED ? 2 * chunk : 0);   // [words]: rows removed so far
  const int c = blockIdx.x, lane = threadIdx.x;
  const u64* mc = mask + static_cast<size_t>(c) * chunk * words;
  const uint8_t* vc = valid_sorted + static_cast<size_t>(c) * n;
  bool* keep = keep_sorted + static_cast<size_t>(c) * n;

  for (int w = lane; w < words; w += 32) rem[w] = 0ull;
  auto fetch = [&](int wb) {
    if (!STAGED) return;
    const u64* g = mc + static_cast<size_t>(wb) * chunk;
    const uint32_t d = smem_u32(buf + (wb & 1) * chunk);
    for (int q = lane; q < chunk / 2; q += 32) cp_async16(d + 16 * q, g + 2 * q);
  };
  fetch(0);
  cp_async_commit();
  // validity of the rows lane and lane + 32 of the next block, loaded a block ahead
  uint8_t x0 = lane < n ? vc[lane] : 0, x1 = 32 + lane < n ? vc[32 + lane] : 0;
  for (int wb = 0; wb < words; ++wb) {
    if (wb + 1 < words) fetch(wb + 1);
    cp_async_commit();
    const int base = wb * 64;
    const unsigned v_lo = __ballot_sync(FULL, x0 != 0), v_hi = __ballot_sync(FULL, x1 != 0);
    x0 = base + 64 + lane < n ? vc[base + 64 + lane] : 0;
    x1 = base + 96 + lane < n ? vc[base + 96 + lane] : 0;
    cp_async_wait<1>();
    __syncwarp();
    const u64* blk = STAGED ? buf + (wb & 1) * chunk : mc + static_cast<size_t>(wb) * chunk;
    // diagonal words of rows lane and lane + 32: their bits j > row within the block
    const u64 d0 = blk[lane * words + wb];
    const unsigned d1_hi = static_cast<unsigned>(blk[(lane + 32) * words + wb] >> 32);
    const u64 removed = rem[wb];
    const unsigned c_lo = v_lo & ~static_cast<unsigned>(removed);
    const unsigned c_hi = v_hi & ~static_cast<unsigned>(removed >> 32);
    const bool in0 = (c_lo >> lane) & 1u, in1 = (c_hi >> lane) & 1u;
    const unsigned d0_lo = static_cast<unsigned>(d0), d0_hi = static_cast<unsigned>(d0 >> 32);
    // a candidate no candidate removes is kept whatever the others do
    const unsigned u_lo = __reduce_or_sync(FULL, in0 ? d0_lo : 0u);
    const unsigned u_hi = __reduce_or_sync(FULL, (in0 ? d0_hi : 0u) | (in1 ? d1_hi : 0u));
    unsigned kept_lo = c_lo & ~u_lo, kept_hi = c_hi & ~u_hi;
    const bool k0 = (kept_lo >> lane) & 1u, k1 = (kept_hi >> lane) & 1u;
    // the rest, in order: kept iff no kept row before it removes it
    unsigned cand_lo = c_lo & u_lo & ~__reduce_or_sync(FULL, k0 ? d0_lo : 0u);
    unsigned cand_hi = c_hi & u_hi & ~__reduce_or_sync(FULL, (k0 ? d0_hi : 0u) | (k1 ? d1_hi : 0u));
    while (cand_lo) {
      const int b = __ffs(cand_lo) - 1;
      const unsigned lo = __shfl_sync(FULL, d0_lo, b);
      const unsigned hi = __shfl_sync(FULL, d0_hi, b);
      kept_lo |= 1u << b;
      cand_lo &= (cand_lo - 1u) & ~lo;
      cand_hi &= ~hi;
    }
    while (cand_hi) {
      const int b = __ffs(cand_hi) - 1;
      const unsigned hi = __shfl_sync(FULL, d1_hi, b);
      kept_hi |= 1u << b;
      cand_hi &= (cand_hi - 1u) & ~hi;
    }
    if (base + lane < n) keep[base + lane] = (kept_lo >> lane) & 1u;
    if (base + 32 + lane < n) keep[base + 32 + lane] = (kept_hi >> lane) & 1u;
    // the kept rows remove their later rows: each lane ORs the words it owns
    for (int w = wb + 1 + lane; w < words; w += 32) {
      u64 r = rem[w];
      const u64* col = blk + w;
#pragma unroll
      for (int b = 0; b < 32; ++b)
        if ((kept_lo >> b) & 1u) r |= col[b * words];
#pragma unroll
      for (int b = 0; b < 32; ++b)
        if ((kept_hi >> b) & 1u) r |= col[(b + 32) * words];
      rem[w] = r;
    }
    __syncwarp();   // rem is read by all lanes, and this buffer is refilled next
  }
}

}  // namespace

// iou [n, n] f32, order [c, n] i32, valid_sorted [c, n] u8; mask: scratch of
// c * 64 * words * words u64 with words = ceil(n / 64); keep_sorted [c, n]
// bool (checked by the Python wrapper). Returns a cudaError_t (0 on success).
extern "C" int fsf_nms_keep(const void* iou, const void* order, const void* valid_sorted,
                            int c, int n, float thr, void* mask, void* keep_sorted,
                            void* stream) {
  if (c <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int words = (n + 63) / 64;
  int dev = 0, err = 0;
  cudaGetDevice(&dev);
  const int limit = fsf::optin_smem(dev);
  const bool staged = (2LL * 64 + 1) * words * 8 <= limit;
  const int scan_smem = (staged ? 2 * 64 + 1 : 1) * words * 8;
  if (scan_smem > limit) return static_cast<int>(cudaErrorInvalidValue);
  void (*scan)(const u64*, const uint8_t*, int, int, bool*) =
      staged ? nms_scan_kernel<true> : nms_scan_kernel<false>;
  // one limit per instantiation, raised only past the largest set so far
  static fsf::SmemLimit scan_limit[2];
  err = static_cast<int>(
      scan_limit[staged].raise(reinterpret_cast<const void*>(scan), dev, scan_smem));
  if (err != 0) return err;
  const bool ord_smem = n <= MASK_SMEM_ROWS;
  void (*mask_pass)(const float*, const int*, const uint8_t*, int, int, float, u64*) =
      ord_smem ? nms_mask_kernel<true> : nms_mask_kernel<false>;
  mask_pass<<<dim3((n + MASK_ROWS - 1) / MASK_ROWS, c), MASK_THREADS, ord_smem ? n * 4 : 0, st>>>(
      static_cast<const float*>(iou), static_cast<const int*>(order),
      static_cast<const uint8_t*>(valid_sorted), n, words, thr, static_cast<u64*>(mask));
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  scan<<<c, 32, scan_smem, st>>>(static_cast<const u64*>(mask),
                                 static_cast<const uint8_t*>(valid_sorted), n, words,
                                 static_cast<bool*>(keep_sorted));
  return static_cast<int>(cudaGetLastError());
}
