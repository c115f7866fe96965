// Gather convolution (implicit GEMM) for Hopper, sm_90a.
//
// Replaces: fullysparsefusion_tpu/ops/pallas_kernels.py::window_gather_conv
// (Pallas bodies _wg_conv_kernel and _wg_conv_kernel_p2), reached from
// ops/sparse_conv.py::_conv_dispatch. Contract:
//
//   out[n_out, cout] (f32) = sum_{k < k3} feats_z[rows[k]] @ w[k]
//
// feats [n_src, cin] bf16, rows [k3, n_out] i32 where a miss is n_src (the
// zero row), w [k3, cin, cout] bf16, f32 accumulation. n_out may differ
// from n_src (strided and inverse convs). The caller masks by out-validity.
// Beside the rows the kernel takes the rulebook's plan (ops/sparse_conv.py::
// plan_rulebook): masks[r], the k3-bit set of taps that hit for output row r,
// and order, the rows stably sorted by that mask.
//
// What bounds it: the tensor-core operations on the rulebook's hits (bf16,
// f32 accumulation) and the bytes of feats, rows, w and out; at the UNet's
// shapes the bytes bound it (PERF.md holds both per call). Between the two
// stand the rulebook's misses (5-40 % of the slots hit), a row gather that
// TMA cannot do, and the latency of those gathers.
//
// Design (the mask-sorted implicit GEMM of spconv 2.x, on wgmma):
// - A block owns 128 consecutive rows of the sorted order and up to 256
//   output channels. It ORs its rows' masks and walks only the taps in that
//   OR, in ascending tap order, so a tile of rows that share taps does 1-8
//   taps (inverse convs) instead of 27 and a tile of capacity padding does
//   none: it writes zeros. Each row's sum stays in registers in a fixed
//   order: no atomics, no split over blocks, bitwise reproducible.
// - For each (tap, 64-channel slice of cin) a stage holds the 128 gathered
//   source rows (A, K-major) and the [64, BN] slice of w[tap] (B, N-major),
//   both in the 128-byte swizzled layout wgmma reads. Loads are 16-byte
//   cp.async.cg, zero-filled (src-size 0) for a miss, a row past n_out or a
//   channel past cin. A ring of 3 stages keeps two slices in flight while
//   two warpgroups (64 rows each) run wgmma m64nBNk16 on the third; the next
//   slice's loads are issued while the wgmmas run. At BN <= 128 the ring
//   leaves room for two blocks on an SM, whose loops interleave (measured
//   faster on the H100 than deeper rings, 64-row tiles, or keeping a wgmma
//   group in flight across the barrier).
// - BN covers cout (up to 256), so a gathered row is read once per conv; it
//   is halved, and the row read once per BN slice, only while the grid would
//   fill less than half the card.
// - The block writes each row straight to its original position (order[r]);
//   no gather or scatter launch follows.
#include "wgmma.cuh"

namespace {

using namespace fsf;

constexpr int BM = 128;        // output rows per block (sorted order)
constexpr int BK = 64;         // input channels per stage: one 128-byte swizzle row
constexpr int STAGES = 3;
constexpr int THREADS = 256;   // two warpgroups: rows 0-63 and 64-127
constexpr int A_BYTES = BM * BK * 2;

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
gather_conv_kernel(const bf16* __restrict__ feats, int n_src, int cin,
                   const int* __restrict__ rows, int n_out, int k3,
                   const bf16* __restrict__ w, int cout,
                   const int* __restrict__ order, const int* __restrict__ masks,
                   float* __restrict__ out) {
  constexpr int B_BYTES = BK * BN * 2;
  constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle pattern is taken from address bits 7-9: align stages to 1 KB
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  uint8_t* smem = smem_raw + pad;
  const uint32_t smem_s = smem_u32(smem);
  int* src = reinterpret_cast<int*>(smem + STAGES * STAGE_BYTES);  // [taps, BM]
  int* orow = src + k3 * BM;                                         // [BM]
  int* taps = orow + BM;                                             // [32]
  unsigned* tile_mask = reinterpret_cast<unsigned*>(taps + 32);

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // the tile's rows, and the taps any of them hits
  if (tid == 0) *tile_mask = 0u;
  if (tid < BM) orow[tid] = (m0 + tid < n_out) ? order[m0 + tid] : -1;
  __syncthreads();
  unsigned m = 0u;
  if (tid < BM && orow[tid] >= 0) m = static_cast<unsigned>(masks[orow[tid]]);
  m = __reduce_or_sync(0xffffffffu, m);
  if ((tid & 31) == 0 && m) atomicOr(tile_mask, m);
  __syncthreads();
  const unsigned tmask = *tile_mask;
  const int ntaps = __popc(tmask);
  if (tid < 32 && ((tmask >> tid) & 1u)) taps[__popc(tmask & ((1u << tid) - 1u))] = tid;
  __syncthreads();
  // source row of every (tap, row) of the tile; -1 for a miss
  for (int i = tid; i < ntaps * BM; i += THREADS) {
    const int o = orow[i % BM];
    int s = -1;
    if (o >= 0) {
      s = rows[static_cast<size_t>(taps[i / BM]) * n_out + o];
      if (static_cast<unsigned>(s) >= static_cast<unsigned>(n_src)) s = -1;
    }
    src[i] = s;
  }
  __syncthreads();

  const int nk = (cin + BK - 1) / BK;
  const int iters = ntaps * nk;

  // stage `it` = (tap it / nk, channels [c0, c0 + 64)); zeros past cin / cout
  auto load_stage = [&](int it) {
    const int t = it / nk;
    const int c0 = (it - t * nk) * BK;
    const uint32_t a_s = smem_s + (it % STAGES) * STAGE_BYTES;
    const uint32_t b_s = a_s + A_BYTES;
    const int c = tid & 7;                     // 16-byte chunk of a 128-byte row
    const bool c_ok = c0 + c * 8 < cin;
#pragma unroll
    for (int i = 0; i < BM * 8 / THREADS; ++i) {
      const int r = (tid >> 3) + i * (THREADS / 8);
      const int s = src[t * BM + r];
      const bool ok = c_ok && s >= 0;
      const void* g = ok ? static_cast<const void*>(feats + static_cast<size_t>(s) * cin + c0 + c * 8)
                         : static_cast<const void*>(w);
      cp_async16(a_s + r * 128 + ((c ^ (r & 7)) << 4), g, ok ? 16 : 0);
    }
    const bf16* wk = w + static_cast<size_t>(taps[t]) * cin * cout;
    constexpr int CPR = BN / 8;                // 16-byte chunks per K row of B
#pragma unroll
    for (int i = 0; i < BK * CPR / THREADS; ++i) {
      const int q = tid + i * THREADS;
      const int kr = q / CPR, n = (q % CPR) * 8;
      const bool ok = c0 + kr < cin && n0 + n < cout;
      const void* g = ok ? static_cast<const void*>(wk + static_cast<size_t>(c0 + kr) * cout + n0 + n)
                         : static_cast<const void*>(w);
      // N-major: 64-column atoms of [64 K rows x 128 bytes], BK * 128 bytes apart
      cp_async16(b_s + (n >> 6) * (BK * 128) + kr * 128 + ((((n >> 3) & 7) ^ (kr & 7)) << 4),
                 g, ok ? 16 : 0);
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < iters) load_stage(s);
    cp_async_commit();
  }
  const int wg = tid / 128;
  for (int it = 0; it < iters; ++it) {
    cp_async_wait<STAGES - 2>();
    // this thread's cp.async writes become visible to wgmma (async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const int c0 = (it % nk) * BK;
    const int nkk = min(BK / 16, (cin - c0 + 15) / 16);
    const uint32_t a_s = smem_s + (it % STAGES) * STAGE_BYTES + wg * 64 * 128;
    const uint32_t b_s = smem_s + (it % STAGES) * STAGE_BYTES + A_BYTES;
    fence_regs<BN / 2>(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    if (nkk == BK / 16) {   // a full slice: no branch between the wgmmas
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma<BN, 0>(acc, make_desc(a_s + kk * 32, 16, 1024),
                  make_desc(b_s + kk * 16 * 128, BK * 128, 1024));
    } else {
      for (int kk = 0; kk < nkk; ++kk)
        wgmma<BN, 0>(acc, make_desc(a_s + kk * 32, 16, 1024),
                  make_desc(b_s + kk * 16 * 128, BK * 128, 1024));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // while the tensor cores run: refill the slot the wgmma of it - 1 read
    // (every thread waited for it before the barrier above)
    if (it + STAGES - 1 < iters) load_stage(it + STAGES - 1);
    cp_async_commit();
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs<BN / 2>(acc);
  }

  // each row to its original position
  const int warp = (tid & 127) >> 5, lane = tid & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int o = orow[wg * 64 + warp * 16 + (lane >> 2) + h * 8];
    if (o < 0) continue;
    float* dst = out + static_cast<size_t>(o) * cout + n0;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = j * 8 + (lane & 3) * 2;
      if (n0 + col < cout)
        *reinterpret_cast<float2*>(dst + col) = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

template <int BN>
int launch(int dev, const void* feats, int n_src, int cin, const void* rows, int n_out, int k3,
           const void* w, int cout, const void* order, const void* masks, void* out,
           cudaStream_t stream) {
  const int smem = 1024 + STAGES * (A_BYTES + BK * BN * 2) + (k3 * BM + BM + 32 + 1) * 4;
  static SmemLimit limit;
  const cudaError_t err =
      limit.raise(reinterpret_cast<const void*>(gather_conv_kernel<BN>), dev, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((n_out + BM - 1) / BM, (cout + BN - 1) / BN);
  gather_conv_kernel<BN><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(feats), n_src, cin, static_cast<const int*>(rows), n_out, k3,
      static_cast<const bf16*>(w), cout, static_cast<const int*>(order),
      static_cast<const int*>(masks), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// feats, w: bf16, 16-byte aligned rows (cin % 8 == 0, cout % 8 == 0); k3 <= 31;
// order, masks: i32 [n_out] — all checked by the Python wrapper. Returns a
// cudaError_t (0 on success).
extern "C" int fsf_gather_conv(const void* feats, int n_src, int cin,
                               const void* rows, int n_out, int k3,
                               const void* w, int cout, const void* order,
                               const void* masks, void* out, void* stream) {
  if (n_out <= 0) return static_cast<int>(cudaGetLastError());
  int dev = 0;
  cudaGetDevice(&dev);
  const int sms = sm_count(dev);
  // widest tile that covers cout, narrowed while the grid would fill less
  // than half the card
  const int tiles = (n_out + BM - 1) / BM;
  int bn = cout > 128 ? 256 : (cout > 64 ? 128 : 64);
  while (bn > 64 && 2 * tiles * ((cout + bn - 1) / bn) < sms) bn /= 2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bn == 256)
    return launch<256>(dev, feats, n_src, cin, rows, n_out, k3, w, cout, order, masks, out, st);
  if (bn == 128)
    return launch<128>(dev, feats, n_src, cin, rows, n_out, k3, w, cout, order, masks, out, st);
  return launch<64>(dev, feats, n_src, cin, rows, n_out, k3, w, cout, order, masks, out, st);
}
