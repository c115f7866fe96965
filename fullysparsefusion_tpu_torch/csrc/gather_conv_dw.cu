// Weight gradient of the gather convolution, for Hopper, sm_90a.
//
// No Pallas counterpart: the JAX package computes it in XLA as
// ops/sparse_conv.py::_dw_per_tap (27 gathers and 27 matmuls per conv
// backward), the d_w of _subm_conv_bwd and _pair_conv_bwd. Contract:
//
//   d_w[k] (f32 [cin, cout]) = sum_r feats_z[rows[k, r]]^T (x) g[r]
//
// feats [n_src, cin] bf16 (the forward's input), rows [k3, n_out] i32 (the
// forward's rulebook; a miss is n_src, the zero row), g [n_out, cout] bf16
// (the output's gradient, masked by validity), f32 accumulation. Beside
// them the forward rulebook's plan (ops/sparse_conv.py::plan_rulebook):
// masks[r], the k3-bit set of taps that hit for row r, and order, the rows
// stably sorted by that mask.
//
// What bounds it: the bytes of the gathered feats rows and of g (each read
// once per (tap, Cin tile, Cout tile) that needs it), against the tensor-core
// operations 2 * hits * cin * cout; at the UNet's shapes the bytes (PERF.md
// holds both per call).
//
// Design (a simple, deterministic first kernel):
// - One block per (Cout tile of 64, Cin tile of 64, tap, row split). A split
//   is a fixed range of 128-row tiles of the plan's sorted order. The block
//   walks its tiles; a tile in which no row hits the tap is skipped (the
//   sort puts rows with the same taps together, so most tiles of a sparse
//   tap are skipped whole).
// - For a tile that hits, the block gathers the hit rows' 64 input channels
//   (A^T, [128 rows, 64 cin]) and the same rows of g ([128 rows, 64 cout])
//   into shared memory, zeros for a miss, and four warps accumulate the
//   64 x 64 product over the 128 rows with WMMA bf16 m16n16k16 (mma.sync),
//   f32 accumulators in registers.
// - No float atomics: a split writes its partial tile to a scratch
//   [splits, k3, cin, cout], and a second kernel adds the splits in a fixed
//   order. With one split the block writes d_w directly. Bitwise
//   reproducible.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int TILE = 128;     // rows per tile of the sorted order (TILE_ROWS)
constexpr int BT = 64;        // Cin and Cout per block
constexpr int LD = BT + 8;    // shared row stride (bf16): 144 bytes, off the banks' period
constexpr int LDC = BT + 4;   // shared row stride of the f32 result tile
constexpr int THREADS = 128;  // four warps, each 32 Cin x 32 Cout

__global__ void __launch_bounds__(THREADS)
gather_conv_dw_kernel(const bf16* __restrict__ feats, int n_src, int cin,
                      const int* __restrict__ rows, int n_out, int k3,
                      const bf16* __restrict__ g, int cout,
                      const int* __restrict__ order, const int* __restrict__ masks,
                      int splits, float* __restrict__ part) {
  __shared__ __align__(128) uint8_t smem[2 * TILE * LD * 2];
  __shared__ int s_src[TILE];
  __shared__ int s_row[TILE];
  bf16* sF = reinterpret_cast<bf16*>(smem);        // [TILE][LD] gathered feats
  bf16* sG = sF + TILE * LD;                        // [TILE][LD] g rows

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int n0 = blockIdx.x * BT;                   // Cout tile
  const int c0 = blockIdx.y * BT;                   // Cin tile
  const int tap = blockIdx.z / splits;
  const int split = blockIdx.z - tap * splits;
  const int tiles = (n_out + TILE - 1) / TILE;
  const int per = (tiles + splits - 1) / splits;
  const int t_begin = split * per;
  const int t_end = min(tiles, t_begin + per);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  const int wm = (warp >> 1) * 32;                  // this warp's Cin rows of the tile
  const int wn = (warp & 1) * 32;                   // and Cout columns

  for (int t = t_begin; t < t_end; ++t) {
    // the tile's rows, and the source row each gathers for this tap
    const int r = t * TILE + tid;
    int o = -1, s = -1;
    if (r < n_out) {
      o = order[r];
      if ((static_cast<unsigned>(masks[o]) >> tap) & 1u) {
        s = rows[static_cast<size_t>(tap) * n_out + o];
        if (static_cast<unsigned>(s) >= static_cast<unsigned>(n_src)) s = -1;
      }
    }
    s_src[tid] = s;
    s_row[tid] = o;
    if (!__syncthreads_or(s >= 0)) continue;        // no row of the tile hits the tap

    // 128 rows x 8 chunks of 16 bytes, for feats and for g; zeros for a miss
    // and past cin / cout (both multiples of 8)
#pragma unroll
    for (int i = 0; i < TILE * 8 / THREADS; ++i) {
      const int q = tid + i * THREADS;
      const int row = q >> 3, c = (q & 7) * 8;
      const int src = s_src[row];
      uint4 fv = make_uint4(0u, 0u, 0u, 0u), gv = make_uint4(0u, 0u, 0u, 0u);
      if (src >= 0) {
        if (c0 + c < cin)
          fv = *reinterpret_cast<const uint4*>(feats + static_cast<size_t>(src) * cin + c0 + c);
        if (n0 + c < cout)
          gv = *reinterpret_cast<const uint4*>(g + static_cast<size_t>(s_row[row]) * cout + n0 + c);
      }
      *reinterpret_cast<uint4*>(sF + row * LD + c) = fv;
      *reinterpret_cast<uint4*>(sG + row * LD + c) = gv;
    }
    __syncthreads();

    // acc[cin, cout] += F^T[cin, rows] @ G[rows, cout], 16 rows per step:
    // F^T is F read column-major, G row-major
#pragma unroll 2
    for (int kk = 0; kk < TILE; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], sF + kk * LD + wm + 16 * i, LD);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], sG + kk * LD + wn + 16 * j, LD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // the 64 x 64 result through shared memory, so the Cin / Cout edges mask
  float* sC = reinterpret_cast<float*>(smem);       // [BT][LDC]
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(sC + (wm + 16 * i) * LDC + wn + 16 * j, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
  float* dst = part + (static_cast<size_t>(split) * k3 + tap) * cin * cout;
  for (int q = tid; q < BT * BT; q += THREADS) {
    const int ci = q / BT, co = q - ci * BT;
    if (c0 + ci < cin && n0 + co < cout)
      dst[static_cast<size_t>(c0 + ci) * cout + n0 + co] = sC[ci * LDC + co];
  }
}

// out[i] = sum over splits of part[s][i], in split order
__global__ void sum_splits_kernel(const float* __restrict__ part, int splits, size_t n,
                                  float* __restrict__ out) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float acc = 0.0f;
    for (int s = 0; s < splits; ++s) acc += part[s * n + i];
    out[i] = acc;
  }
}

}  // namespace

// feats, g: bf16, 16-byte aligned rows (cin % 8 == 0, cout % 8 == 0);
// k3 <= 31; order, masks: i32 [n_out]; part: f32 [splits, k3, cin, cout]
// (the output itself when splits == 1) — all checked by the Python
// wrapper. Returns a cudaError_t (0 on success).
extern "C" int fsf_gather_conv_dw(const void* feats, int n_src, int cin,
                                  const void* rows, int n_out, int k3,
                                  const void* g, int cout, const void* order,
                                  const void* masks, int splits, void* part, void* out,
                                  void* stream) {
  if (splits < 1 || k3 * splits > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((cout + BT - 1) / BT, (cin + BT - 1) / BT, k3 * splits);
  gather_conv_dw_kernel<<<grid, THREADS, 0, st>>>(
      static_cast<const bf16*>(feats), n_src, cin, static_cast<const int*>(rows), n_out, k3,
      static_cast<const bf16*>(g), cout, static_cast<const int*>(order),
      static_cast<const int*>(masks), splits, static_cast<float*>(part));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const size_t n = static_cast<size_t>(k3) * cin * cout;
  const size_t want = (n + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  sum_splits_kernel<<<blocks, 256, 0, st>>>(static_cast<const float*>(part), splits, n,
                                            static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
