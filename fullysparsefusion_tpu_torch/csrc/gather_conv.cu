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
//
// What bounds it: per tap the gathered rows feed a [64, cin] x [cin, 64]
// product, so at the UNet's widths (cin 64..512) the work is tensor-core
// operations on the rulebook hits plus a row gather of cin*2 bytes per hit;
// the least time is the larger of the hit FLOPs over the bf16 rate and the
// feats/rows/w/out bytes over the memory rate (PERF.md holds both).
//
// Design: one block per (64 output rows x 64 output channels) tile. For each
// tap the block reads its 64 rulebook rows once, then walks cin in 32-wide
// slices: the 64 gathered source rows (16-byte vector loads, zeros for a
// miss or past cin) and the w[k] slice go to shared memory, and eight warps
// run bf16 WMMA 16x16x16 fragments into f32 accumulators that stay in
// registers across all taps. A direct row gather is exact for any rulebook,
// so the TPU kernel's windows, residual repair and fallback have no
// counterpart. No wgmma/TMA yet: this is the simple, right form.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 64;   // output rows per block
constexpr int BN = 64;   // output channels per block
constexpr int BK = 32;   // input channels per shared-memory slice
constexpr int A_LD = BK + 8;   // bf16 leading dims: multiples of 8, rows 16-byte aligned
constexpr int B_LD = BN + 8;
constexpr int C_LD = BN + 4;   // f32 leading dim: multiple of 4
constexpr int THREADS = 256;   // 8 warps: 4 row strips x 2 column halves

__global__ void __launch_bounds__(THREADS)
gather_conv_kernel(const __nv_bfloat16* __restrict__ feats, int n_src, int cin,
                   const int* __restrict__ rows, int n_out, int k3,
                   const __nv_bfloat16* __restrict__ w, int cout,
                   float* __restrict__ out) {
  __shared__ __align__(32) __nv_bfloat16 As[BM * A_LD];
  __shared__ __align__(32) __nv_bfloat16 Bs[BK * B_LD];
  __shared__ __align__(32) float Cs[BM * C_LD];
  __shared__ int src[BM];

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wr = warp / 2;          // 16-row strip
  const int wc = warp % 2;          // 32-column half

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);

  // one 16-byte chunk of A and of B per thread per slice
  const int a_r = tid / (BK / 8), a_c = (tid % (BK / 8)) * 8;
  const int b_r = tid / (BN / 8), b_c = (tid % (BN / 8)) * 8;

  for (int k = 0; k < k3; ++k) {
    if (tid < BM) {
      const int r = m0 + tid;
      src[tid] = (r < n_out) ? rows[(size_t)k * n_out + r] : n_src;
    }
    __syncthreads();
    const int s = src[a_r];
    const bool a_hit = s >= 0 && s < n_src;
    const __nv_bfloat16* wk = w + (size_t)k * cin * cout;
    for (int c0 = 0; c0 < cin; c0 += BK) {
      uint4 av = make_uint4(0, 0, 0, 0);
      if (a_hit && c0 + a_c < cin)
        av = *reinterpret_cast<const uint4*>(feats + (size_t)s * cin + c0 + a_c);
      *reinterpret_cast<uint4*>(&As[a_r * A_LD + a_c]) = av;
      uint4 bv = make_uint4(0, 0, 0, 0);
      if (c0 + b_r < cin && n0 + b_c < cout)
        bv = *reinterpret_cast<const uint4*>(wk + (size_t)(c0 + b_r) * cout + n0 + b_c);
      *reinterpret_cast<uint4*>(&Bs[b_r * B_LD + b_c]) = bv;
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::load_matrix_sync(a, &As[(wr * 16) * A_LD + kk], A_LD);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
          wmma::load_matrix_sync(b, &Bs[kk * B_LD + wc * 32 + j * 16], B_LD);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(&Cs[(wr * 16) * C_LD + wc * 32 + j * 16], acc[j], C_LD,
                            wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < BM * BN; i += THREADS) {
    const int r = i / BN, c = i % BN;
    if (m0 + r < n_out && n0 + c < cout)
      out[(size_t)(m0 + r) * cout + n0 + c] = Cs[r * C_LD + c];
  }
}

}  // namespace

// feats, w: bf16, 16-byte aligned rows (cin % 8 == 0, cout % 8 == 0 —
// checked by the Python wrapper). Returns cudaGetLastError().
extern "C" int fsf_gather_conv(const void* feats, int n_src, int cin,
                               const void* rows, int n_out, int k3,
                               const void* w, int cout, void* out,
                               void* stream) {
  if (n_out > 0) {
    dim3 grid((n_out + BM - 1) / BM, (cout + BN - 1) / BN);
    gather_conv_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(feats), n_src, cin,
        static_cast<const int*>(rows), n_out, k3,
        static_cast<const __nv_bfloat16*>(w), cout, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
