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
// What bounds it: the tensor-core operations 2 * hits * cin * cout against
// the bytes of feats, rows and g read once and d_w written once; at the
// UNet's shapes the operations (PERF.md holds both per call). Between the
// two stand a row gather that TMA cannot do, the rows of a 128-row tile
// that miss the tap (computed as zeros), and a sum over all rows that the
// card can only split across blocks.
//
// Design, four kernels per call of ops/sparse_conv.py::dw_per_tap, through
// two entries: fsf_dw_work_list launches 1-2, fsf_gather_conv_dw 3-4 over
// that list.
// 1-2. The work list, on the device from the plan (nothing is read back to
//   the host, so the grid is fixed by the shapes): dw_tile_or_kernel ORs
//   the masks of each 128-row tile of the plan's order (a warp a tile);
//   dw_lists_kernel (one block) lists for each tap the tiles whose OR has
//   its bit, and cuts the lists into chunks of `per` hit tiles, per the
//   least length that keeps the chunks within the n_chunks slots of the
//   grid (as many blocks as the card holds at once: one wave). Its plain
//   version is ops/sparse_conv.py::dw_work_list. Made there as torch glue
//   (~60 small kernels) the list took 1.52 of 3.01 ms over the train
//   step's 13 calls; these two take ~0.1 ms.
// 3. gather_conv_dw_kernel: a block per (Cout tile, Cin tile, chunk slot)
//   walks only its chunk's tiles (slots past the list's end return at
//   once). Per 64-row stage the gathered feats rows (A^T: rows are K, 128
//   Cin are M) and the same rows of g (B: rows are K, BN Cout are N) land in
//   shared memory, both MN-major in the 128-byte swizzled layout, by
//   zero-filling 16-byte cp.async (a row that misses the tap reads nothing,
//   so the bytes follow the hits, not the tiles). Two warpgroups (Cin 0-63
//   and 64-127 of the tile) run wgmma m64nBNk16 with transposed A and B; BN
//   = 64 / 128 / 256 covers Cout, so a gathered row is read once per 128
//   Cin and a g row once per BN Cout. The next stages' loads are issued
//   while wgmma runs. Two blocks an SM with 96 KB rings at BN <= 128 (one
//   with 192 KB at 256): against one block with a 192 KB ring the kernel
//   went 1.06 -> 0.72 ms over the 13 calls; at these widths it moves a
//   hit's feats and g rows from L2 per tap, ~64 FLOP a byte at 128 x 128,
//   so L2, not the tensor cores, bounds it.
//   The rows' sources come through a chain of dependent loads (chunk's tile
//   list -> order -> rows[tap]): threads 0-127 each own one row of a tile
//   and keep the chain two tiles apart per level in registers, publishing
//   each tile's (source row, output row) pairs to a small ring in shared
//   memory a few stages before its loads.
// 4. sum_chunks_kernel: no float atomics; a chunk writes its partial tile
//   to part[chunk], and each tap's chunks are added in chunk order (zero
//   for a tap nothing hits). Bitwise reproducible.
// (Times: tools/time_dw_per_tap.py on an NVIDIA H100 80GB HBM3, 700 W.)
#include "wgmma.cuh"

namespace {

using namespace fsf;

constexpr unsigned FULL = 0xffffffffu;
constexpr int TILE = 128;          // rows per tile of the plan's order (TILE_ROWS)
constexpr int KR = 64;             // rows per stage: the K depth of 4 wgmma k16 steps
constexpr int BM = 128;            // Cin per block: two warpgroups of 64
constexpr int THREADS = 256;
constexpr int ATOM = KR * 128;     // bytes of a 64-wide (128-byte) column of a stage
constexpr int A_BYTES = 2 * ATOM;
constexpr int LIST_THREADS = 1024;

// the stages' shared memory: two blocks an SM at BN <= 128 (4 / 3 stages),
// one at BN = 256 (4 stages); ops/sparse_conv.py::dw_chunk_slots sizes the
// grid to match
template <int BN>
struct Ring {
  static constexpr int BLOCKS_PER_SM = BN <= 128 ? 2 : 1;
  static constexpr int STAGE = A_BYTES + (BN / 64) * ATOM;
  static constexpr int STAGES = (BLOCKS_PER_SM == 2 ? 96 : 192) * 1024 / STAGE;
  static constexpr int AHEAD = (STAGES + 1) / 2;     // tiles published before the loop
  static constexpr int SLOTS = AHEAD + 1;            // tiles whose rows are published at once
  static constexpr int SMEM = 1024 + STAGES * STAGE + SLOTS * TILE * 8;
  static_assert(STAGES >= 2, "at least one stage in flight");
};

// the work list's layout in one int32 buffer (ops/sparse_conv.py::_dw_work_buffer)
struct WorkList {
  int* tile_mask;    // [n_tiles]
  int* tap_tiles;    // [k3]
  int* tiles;        // [k3 * n_tiles]: each tap's hit tiles ascending, then -1
  int* chunks;       // [n_chunks, 3]: (tap, first position in tiles, tiles); 0s past the end
  int* tap_chunks;   // [k3, 2]: first chunk, chunks
  __host__ __device__ WorkList(int* w, int n_tiles, int k3, int n_chunks)
      : tile_mask(w), tap_tiles(w + n_tiles), tiles(w + n_tiles + k3),
        chunks(w + n_tiles + k3 + k3 * n_tiles), tap_chunks(w + n_tiles + k3 + k3 * n_tiles + 3 * n_chunks) {}
};

__global__ void __launch_bounds__(256)
dw_tile_or_kernel(const int* __restrict__ masks, const int* __restrict__ order, int n_out,
                  int* __restrict__ tile_mask) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (t * TILE >= n_out) return;                      // warp-uniform
  unsigned m = 0u;
#pragma unroll
  for (int i = 0; i < TILE / 32; ++i) {
    const int r = t * TILE + i * 32 + lane;
    if (r < n_out) m |= static_cast<unsigned>(masks[order[r]]);
  }
  m = __reduce_or_sync(FULL, m);
  if (lane == 0) tile_mask[t] = static_cast<int>(m);
}

__global__ void __launch_bounds__(LIST_THREADS)
dw_lists_kernel(int n_tiles, int k3, int n_chunks, int* __restrict__ work) {
  __shared__ int s_cnt[32], s_start[32], s_first[32], s_nck[32], s_per;
  WorkList wl(work, n_tiles, k3, n_chunks);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // hit tiles per tap: a warp per tap
  if (warp < k3) {
    int c = 0;
    for (int t0 = 0; t0 < n_tiles; t0 += 32) {
      const int t = t0 + lane;
      c += __popc(__ballot_sync(FULL, t < n_tiles && ((wl.tile_mask[t] >> warp) & 1)));
    }
    if (lane == 0) s_cnt[warp] = c;
  }
  __syncthreads();
  // warp 0: the chunk length, the least per with sum_k ceil(cnt_k / per) <=
  // n_chunks (per = the longest list always fits, as n_chunks >= k3), 32
  // candidates a round; then lane k's tap's first tile and first chunk, by
  // a scan over the lanes
  if (warp == 0) {
    int total = 0;
    for (int k = 0; k < k3; ++k) total += s_cnt[k];
    int per = total > n_chunks ? (total + n_chunks - 1) / n_chunks : 1;
    for (;; per += 32) {
      int need = 0;
      for (int k = 0; k < k3; ++k) need += (s_cnt[k] + per + lane - 1) / (per + lane);
      const unsigned fits = __ballot_sync(FULL, need <= n_chunks);
      if (fits) {
        per += __ffs(fits) - 1;
        break;
      }
    }
    const int cnt = lane < k3 ? s_cnt[lane] : 0;
    const int nck = (cnt + per - 1) / per;
    int cnt_end = cnt, nck_end = nck;
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const int a = __shfl_up_sync(FULL, cnt_end, d), b = __shfl_up_sync(FULL, nck_end, d);
      if (lane >= d) cnt_end += a, nck_end += b;
    }
    if (lane < k3) {
      s_start[lane] = cnt_end - cnt;
      s_first[lane] = nck_end - nck;
      s_nck[lane] = nck;
    }
    if (lane == 0) s_per = per;
  }
  __syncthreads();
  const int per = s_per;
  if (warp < k3) {
    const int k = warp;
    int pos = s_start[k];
    for (int t0 = 0; t0 < n_tiles; t0 += 32) {
      const int t = t0 + lane;
      const bool hit = t < n_tiles && ((wl.tile_mask[t] >> k) & 1);
      const unsigned b = __ballot_sync(FULL, hit);
      if (hit) wl.tiles[pos + __popc(b & ((1u << lane) - 1u))] = t;
      pos += __popc(b);
    }
    for (int c = lane; c < s_nck[k]; c += 32) {
      int* ck = wl.chunks + 3 * (s_first[k] + c);
      ck[0] = k;
      ck[1] = s_start[k] + c * per;
      ck[2] = min(per, s_cnt[k] - c * per);
    }
    if (lane == 0) {
      wl.tap_tiles[k] = s_cnt[k];
      wl.tap_chunks[2 * k] = s_first[k];
      wl.tap_chunks[2 * k + 1] = s_nck[k];
    }
  }
  const int total = s_start[k3 - 1] + s_cnt[k3 - 1];
  for (int i = total + tid; i < k3 * n_tiles; i += LIST_THREADS) wl.tiles[i] = -1;
  for (int i = 3 * (s_first[k3 - 1] + s_nck[k3 - 1]) + tid; i < 3 * n_chunks; i += LIST_THREADS)
    wl.chunks[i] = 0;
}

template <int BN>
__global__ void __launch_bounds__(THREADS, Ring<BN>::BLOCKS_PER_SM)
gather_conv_dw_kernel(const bf16* __restrict__ feats, int n_src, int cin,
                      const int* __restrict__ rows, int n_out,
                      const bf16* __restrict__ g, int cout,
                      const int* __restrict__ order, const int* __restrict__ tiles,
                      const int* __restrict__ chunks, float* __restrict__ part) {
  using R = Ring<BN>;
  const int chunk = blockIdx.z;
  const int tap = chunks[3 * chunk], begin = chunks[3 * chunk + 1], cnt = chunks[3 * chunk + 2];
  if (cnt <= 0) return;                               // past the list's end

  extern __shared__ uint8_t smem_raw[];
  // the swizzle pattern is taken from address bits 7-9: align stages to 1 KB
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  uint8_t* smem = smem_raw + pad;
  const uint32_t smem_s = smem_u32(smem);
  int2* idx = reinterpret_cast<int2*>(smem + R::STAGES * R::STAGE);   // [SLOTS][TILE]

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int n0 = blockIdx.x * BN;
  const int c0 = blockIdx.y * BM;
  const bool wg_active = c0 + wg * 64 < cin;          // warpgroup-uniform
  const int iters = 2 * cnt;                          // stages of KR rows

  // the chain of row tid (< TILE) of the chunk's j-th tile
  auto tile_id = [&](int j) { return j < cnt ? tiles[begin + j] : -1; };
  auto order_of = [&](int id) {
    const int r = id * TILE + tid;
    return (id >= 0 && r < n_out) ? order[r] : -1;
  };
  auto src_of = [&](int o) {
    if (o < 0) return -1;
    const int s = rows[static_cast<size_t>(tap) * n_out + o];
    return static_cast<unsigned>(s) < static_cast<unsigned>(n_src) ? s : -1;
  };

  // tiles 0 .. AHEAD-1 are published now; then, for the next tile u to be
  // published: sq = source rows of u, u+1; oq = output rows of u .. u+3;
  // iq = list entries u+4, u+5 (each level loaded two tiles before its use)
  constexpr int U0 = R::AHEAD;
  int sq[2] = {-1, -1}, oq[4] = {-1, -1, -1, -1}, iq[2] = {-1, -1};
  if (tid < TILE) {
    int ids[U0 + 6], os[U0 + 4];
#pragma unroll
    for (int j = 0; j < U0 + 6; ++j) ids[j] = tile_id(j);
#pragma unroll
    for (int j = 0; j < U0 + 4; ++j) os[j] = order_of(ids[j]);
#pragma unroll
    for (int j = 0; j < U0; ++j) idx[j * TILE + tid] = make_int2(src_of(os[j]), os[j]);
    sq[0] = src_of(os[U0]);
    sq[1] = src_of(os[U0 + 1]);
#pragma unroll
    for (int j = 0; j < 4; ++j) oq[j] = os[U0 + j];
    iq[0] = ids[U0 + 4];
    iq[1] = ids[U0 + 5];
  }
  __syncthreads();

  // stage `st` = rows [64 (st & 1), +64) of the chunk's tile st / 2
  auto load_stage = [&](int st) {
    const int2* ix = idx + ((st >> 1) % R::SLOTS) * TILE + (st & 1) * KR;
    const uint32_t a_s = smem_s + (st % R::STAGES) * R::STAGE;
    const uint32_t b_s = a_s + A_BYTES;
    const int c = tid & 7;                            // 16-byte chunk of a 128-byte row
#pragma unroll
    for (int i = 0; i < 2 * KR * 8 / THREADS; ++i) {  // A: 2 columns of 64 Cin
      const int q = tid + i * THREADS;
      const int a = q >> 9, r = (q >> 3) & (KR - 1);
      const int s = ix[r].x;
      const int ch = c0 + a * 64 + c * 8;
      const bool ok = s >= 0 && ch < cin;
      const void* src = ok ? static_cast<const void*>(feats + static_cast<size_t>(s) * cin + ch)
                           : static_cast<const void*>(feats);
      cp_async16(a_s + a * ATOM + r * 128 + ((c ^ (r & 7)) << 4), src, ok ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < (BN / 64) * KR * 8 / THREADS; ++i) {   // B: BN / 64 columns of Cout
      const int q = tid + i * THREADS;
      const int a = q >> 9, r = (q >> 3) & (KR - 1);
      const int2 so = ix[r];
      const int n = n0 + a * 64 + c * 8;
      const bool ok = so.x >= 0 && n < cout;
      const void* src = ok ? static_cast<const void*>(g + static_cast<size_t>(so.y) * cout + n)
                           : static_cast<const void*>(g);
      cp_async16(b_s + a * ATOM + r * 128 + ((c ^ (r & 7)) << 4), src, ok ? 16 : 0);
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;

#pragma unroll
  for (int s = 0; s < R::STAGES - 1; ++s) {
    if (s < iters) load_stage(s);
    cp_async_commit();
  }
  for (int it = 0; it < iters; ++it) {
    cp_async_wait<R::STAGES - 2>();
    // this thread's cp.async writes become visible to wgmma (async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (wg_active) {
      const uint32_t a_s = smem_s + (it % R::STAGES) * R::STAGE + wg * ATOM;
      const uint32_t b_s = smem_s + (it % R::STAGES) * R::STAGE + A_BYTES;
      fence_regs<BN / 2>(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KR / 16; ++kk)
        wgmma<BN, 1>(acc, make_desc(a_s + kk * 16 * 128, ATOM, 1024),
                     make_desc(b_s + kk * 16 * 128, ATOM, 1024));
      wgmma_commit();
    }
    // while the tensor cores run: publish tile u = it / 2 + AHEAD's rows
    // (first read by the loads of iteration 2u - STAGES + 1 > it, after its
    // barrier; its slot's last reader was before it) and move the chain on
    if (!(it & 1) && tid < TILE) {
      const int u = (it >> 1) + U0;
      if (u < cnt) {
        idx[(u % R::SLOTS) * TILE + tid] = make_int2(sq[0], oq[0]);
        sq[0] = sq[1];
        sq[1] = src_of(oq[2]);
        oq[0] = oq[1];
        oq[1] = oq[2];
        oq[2] = oq[3];
        oq[3] = order_of(iq[0]);
        iq[0] = iq[1];
        iq[1] = tile_id(u + 6);
      }
    }
    // refill the slot the wgmma of it - 1 read (every thread waited for it
    // before the barrier above)
    if (it + R::STAGES - 1 < iters) load_stage(it + R::STAGES - 1);
    cp_async_commit();
    if (wg_active) {
      wgmma_wait_all();
      fence_regs<BN / 2>(acc);
    }
  }
  cp_async_wait<0>();

  if (!wg_active) return;
  // the chunk's partial [cin, cout] tile: rows are Cin, columns Cout
  const int warp = (tid & 127) >> 5, lane = tid & 31;
  float* dst = part + static_cast<size_t>(chunk) * cin * cout;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int ci = c0 + wg * 64 + warp * 16 + (lane >> 2) + h * 8;
    if (ci >= cin) continue;
    float* drow = dst + static_cast<size_t>(ci) * cout;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int co = n0 + j * 8 + (lane & 3) * 2;
      if (co < cout)
        *reinterpret_cast<float2*>(drow + co) = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// out[k] = sum of part[c] over tap k's chunks c = first, first + 1, ... in
// that order (zero for a tap with no chunk); float4 per thread
__global__ void sum_chunks_kernel(const float4* __restrict__ part, const int* __restrict__ tap_chunks,
                                  int k3, size_t n4, float4* __restrict__ out) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < k3 * n4;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int k = static_cast<int>(i / n4);
    const size_t e = i - k * n4;
    const int first = tap_chunks[2 * k], count = tap_chunks[2 * k + 1];
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c = 0; c < count; ++c) {
      const float4 v = part[(first + c) * n4 + e];
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    out[i] = acc;
  }
}

template <int BN>
int launch(int dev, const void* feats, int n_src, int cin, const void* rows, int n_out,
           const void* g, int cout, const void* order, const WorkList& wl, int n_chunks,
           float* part, cudaStream_t stream) {
  static SmemLimit limit;
  const cudaError_t err = limit.raise(reinterpret_cast<const void*>(gather_conv_dw_kernel<BN>),
                                      dev, Ring<BN>::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((cout + BN - 1) / BN, (cin + BM - 1) / BM, n_chunks);
  gather_conv_dw_kernel<BN><<<grid, THREADS, Ring<BN>::SMEM, stream>>>(
      static_cast<const bf16*>(feats), n_src, cin, static_cast<const int*>(rows), n_out,
      static_cast<const bf16*>(g), cout, static_cast<const int*>(order), wl.tiles, wl.chunks,
      part);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The work list alone (its plain version is ops/sparse_conv.py::dw_work_list):
// masks, order: i32 [n_out]; work: i32 buffer of n_tiles + k3 + k3 * n_tiles
// + 3 * n_chunks + 2 * k3 with n_tiles = ceil(n_out / 128); 1 <= k3 <= 31,
// n_chunks >= k3. Returns a cudaError_t (0 on success).
extern "C" int fsf_dw_work_list(const void* masks, const void* order, int n_out, int k3,
                                int n_chunks, void* work, void* stream) {
  if (k3 < 1 || k3 > 31 || n_chunks < k3) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* w = static_cast<int*>(work);
  const int n_tiles = (n_out + TILE - 1) / TILE;
  if (n_tiles > 0)
    dw_tile_or_kernel<<<(n_tiles + 7) / 8, 256, 0, st>>>(
        static_cast<const int*>(masks), static_cast<const int*>(order), n_out, w);
  dw_lists_kernel<<<1, LIST_THREADS, 0, st>>>(n_tiles, k3, n_chunks, w);
  return static_cast<int>(cudaGetLastError());
}

// The product and the chunks' sum over a work list that fsf_dw_work_list
// made on the same stream. feats, g: bf16, 16-byte aligned rows (cin % 8 ==
// 0, cout % 8 == 0); order: i32 [n_out], the forward plan's; work: as
// fsf_dw_work_list's; bn: 64, 128 or 256 (the Cout tile); part: f32 scratch
// [n_chunks, cin, cout]; out: f32 [k3, cin, cout] — all checked by the
// Python wrapper. Returns a cudaError_t (0 on success).
extern "C" int fsf_gather_conv_dw(const void* feats, int n_src, int cin, const void* rows,
                                  int n_out, int k3, const void* g, int cout, const void* order,
                                  int n_chunks, int bn, void* work, void* part, void* out,
                                  void* stream) {
  if (n_chunks > 65535 || k3 < 1 || k3 > 31 || n_chunks < k3)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = 0, dev = 0;
  cudaGetDevice(&dev);
  const WorkList wl(static_cast<int*>(work), (n_out + TILE - 1) / TILE, k3, n_chunks);
  float* p = static_cast<float*>(part);
  if (bn == 256)
    err = launch<256>(dev, feats, n_src, cin, rows, n_out, g, cout, order, wl, n_chunks, p, st);
  else if (bn == 128)
    err = launch<128>(dev, feats, n_src, cin, rows, n_out, g, cout, order, wl, n_chunks, p, st);
  else if (bn == 64)
    err = launch<64>(dev, feats, n_src, cin, rows, n_out, g, cout, order, wl, n_chunks, p, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err != 0) return err;
  const size_t n4 = static_cast<size_t>(cin) * cout / 4;
  const size_t want = (k3 * n4 + 255) / 256;
  const int blocks = static_cast<int>(want < 4096 ? (want > 0 ? want : 1) : 4096);
  sum_chunks_kernel<<<blocks, 256, 0, st>>>(static_cast<const float4*>(part), wl.tap_chunks, k3,
                                            n4, static_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}
