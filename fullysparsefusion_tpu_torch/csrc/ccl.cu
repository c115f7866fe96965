// Connected-component roots over a BEV distance graph, sm_90a.
//
// Replaces: fullysparsefusion_tpu/ops/pallas_kernels.py::ccl_sweeps_pallas
// (Pallas body _ccl_kernel), reached from ops/ccl.py:61-76. Contract, per
// problem g: nodes i, j are adjacent iff both are valid, share a batch id
// and dx*dx + dy*dy < 1 (coordinates pre-scaled by the connect distance);
// every valid node is adjacent to itself. roots[g, i] is the minimum node
// index reachable from i, or -1 for an invalid node, for any component
// diameter. Compact relabelling is the caller's.
//
// What bounds it: the inputs and outputs are a few KB, so neither bytes nor
// operations do (the distance tests are N^2 / 2 per problem, well under a
// microsecond of the card's f32 rate): latency does, i.e. how much of the
// card works and how many dependent steps each problem takes. A label
// propagation over G blocks leaves most SMs idle and needs one N^2 sweep
// per hop of a component whose index order runs against its geometry.
//
// Design, two kernels back to back:
// 1. ccl_adjacency_bits: one warp per (g, row i) across the whole card. The
//    warp walks the words w >= i / 32; lane l tests j = 32 w + l and a
//    __ballot_sync packs 32 tests into one word of bits[g, i, w] (bit b:
//    j = 32 w + b adjacent to i, only j > i). Each lane keeps the word of
//    its own slot so that 32 words leave in one coalesced store. Invalid
//    rows (whole warps) return at once, and the words below i / 32 are never
//    written (nor read): half the N^2 tests.
//    The distance is __fsub_rn/__fmul_rn/__fadd_rn (and the file is built
//    with --fmad=false) so no FMA contraction changes which near-threshold
//    pairs join: the same floats as the plain version's (xi - xj)^2 sum.
// 2. ccl_union_find: one block per problem, parent[N] and the validity in
//    shared memory (5 bytes a node, opted in up to the block's limit: N up
//    to 46,489 on an H100); past that, parent[] lives in a [G, N] scratch
//    in device memory (L2) that the wrapper allocates, apart from roots[]
//    (so the path-halving stores of the last pass land in the scratch and
//    only a node's own thread writes its root), and the validity is read
//    where it lies: any N whose bitmask fits on the card runs. A warp per
//    valid row reads the row's words coalesced, and each lane unites i with every set bit of
//    its word: find both roots with path halving, hook the larger root
//    under the smaller with atomicCAS, retry on conflict (ECL-CC). A parent
//    never exceeds its child, so each tree's root is its minimum; once
//    every edge is united a component is one tree, and the final pass,
//    which chases each node to its root, writes the component minimum
//    whatever order the atomics took. Work is O(edges); no pass depends on
//    the diameter.
#include <cuda_runtime.h>
#include <stdint.h>

#include "device.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int BITS_THREADS = 256;   // 8 rows per block
constexpr int UF_THREADS = 1024;

__global__ void __launch_bounds__(BITS_THREADS)
ccl_adjacency_bits(const float* __restrict__ xy, const int* __restrict__ batch,
                   const uint8_t* __restrict__ valid, int g, int n, int nw,
                   uint32_t* __restrict__ bits) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (BITS_THREADS / 32) + (threadIdx.x >> 5);
  if (row >= (long long)g * n) return;                 // warp-uniform
  const int i = (int)(row % n);
  const size_t base = (size_t)(row - i);
  if (!valid[base + i]) return;
  const float* gxy = xy + 2 * base;
  const float xi = gxy[2 * i], yi = gxy[2 * i + 1];
  const int bi = batch[base + i];
  uint32_t* out = bits + (size_t)row * nw;
  for (int w0 = i >> 5; w0 < nw; w0 += 32) {
    uint32_t mine = 0;
    const int words = min(32, nw - w0);
#pragma unroll 8
    for (int k = 0; k < words; ++k) {
      const int j = (w0 + k) * 32 + lane;
      bool hit = false;
      if (j < n && j > i) {
        // four independent loads, so unrolled steps overlap their latency
        const bool vj = valid[base + j];
        const int bj = batch[base + j];
        const float dx = __fsub_rn(xi, gxy[2 * j]);
        const float dy = __fsub_rn(yi, gxy[2 * j + 1]);
        hit = vj && bj == bi && __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) < 1.0f;
      }
      const uint32_t word = __ballot_sync(FULL, hit);
      if (lane == k) mine = word;
    }
    if (lane < words) out[w0 + lane] = mine;
  }
}

// Root of x with path halving. Parents only ever point down (parent[x] <= x)
// and only hooks (atomicCAS on a root) change a root, so the plain stores
// here, which re-point a non-root at one of its ancestors, race safely.
__device__ int find_root(volatile int* parent, int x) {
  int p = parent[x];
  while (p != x) {
    const int gp = parent[p];
    if (gp == p) return p;
    parent[x] = gp;
    x = gp;
    p = parent[x];
  }
  return x;
}

__device__ void unite(volatile int* parent, int a, int b) {
  int ra = find_root(parent, a), rb = find_root(parent, b);
  while (ra != rb) {
    const int hi = ra > rb ? ra : rb, lo = ra > rb ? rb : ra;
    const int seen = atomicCAS(const_cast<int*>(parent + hi), hi, lo);
    if (seen == hi) return;
    // hi was hooked meanwhile: seen is its new parent; carry on from there
    ra = find_root(parent, seen);
    rb = find_root(parent, lo);
  }
}

__global__ void __launch_bounds__(UF_THREADS)
ccl_union_find(const uint8_t* __restrict__ valid, int n, int nw,
               const uint32_t* __restrict__ bits, bool in_smem, int* parent_mem,
               int* __restrict__ roots) {
  extern __shared__ int parent_smem[];
  const size_t base = (size_t)blockIdx.x * n;
  volatile int* parent = in_smem ? parent_smem : parent_mem + base;
  uint8_t* val_smem = reinterpret_cast<uint8_t*>(parent_smem + n);
  const uint8_t* sval = in_smem ? val_smem : valid + base;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    parent[i] = i;
    if (in_smem) val_smem[i] = valid[base + i];
  }
  __syncthreads();

  // A warp per row, one call site of unite(): variants with a thread per
  // row or per 16-byte group of words and several loads in flight inlined
  // unite() once per word and ran up to 7x slower on the card.
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  for (int i = threadIdx.x >> 5; i < n; i += warps) {
    if (!sval[i]) continue;                            // warp-uniform
    const uint32_t* row = bits + (base + i) * nw;
    for (int w = (i >> 5) + lane; w < nw; w += 32) {
      uint32_t word = row[w];
      while (word) {
        const int b = __ffs(word) - 1;
        word &= word - 1;
        unite(parent, i, w * 32 + b);
      }
    }
  }
  __syncthreads();

  // path halving here too: concurrent hooks can leave chains as long as a
  // component (the reversed chain), which all threads then shorten together
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    roots[base + i] = sval[i] ? find_root(parent, i) : -1;
}

}  // namespace

// xy [g, n, 2] f32, batch [g, n] i32, valid [g, n] u8; bits: scratch of
// g * n * ceil(n / 32) u32; parent: scratch of g * n i32 (used where
// parent[] does not fit in shared memory); roots [g, n] i32 (checked by the
// Python wrapper). Returns a cudaError_t (0 on success).
extern "C" int fsf_ccl_roots(const void* xy, const void* batch, const void* valid,
                             int g, int n, void* bits, void* parent, void* roots,
                             void* stream) {
  if (g <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nw = (n + 31) / 32;
  const int rows_per_block = BITS_THREADS / 32;
  const long long blocks = ((long long)g * n + rows_per_block - 1) / rows_per_block;
  ccl_adjacency_bits<<<(unsigned)blocks, BITS_THREADS, 0, st>>>(
      static_cast<const float*>(xy), static_cast<const int*>(batch),
      static_cast<const uint8_t*>(valid), g, n, nw, static_cast<uint32_t*>(bits));
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  // parent[] and validity in shared memory where they fit the opt-in limit
  int dev = 0;
  cudaGetDevice(&dev);
  const bool in_smem = (long long)n * (sizeof(int) + 1) <= fsf::optin_smem(dev);
  const int uf_smem = in_smem ? n * (int)(sizeof(int) + 1) : 0;
  static fsf::SmemLimit uf_limit;
  err = static_cast<int>(
      uf_limit.raise(reinterpret_cast<const void*>(ccl_union_find), dev, uf_smem));
  if (err != 0) return err;
  ccl_union_find<<<g, UF_THREADS, uf_smem, st>>>(
      static_cast<const uint8_t*>(valid), n, nw, static_cast<const uint32_t*>(bits), in_smem,
      static_cast<int*>(parent), static_cast<int*>(roots));
  return static_cast<int>(cudaGetLastError());
}
