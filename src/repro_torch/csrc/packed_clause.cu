// Packed clause evaluation on Hopper (sm_90a): two kernels, one function
// (and b1_mma_probe, which times the tensor cores' single-bit product).
//
//   clause[k, b, r] = OR_w(inc[k, r, w] & ~lit[k, b, w]) == 0
//                     and, in eval mode, OR_w inc[k, r, w] != 0
//
// Operands are 32-literal words (uint32 bit patterns; PyTorch hands them
// over as int32).  k is the program axis of a bank (blockIdx.z, one stride
// per operand), so K tenants are served by one launch.  Ragged B, R and W
// are masked here; include bits at positions >= n_bits are masked.
//
// packed_clause_edge replaces repro/kernels/packed_clause.py:
// packed_clause_eval (the Pallas VPU word-OR kernel), used for B <= 4.
//   Bound: device-memory bytes.  At B <= 4 every include word is used by at
//   most four AND-NOTs, so the kernel is a GEMV that streams the [R, W]
//   include bitplane once (1.7 MB at the serving edge shape, 0.4 MB in
//   edge training).  At these sizes a call lasts a few microseconds, so
//   what costs is each serial memory round trip, not the bytes.
//   Design: G lanes per clause row (kernels/packed_clause.py edge_geometry:
//   the fewest that leave each lane at most kEdgeChunks 16-byte chunks of
//   the row), 32 / G rows per warp.  Each lane issues all of its include
//   loads and the matching literal words together (read-only path, the
//   literal rows straight from global memory: every warp reads the same
//   <= 4 W words, so they come from L1), then reduces: one round trip and
//   no block barrier.  Out-of-range chunks and rows load clamped addresses
//   instead of branching (a repeated word cannot change an OR; a clamped
//   row stores nothing).  Templated on NB, the live batch rows of a block:
//   B = 1 carries one violation accumulator and the nonempty OR.  The OR
//   over a row's G lanes is a log2 G shuffle tree; a warp's rows store
//   side by side, one coalesced store per batch row.  Rows wider than
//   G * kEdgeChunks chunks (W > 512 at G = 32) take passes of that width.
//   16-byte loads when W, both program strides and both bases allow them,
//   else each chunk is four 4-byte loads.
//
// packed_clause_tile replaces repro/kernels/packed_clause.py:
// packed_clause_eval_mxu (the Pallas popcount-as-matmul kernel on the MXU),
// used for B > 4.
//   Bound: at the serving shapes (K=4, B=32, R=4224, W=100) device-memory
//   bytes (6.8 MB include + 2.2 MB clause output); as one LOP3 per word
//   pair the work would take longer still (~54 M operations), so the
//   violation counts go to the tensor cores instead.
//   Design: the count Σ_w popc(inc & ~lit) is exactly what
//   mma.m16n8k256 .b1 .and.popc computes, with A = 16 include rows × 256
//   bits, B = 256 bits × 8 negated literal rows and s32 counts; the count
//   does not depend on bit order, so the packed words go into the
//   fragments as they are (a k-step is 8 words).  A block owns 32 batch
//   rows (4 n-tiles) and 16 clause rows per warp (1, 2 or 4 warps, chosen
//   by the wrapper so that about two blocks run per SM).  Include and
//   literal rows stream through a 4-stage cp.async ring of 32 words a row
//   (16-byte copies when W, the program strides and the pointers allow,
//   else 4-byte copies), rows padded to 36 words so the fragment loads
//   are conflict-free; one block barrier a stage.  Words past W read as
//   zero and k-steps past W are skipped, so only the last k-step carries
//   padding.  Include bits past n_bits are masked in the A fragments of
//   the k-steps that reach past n_bits; the eval-mode nonempty gate ORs
//   the (masked) A fragments.  The epilogue writes count == 0 && gate
//   from the C fragments: 8 neighbouring clause rows per batch row, one
//   32-byte sector per store.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kEdgeRows = 4;       // batch rows per block at most
constexpr int kEdgeChunks = 4;     // 16-byte chunks a lane loads per pass
constexpr int kEdgeMaxWarps = 4;

// Words 4q .. 4q + 3 of a row of W words (q < ceil(W / 4)); on the 4-byte
// path words past W repeat word W - 1 (the tail mask zeroes their include).
template <bool kVec>
__device__ __forceinline__ uint4 edge_chunk(const uint32_t* row, int q, int W) {
  if (kVec) return __ldg(reinterpret_cast<const uint4*>(row) + q);
  const int w = 4 * q, last = W - 1;
  return make_uint4(__ldg(row + w), __ldg(row + min(w + 1, last)),
                    __ldg(row + min(w + 2, last)), __ldg(row + min(w + 3, last)));
}

// One block of clause rows for NB batch rows.  lit_b: the first of the NB
// literal rows, inc_k and out_b: the program's include and the first batch
// row's outputs.
template <bool kVec, int NB>
__device__ __forceinline__ void edge_rows(const uint32_t* __restrict__ lit_b,
                                          const uint32_t* __restrict__ inc_k,
                                          int32_t* __restrict__ out_b, int R, int W,
                                          int n_bits, int eval_mode, int lanes) {
  const int lane = threadIdx.x & 31;
  const int sub = lane & (lanes - 1);                      // lane within the row
  const int log_lanes = __ffs(lanes) - 1;
  const int r = ((blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) << (5 - log_lanes)) +
                (lane >> log_lanes);
  const uint32_t* row = inc_k + static_cast<long long>(min(r, R - 1)) * W;
  const int nq = (W + 3) >> 2;                             // chunks a row
  uint32_t v[NB], ne = 0u;
#pragma unroll
  for (int b = 0; b < NB; ++b) v[b] = 0u;
  for (int q0 = 0; q0 < nq; q0 += lanes * kEdgeChunks) {
    int q[kEdgeChunks];
    uint4 ic[kEdgeChunks], lc[NB][kEdgeChunks];
#pragma unroll
    for (int j = 0; j < kEdgeChunks; ++j) {                // every load first
      q[j] = min(q0 + sub + j * lanes, nq - 1);
      ic[j] = edge_chunk<kVec>(row, q[j], W);
#pragma unroll
      for (int b = 0; b < NB; ++b) lc[b][j] = edge_chunk<kVec>(lit_b + b * W, q[j], W);
    }
#pragma unroll
    for (int j = 0; j < kEdgeChunks; ++j) {
      uint4 c = ic[j];
      if (32 * (4 * q[j] + 4) > n_bits) {                  // a chunk reaching past n_bits
        c.x &= dtm_tail_mask(4 * q[j], n_bits);
        c.y &= dtm_tail_mask(4 * q[j] + 1, n_bits);
        c.z &= dtm_tail_mask(4 * q[j] + 2, n_bits);
        c.w &= dtm_tail_mask(4 * q[j] + 3, n_bits);
      }
      ne |= c.x | c.y | c.z | c.w;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const uint4 l = lc[b][j];
        v[b] |= (c.x & ~l.x) | (c.y & ~l.y) | (c.z & ~l.z) | (c.w & ~l.w);
      }
    }
  }
  for (int off = lanes >> 1; off > 0; off >>= 1) {         // the row's lanes
    ne |= __shfl_xor_sync(0xffffffffu, ne, off);
#pragma unroll
    for (int b = 0; b < NB; ++b) v[b] |= __shfl_xor_sync(0xffffffffu, v[b], off);
  }
  if (r >= R) return;
  const bool gate = !eval_mode || ne != 0u;
#pragma unroll
  for (int b = 0; b < NB; ++b)
    if ((b & (lanes - 1)) == sub)
      out_b[static_cast<long long>(b) * R + r] = (v[b] == 0u && gate) ? 1 : 0;
}

// Block (blockIdx.x: 32 / lanes · warps clause rows, blockIdx.y: a group of
// up to kEdgeRows batch rows, blockIdx.z: program).  kMaxNB = min(B, 4):
// at B <= 4 the one group has NB = B; past 4 the last group takes its own.
template <bool kVec, int kMaxNB>
__global__ void __launch_bounds__(kEdgeMaxWarps * 32)
packed_clause_edge(const uint32_t* __restrict__ lit, const uint32_t* __restrict__ inc,
                   int32_t* __restrict__ out, int B, int R, int W,
                   long long lit_sk, long long inc_sk, long long out_sk,
                   int n_bits, int eval_mode, int lanes) {
  const int k = blockIdx.z;
  const int b0 = blockIdx.y * kEdgeRows;
  const uint32_t* lit_b = lit + k * lit_sk + static_cast<long long>(b0) * W;
  const uint32_t* inc_k = inc + k * inc_sk;
  int32_t* out_b = out + k * out_sk + static_cast<long long>(b0) * R;
  if constexpr (kMaxNB == kEdgeRows) {
    switch (min(kEdgeRows, B - b0)) {
      case 1: edge_rows<kVec, 1>(lit_b, inc_k, out_b, R, W, n_bits, eval_mode, lanes); return;
      case 2: edge_rows<kVec, 2>(lit_b, inc_k, out_b, R, W, n_bits, eval_mode, lanes); return;
      case 3: edge_rows<kVec, 3>(lit_b, inc_k, out_b, R, W, n_bits, eval_mode, lanes); return;
      default: break;
    }
  }
  edge_rows<kVec, kMaxNB>(lit_b, inc_k, out_b, R, W, n_bits, eval_mode, lanes);
}

// ---- packed_clause_tile: .b1 tensor-core tiles --------------------------

constexpr int kTileB = 32;         // batch rows per block: 4 n-tiles of 8
constexpr int kMmaRows = 16;       // clause rows per warp: one m-tile
constexpr int kMaxWarps = 4;
constexpr int kStepWords = 8;      // words per k-step: 256 bits
constexpr int kChunkWords = 32;    // words a row per ring stage: 4 k-steps
constexpr int kRingStages = 4;
constexpr int kRowWords = kChunkWords + 4;   // padded staged row

// d += popc(A & B) over a 256-bit k-step: A 16 × 256 (a[0], a[2]: row g,
// words t and t + 4 of the step; a[1], a[3]: row g + 8), B 256 × 8 (b0, b1:
// column g, words t and t + 4), d[0..1]: row g, columns 2t and 2t + 1;
// d[2..3]: row g + 8 (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void mma_b1(int32_t (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Block (blockIdx.x: clause tile of 16 · warps rows, blockIdx.y: batch
// tile, blockIdx.z: program); blockDim.x = 32 · warps.  Dynamic shared
// memory: kRingStages stages of (16 · warps include rows, then kTileB
// literal rows) × kRowWords words.
template <bool kVec>
__global__ void __launch_bounds__(kMaxWarps * 32)
packed_clause_tile(const uint32_t* __restrict__ lit, const uint32_t* __restrict__ inc,
                   int32_t* __restrict__ out, int B, int R, int W,
                   long long lit_sk, long long inc_sk, long long out_sk,
                   int n_bits, int eval_mode) {
  extern __shared__ __align__(16) uint32_t s_ring[];
  const int rows = kMmaRows * static_cast<int>(blockDim.x >> 5);   // clause rows of the block
  const int srows = rows + kTileB;                                  // staged rows a stage
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int k = blockIdx.z;
  const int r0 = blockIdx.x * rows, b0 = blockIdx.y * kTileB;
  const int ntiles = (min(kTileB, B - b0) + 7) >> 3;   // n-tiles with a real batch row
  const uint32_t* inc_k = inc + k * inc_sk;
  const uint32_t* lit_k = lit + k * lit_sk;
  const int nch = (W + kChunkWords - 1) / kChunkWords;

  // stage chunk ch (words [32 ch, 32 ch + 32) of every staged row) into its
  // slot; words past W, and rows past R or B, read as zero
  auto load = [&](int ch) {
    uint32_t* dst = s_ring + (ch % kRingStages) * srows * kRowWords;
    const int w0 = ch * kChunkWords;
    constexpr int kPer = kVec ? 4 : 1;                  // words a copy
    constexpr int kCopies = kChunkWords / kPer;         // copies a row
    for (int i = threadIdx.x; i < srows * kCopies; i += blockDim.x) {
      const int sr = i / kCopies, w = w0 + kPer * (i % kCopies);
      const bool is_inc = sr < rows;
      const int row = is_inc ? r0 + sr : b0 + sr - rows;
      const bool ok = w < W && row < (is_inc ? R : B);
      const uint32_t* src = ok ? (is_inc ? inc_k : lit_k) + static_cast<long long>(row) * W + w : inc;
      uint32_t* d = dst + sr * kRowWords + (w - w0);
      if (kVec) dtm_cp_async16(d, src, ok ? 16 : 0);
      else dtm_cp_async4(d, src, ok ? 4 : 0);
    }
  };

  int32_t acc[kTileB / 8][4];
#pragma unroll
  for (int n = 0; n < kTileB / 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = 0;
  uint32_t nz_g = 0u, nz_g8 = 0u;   // include words of rows g and g + 8 seen by this lane

#pragma unroll
  for (int s = 0; s < kRingStages - 1; ++s) {
    if (s < nch) load(s);
    dtm_cp_async_commit();
  }
  for (int ch = 0; ch < nch; ++ch) {
    dtm_cp_async_wait<kRingStages - 2>();   // this thread's copies of chunk ch
    __syncthreads();                    // ... and every thread's; slot (ch − 1) is free
    if (ch + kRingStages - 1 < nch) load(ch + kRingStages - 1);
    dtm_cp_async_commit();
    const uint32_t* st = s_ring + (ch % kRingStages) * srows * kRowWords;
    const uint32_t* a_row = st + (warp * kMmaRows + g) * kRowWords + t;
    const uint32_t* b_row = st + (rows + g) * kRowWords + t;
    const int w0 = ch * kChunkWords;
    const int nsteps = min(kChunkWords, W - w0 + kStepWords - 1) / kStepWords;
#pragma unroll
    for (int s = 0; s < kChunkWords / kStepWords; ++s) {
      if (s >= nsteps) break;
      const int o = s * kStepWords;
      uint32_t a[4] = {a_row[o], a_row[o + 8 * kRowWords], a_row[o + 4],
                       a_row[o + 8 * kRowWords + 4]};
      const int w = w0 + o + t;
      if (32 * (w0 + o + kStepWords) > n_bits) {   // a k-step past n_bits
        const uint32_t m0 = dtm_tail_mask(w, n_bits), m1 = dtm_tail_mask(w + 4, n_bits);
        a[0] &= m0;
        a[1] &= m0;
        a[2] &= m1;
        a[3] &= m1;
      }
      nz_g |= a[0] | a[2];
      nz_g8 |= a[1] | a[3];
#pragma unroll
      for (int n = 0; n < kTileB / 8; ++n)
        if (n < ntiles) {
          const uint32_t* b = b_row + 8 * n * kRowWords + o;
          mma_b1(acc[n], a, ~b[0], ~b[4]);
        }
    }
  }

  // a row's nonempty bit is spread over the 4 lanes of its group
  nz_g |= __shfl_xor_sync(0xffffffffu, nz_g, 1);
  nz_g |= __shfl_xor_sync(0xffffffffu, nz_g, 2);
  nz_g8 |= __shfl_xor_sync(0xffffffffu, nz_g8, 1);
  nz_g8 |= __shfl_xor_sync(0xffffffffu, nz_g8, 2);
  const int ra = r0 + warp * kMmaRows + g, rb = ra + 8;
  const bool gate_a = ra < R && (!eval_mode || nz_g != 0u);
  const bool gate_b = rb < R && (!eval_mode || nz_g8 != 0u);
  int32_t* out_k = out + k * out_sk;
#pragma unroll
  for (int n = 0; n < kTileB / 8; ++n) {
    if (n >= ntiles) break;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int b = b0 + 8 * n + 2 * t + j;
      if (b >= B) continue;
      int32_t* o = out_k + static_cast<long long>(b) * R;
      if (ra < R) o[ra] = (acc[n][j] == 0 && gate_a) ? 1 : 0;
      if (rb < R) o[rb] = (acc[n][j + 2] == 0 && gate_b) ? 1 : 0;
    }
  }
}

// The .b1 product's rate: kProbeChains independent chains of back-to-back
// m16n8k256 products a warp (a measurement kernel; nothing else runs it).
constexpr int kProbeChains = 8;

__global__ void b1_mma_probe(int32_t* __restrict__ out, int iters) {
  const uint32_t x = blockIdx.x * blockDim.x + threadIdx.x;
  const uint32_t a[4] = {x * 0x9E3779B9u, ~x, x ^ 0x5A5A5A5Au, x << 7};
  const uint32_t b0 = x ^ 0xF0F0F0F0u, b1 = x * 7u + 1u;
  int32_t acc[kProbeChains][4];
#pragma unroll
  for (int c = 0; c < kProbeChains; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[c][j] = 4 * c + j;   // distinct chains: none is merged
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int c = 0; c < kProbeChains; ++c) mma_b1(acc[c], a, b0, b1);
  int32_t s = 0;
#pragma unroll
  for (int c = 0; c < kProbeChains; ++c) s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  out[x] = s;
}

}  // namespace

// lanes (a power of two up to 32), warps (1 to kEdgeMaxWarps) and
// blocks (clause-row blocks) come from kernels/packed_clause.py
// edge_geometry; blocks · (32 / lanes) · warps >= R.  16-byte loads when W
// and both program strides are multiples of 4 words and both pointers
// 16-byte aligned.
extern "C" int dtm_packed_clause_edge(const void* lit, const void* inc, void* out,
                                      int K, int B, int R, int W,
                                      long long lit_sk, long long inc_sk, long long out_sk,
                                      int n_bits, int eval_mode, int lanes, int warps,
                                      int blocks, void* stream) {
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0 || warps < 1 ||
      warps > kEdgeMaxWarps || static_cast<long long>(blocks) * (32 / lanes) * warps < R)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(blocks, (B + kEdgeRows - 1) / kEdgeRows, K);
  const bool vec = W % 4 == 0 && lit_sk % 4 == 0 && inc_sk % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(lit) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(inc) % 16 == 0;
  using Edge = void (*)(const uint32_t*, const uint32_t*, int32_t*, int, int, int, long long,
                        long long, long long, int, int, int);
  static const Edge kernels[2][kEdgeRows] = {
      {packed_clause_edge<false, 1>, packed_clause_edge<false, 2>,
       packed_clause_edge<false, 3>, packed_clause_edge<false, 4>},
      {packed_clause_edge<true, 1>, packed_clause_edge<true, 2>, packed_clause_edge<true, 3>,
       packed_clause_edge<true, 4>}};
  kernels[vec][std::min(B, kEdgeRows) - 1]<<<grid, 32 * warps, 0,
                                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(lit), static_cast<const uint32_t*>(inc),
      static_cast<int32_t*>(out), B, R, W, lit_sk, inc_sk, out_sk, n_bits, eval_mode, lanes);
  return static_cast<int>(cudaGetLastError());
}

// warps: clause rows per block / 16, 1, 2 or 4 (kernels/packed_clause.py
// tile_warps).  16-byte copies when W and both program strides are
// multiples of 4 words and both pointers 16-byte aligned.
extern "C" int dtm_packed_clause_tile(const void* lit, const void* inc, void* out,
                                      int K, int B, int R, int W,
                                      long long lit_sk, long long inc_sk, long long out_sk,
                                      int n_bits, int eval_mode, int warps, void* stream) {
  if (warps < 1 || warps > kMaxWarps) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = kMmaRows * warps;
  const dim3 grid((R + rows - 1) / rows, (B + kTileB - 1) / kTileB, K);
  const size_t smem = sizeof(uint32_t) * kRingStages * (rows + kTileB) * kRowWords;
  const bool vec = W % 4 == 0 && lit_sk % 4 == 0 && inc_sk % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(lit) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(inc) % 16 == 0;
  auto kernel = vec ? packed_clause_tile<true> : packed_clause_tile<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(lit), static_cast<const uint32_t*>(inc),
      static_cast<int32_t*>(out), B, R, W, lit_sk, inc_sk, out_sk, n_bits, eval_mode);
  return static_cast<int>(cudaGetLastError());
}

// blocks × warps warps, each running kProbeChains chains of iters products
// (out: one int32 a thread).
extern "C" int dtm_b1_mma_probe(void* out, int blocks, int warps, int iters, void* stream) {
  b1_mma_probe<<<blocks, 32 * warps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(out), iters);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dtm_b1_mma_probe_chains() { return kProbeChains; }
