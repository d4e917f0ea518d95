// Packed clause evaluation on Hopper (sm_90a): two kernels, one function.
//
//   clause[k, b, r] = OR_w(inc[k, r, w] & ~lit[k, b, w]) == 0
//                     and, in eval mode, OR_w inc[k, r, w] != 0
//
// Operands are 32-literal words (uint32 bit patterns; PyTorch hands them
// over as int32).  k is the program axis of a bank (blockIdx.z, one stride
// per operand), so K tenants are served by one launch.  Ragged B, R and W
// are masked here; include bits at positions >= n_bits are masked on load.
//
// packed_clause_edge replaces repro/kernels/packed_clause.py:
// packed_clause_eval (the Pallas VPU word-OR kernel), used for B <= 4.
//   Bound: device-memory bytes.  At B <= 4 every include word is used by at
//   most four AND-NOTs, so the kernel is a GEMV that streams the [R, W]
//   include bitplane once.  Design: one warp per clause row, each lane
//   loading 16-byte chunks of the row (coalesced, read-only path); the
//   <= 4 literal rows sit in shared memory; the per-lane OR is reduced
//   with warp shuffles.  No early exit on all-zero words.
//
// packed_clause_tile replaces repro/kernels/packed_clause.py:
// packed_clause_eval_mxu (the Pallas popcount-as-matmul kernel on the MXU),
// used for B > 4.
//   Bound: at the serving shapes (K=4, B=32, R=4224, W=100) device-memory
//   bytes (6.8 MB include + 2.2 MB clause output) against ~54 M word
//   operations.  Design: a GEMM-shaped tile of 32 batch rows × 64 clause
//   rows per block; include and literal words are staged in shared memory
//   32 words at a time, so each include word is read from device memory
//   once per block and reused by 32 batch rows.  Each word pair costs one
//   AND-NOT-OR (a LOP3) instead of the MXU's popcount; the output is the
//   same because only viol == 0 matters.  The literal rows are read as
//   16-byte shared-memory broadcasts.  Later step: tensor-core tiles with
//   mma.sync .b1.and.popc compute the same popcount-as-matmul at the
//   tensor-core rate.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kEdgeRows = 4;    // batch rows per block: the edge regime
constexpr int kEdgeWarps = 8;   // clause rows in flight per block

template <bool kVec>
__global__ void __launch_bounds__(kEdgeWarps * 32)
packed_clause_edge(const uint32_t* __restrict__ lit, const uint32_t* __restrict__ inc,
                   int32_t* __restrict__ out, int B, int R, int W,
                   long long lit_sk, long long inc_sk, long long out_sk,
                   int n_bits, int eval_mode) {
  extern __shared__ __align__(16) uint32_t s_lit[];  // [kEdgeRows][W]
  const int k = blockIdx.z;
  const int b0 = blockIdx.y * kEdgeRows;
  const int nb = min(kEdgeRows, B - b0);
  const uint32_t* lit_k = lit + k * lit_sk + static_cast<long long>(b0) * W;
  for (int i = threadIdx.x; i < kEdgeRows * W; i += blockDim.x)
    s_lit[i] = (i / W < nb) ? lit_k[i] : 0xffffffffu;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t* inc_k = inc + k * inc_sk;
  int32_t* out_k = out + k * out_sk + static_cast<long long>(b0) * R;
  for (int r = blockIdx.x * kEdgeWarps + warp; r < R; r += gridDim.x * kEdgeWarps) {
    const uint32_t* row = inc_k + static_cast<long long>(r) * W;
    uint32_t v[kEdgeRows];
#pragma unroll
    for (int b = 0; b < kEdgeRows; ++b) v[b] = 0u;
    uint32_t ne = 0u;
    if (kVec) {
      const int w4 = W >> 2;
      for (int q = lane; q < w4; q += 32) {
        const uint4 c = __ldg(reinterpret_cast<const uint4*>(row) + q);
        const uint32_t i0 = c.x & dtm_tail_mask(4 * q, n_bits);
        const uint32_t i1 = c.y & dtm_tail_mask(4 * q + 1, n_bits);
        const uint32_t i2 = c.z & dtm_tail_mask(4 * q + 2, n_bits);
        const uint32_t i3 = c.w & dtm_tail_mask(4 * q + 3, n_bits);
        ne |= i0 | i1 | i2 | i3;
#pragma unroll
        for (int b = 0; b < kEdgeRows; ++b) {
          const uint4 l = reinterpret_cast<const uint4*>(s_lit + b * W)[q];
          v[b] |= (i0 & ~l.x) | (i1 & ~l.y) | (i2 & ~l.z) | (i3 & ~l.w);
        }
      }
    } else {
      for (int w = lane; w < W; w += 32) {
        const uint32_t i = __ldg(row + w) & dtm_tail_mask(w, n_bits);
        ne |= i;
#pragma unroll
        for (int b = 0; b < kEdgeRows; ++b) v[b] |= i & ~s_lit[b * W + w];
      }
    }
    ne = dtm_warp_or(ne);
#pragma unroll
    for (int b = 0; b < kEdgeRows; ++b) v[b] = dtm_warp_or(v[b]);
    if (lane < nb) {
      uint32_t mine = v[0];  // v[lane] without dynamic register indexing
#pragma unroll
      for (int b = 1; b < kEdgeRows; ++b)
        if (lane == b) mine = v[b];
      out_k[static_cast<long long>(lane) * R + r] =
          (mine == 0u && (!eval_mode || ne != 0u)) ? 1 : 0;
    }
  }
}

constexpr int kTileB = 32;        // batch rows per block
constexpr int kTileR = 64;        // clause rows per block
constexpr int kTileW = 32;        // words staged per step
constexpr int kTileThreads = 256;
constexpr int kRowsPerThread = kTileB / (kTileThreads / kTileR);  // 8

__global__ void __launch_bounds__(kTileThreads)
packed_clause_tile(const uint32_t* __restrict__ lit, const uint32_t* __restrict__ inc,
                   int32_t* __restrict__ out, int B, int R, int W,
                   long long lit_sk, long long inc_sk, long long out_sk,
                   int n_bits, int eval_mode) {
  __shared__ uint32_t s_inc[kTileR][kTileW + 1];          // +1: conflict-free column reads
  __shared__ __align__(16) uint32_t s_lit[kTileB][kTileW];  // read as broadcasts
  const int k = blockIdx.z;
  const int r0 = blockIdx.x * kTileR;
  const int b0 = blockIdx.y * kTileB;
  const int tid = threadIdx.x;
  const int rl = tid % kTileR;
  const int bg = tid / kTileR;  // warp-uniform: kTileR is a multiple of 32
  const uint32_t* inc_k = inc + k * inc_sk;
  const uint32_t* lit_k = lit + k * lit_sk;

  uint32_t viol[kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) viol[j] = 0u;
  uint32_t ne = 0u;

  for (int w0 = 0; w0 < W; w0 += kTileW) {
    for (int i = tid; i < kTileR * kTileW; i += kTileThreads) {
      const int rr = i / kTileW, ww = i % kTileW;
      const int r = r0 + rr, w = w0 + ww;
      s_inc[rr][ww] = (r < R && w < W)
          ? (__ldg(inc_k + static_cast<long long>(r) * W + w) & dtm_tail_mask(w, n_bits))
          : 0u;
    }
    for (int i = tid; i < kTileB * kTileW; i += kTileThreads) {
      const int bb = i / kTileW, ww = i % kTileW;
      const int b = b0 + bb, w = w0 + ww;
      s_lit[bb][ww] = (b < B && w < W) ? __ldg(lit_k + static_cast<long long>(b) * W + w) : 0u;
    }
    __syncthreads();
#pragma unroll
    for (int ww = 0; ww < kTileW; ww += 4) {
      const uint32_t i0 = s_inc[rl][ww], i1 = s_inc[rl][ww + 1];
      const uint32_t i2 = s_inc[rl][ww + 2], i3 = s_inc[rl][ww + 3];
      ne |= i0 | i1 | i2 | i3;
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        const uint4 l = *reinterpret_cast<const uint4*>(&s_lit[bg * kRowsPerThread + j][ww]);
        viol[j] |= (i0 & ~l.x) | (i1 & ~l.y) | (i2 & ~l.z) | (i3 & ~l.w);
      }
    }
    __syncthreads();
  }

  const int r = r0 + rl;
  if (r < R) {
    const bool gate = !eval_mode || ne != 0u;
    int32_t* out_k = out + k * out_sk;
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const int b = b0 + bg * kRowsPerThread + j;
      if (b < B) out_k[static_cast<long long>(b) * R + r] = (viol[j] == 0u && gate) ? 1 : 0;
    }
  }
}

}  // namespace

extern "C" int dtm_packed_clause_edge(const void* lit, const void* inc, void* out,
                                      int K, int B, int R, int W,
                                      long long lit_sk, long long inc_sk, long long out_sk,
                                      int n_bits, int eval_mode, void* stream) {
  const dim3 grid(std::min((R + kEdgeWarps - 1) / kEdgeWarps, 65535),
                  (B + kEdgeRows - 1) / kEdgeRows, K);
  const size_t smem = sizeof(uint32_t) * kEdgeRows * W;
  const bool vec = (W % 4 == 0) && (inc_sk % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(inc) % 16 == 0);
  const auto* l = static_cast<const uint32_t*>(lit);
  const auto* i = static_cast<const uint32_t*>(inc);
  auto* o = static_cast<int32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (vec)
    packed_clause_edge<true><<<grid, kEdgeWarps * 32, smem, s>>>(
        l, i, o, B, R, W, lit_sk, inc_sk, out_sk, n_bits, eval_mode);
  else
    packed_clause_edge<false><<<grid, kEdgeWarps * 32, smem, s>>>(
        l, i, o, B, R, W, lit_sk, inc_sk, out_sk, n_bits, eval_mode);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dtm_packed_clause_tile(const void* lit, const void* inc, void* out,
                                      int K, int B, int R, int W,
                                      long long lit_sk, long long inc_sk, long long out_sk,
                                      int n_bits, int eval_mode, void* stream) {
  const dim3 grid((R + kTileR - 1) / kTileR, (B + kTileB - 1) / kTileB, K);
  packed_clause_tile<<<grid, kTileThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(lit), static_cast<const uint32_t*>(inc),
      static_cast<int32_t*>(out), B, R, W, lit_sk, inc_sk, out_sk, n_bits, eval_mode);
  return static_cast<int>(cudaGetLastError());
}
