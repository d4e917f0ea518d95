// Fused training-step front half on Hopper (sm_90a), one launch:
//
//   clause[k, b, r] = (OR_w inc[k, r, w] & ~lit[k, b, w] == 0) · cl_mask[k, r]
//   sums[k, b, h]   = Σ_r clause · w[k, h, r], padded classes -> NEG_INF_SUM
//   sel_y[k, b, r]  = rand[k, y, b, r]·2T < (T ∓ clip(sums[b, cls_y], −T, T)) << rand_bits
//                     and cl_mask[k, r] and (w[k, cls_y, r] != 0 unless w_frozen == 0)
//   for the target round (y = 0, cls = labels, minus) and the negated round
//   (y = 1, cls = neg, plus).  Training-mode clause semantics: an empty
//   clause fires.  Include bits at positions >= n_bits are masked on load.
//
// Replaces repro/kernels/fused_step.py: fused_step (the Pallas kernel with a
// sequential clause grid axis carrying the class sums in VMEM scratch).
// It takes the engine's packed operands (32 literals per word) instead of
// the unpacked int8 [B, L] / [R, L] pair; the outputs are the same.
//
// Bound: at the main path's shapes (K=1, B=32, R=2048, W=52, H=16) about
// 1.9 MB of device memory (random words, weights, include bitplane, three
// [B, R] outputs) against ~9 M integer operations: both ~0.5 µs, so the
// kernel is launch-bound.  Design: the selection needs each batch row's
// complete class sums, which depend on all R clauses, and blocks run in
// no order (the TPU carried them along a sequential grid axis).  So the
// grid is (clause chunk, batch tile, program): a block evaluates kChunk
// clause rows for kRows batch rows (one warp per clause row, lanes over
// words, a warp-shuffle OR), sums their class votes in shared memory and
// adds them to a zeroed int32 scratch in device memory with integer
// atomics (exact, order-independent).  The last block of a batch tile to
// finish (a zeroed counter, __threadfence, atomicAdd) pins the sums and
// runs both selection rounds over all R with coalesced loads.  T and
// w_frozen are read per program from device memory, so a program swap or
// a bank never needs the host.
#include "common.cuh"

namespace {

constexpr int kRows = 4;       // batch rows per block
constexpr int kChunk = 128;    // clause rows per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int32_t kNegInfSum = -(1 << 24);

__global__ void __launch_bounds__(kThreads)
fused_step_kernel(const uint32_t* __restrict__ lit, const uint32_t* __restrict__ inc,
                  const int32_t* __restrict__ w, const int32_t* __restrict__ labels,
                  const int32_t* __restrict__ neg, const int32_t* __restrict__ rand,
                  const int32_t* __restrict__ cl_mask, const int32_t* __restrict__ h_mask,
                  const int32_t* __restrict__ T_k, const int32_t* __restrict__ frozen_k,
                  int32_t* __restrict__ clause, int32_t* __restrict__ sums,
                  int32_t* __restrict__ sel_lab, int32_t* __restrict__ sel_neg,
                  int32_t* __restrict__ acc, unsigned int* __restrict__ done,
                  int B, int R, int W, int H, int n_bits, int rand_bits) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* s_lit = smem;                                           // [kRows][W]
  int32_t* s_sum = reinterpret_cast<int32_t*>(smem + kRows * W);    // [kRows][H]
  __shared__ bool s_last;
  const int k = blockIdx.z;
  const int bt = blockIdx.y;
  const int b0 = bt * kRows;
  const int nb = min(kRows, B - b0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long kB = static_cast<long long>(k) * B;

  const uint32_t* lit_k = lit + (kB + b0) * W;
  for (int i = threadIdx.x; i < kRows * W; i += kThreads)
    s_lit[i] = (i / W < nb) ? lit_k[i] : 0xffffffffu;
  for (int i = threadIdx.x; i < kRows * H; i += kThreads) s_sum[i] = 0;
  __syncthreads();

  const uint32_t* inc_k = inc + static_cast<long long>(k) * R * W;
  const int32_t* w_k = w + static_cast<long long>(k) * H * R;
  const int32_t* clm_k = cl_mask + static_cast<long long>(k) * R;
  int32_t* clause_k = clause + (kB + b0) * R;

  // phase 1: this block's clause rows, one warp each; votes into shared memory
  const int r_end = min(R, (blockIdx.x + 1) * kChunk);
  for (int r = blockIdx.x * kChunk + warp; r < r_end; r += kWarps) {
    const uint32_t* row = inc_k + static_cast<long long>(r) * W;
    uint32_t v[kRows];
#pragma unroll
    for (int b = 0; b < kRows; ++b) v[b] = 0u;
    for (int q = lane; q < W; q += 32) {
      const uint32_t i = __ldg(row + q) & dtm_tail_mask(q, n_bits);
#pragma unroll
      for (int b = 0; b < kRows; ++b) v[b] |= i & ~s_lit[b * W + q];
    }
    const bool real = __ldg(clm_k + r) != 0;
    int fired[kRows];
#pragma unroll
    for (int b = 0; b < kRows; ++b) fired[b] = (dtm_warp_or(v[b]) == 0u && real) ? 1 : 0;
    if (lane < nb) {
      int mine = fired[0];
#pragma unroll
      for (int b = 1; b < kRows; ++b)
        if (lane == b) mine = fired[b];
      clause_k[static_cast<long long>(lane) * R + r] = mine;
    }
    for (int h = lane; h < H; h += 32) {
      const int32_t wv = __ldg(w_k + static_cast<long long>(h) * R + r);
#pragma unroll
      for (int b = 0; b < kRows; ++b)
        if (fired[b] && b < nb) atomicAdd(&s_sum[b * H + h], wv);
    }
  }
  __syncthreads();
  int32_t* acc_t = acc + (kB + b0) * H;
  for (int i = threadIdx.x; i < nb * H; i += kThreads)
    if (s_sum[i] != 0) atomicAdd(&acc_t[i], s_sum[i]);

  // the last block of this batch tile to finish goes on to select
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(&done[static_cast<long long>(k) * gridDim.y + bt], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // phase 2: pin padded classes, write the sums
  const int32_t* hm_k = h_mask + static_cast<long long>(k) * H;
  for (int i = threadIdx.x; i < kRows * H; i += kThreads) {
    const int b = i / H, h = i % H;
    int32_t v = (b < nb) ? __ldcg(acc_t + i) : 0;
    if (__ldg(hm_k + h) <= 0) v = kNegInfSum;
    s_sum[i] = v;
    if (b < nb) sums[(kB + b0 + b) * H + h] = v;
  }
  __syncthreads();

  // phase 3: Alg-3 selection for both rounds (int32 wrap-around
  // arithmetic, as the reference computes it)
  const int32_t T = __ldg(T_k + k);
  const bool frozen = __ldg(frozen_k + k) > 0;
  const int32_t two_t = static_cast<int32_t>(2u * static_cast<uint32_t>(T));
  for (int y = 0; y < 2; ++y) {
    const int32_t* cls_k = (y == 0 ? labels : neg) + kB + b0;
    int32_t* out_k = (y == 0 ? sel_lab : sel_neg) + (kB + b0) * R;
    const int32_t* rand_k = rand + ((static_cast<long long>(k) * 2 + y) * B + b0) * R;
    for (int b = 0; b < nb; ++b) {
      const int cls = min(max(__ldg(cls_k + b), 0), H - 1);
      const int32_t cs = min(max(s_sum[b * H + cls], -T), T);
      const int32_t p_num = (y == 0) ? T - cs : T + cs;
      const int32_t rhs = static_cast<int32_t>(static_cast<uint32_t>(p_num) << rand_bits);
      const int32_t* w_row = w_k + static_cast<long long>(cls) * R;
      for (int r = threadIdx.x; r < R; r += kThreads) {
        const uint32_t rv = static_cast<uint32_t>(__ldg(rand_k + static_cast<long long>(b) * R + r));
        const int32_t lhs = static_cast<int32_t>(rv * static_cast<uint32_t>(two_t));
        const bool elig = !frozen || __ldg(w_row + r) != 0;
        out_k[static_cast<long long>(b) * R + r] =
            (lhs < rhs && __ldg(clm_k + r) > 0 && elig) ? 1 : 0;
      }
    }
  }
}

}  // namespace

extern "C" size_t dtm_fused_step_smem(int W, int H) {
  return sizeof(uint32_t) * kRows * W + sizeof(int32_t) * kRows * H;
}

// Scratch: acc int32 [K, B, H] and done uint32 [K, ceil(B / 4)], both
// zeroed by the caller before every launch.
extern "C" int dtm_fused_step(const void* lit, const void* inc, const void* w,
                              const void* labels, const void* neg, const void* rand,
                              const void* cl_mask, const void* h_mask,
                              const void* T, const void* w_frozen,
                              void* clause, void* sums, void* sel_lab, void* sel_neg,
                              void* acc, void* done,
                              int K, int B, int R, int W, int H, int n_bits,
                              int rand_bits, void* stream) {
  const dim3 grid((R + kChunk - 1) / kChunk, (B + kRows - 1) / kRows, K);
  fused_step_kernel<<<grid, kThreads, dtm_fused_step_smem(W, H),
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(lit), static_cast<const uint32_t*>(inc),
      static_cast<const int32_t*>(w), static_cast<const int32_t*>(labels),
      static_cast<const int32_t*>(neg), static_cast<const int32_t*>(rand),
      static_cast<const int32_t*>(cl_mask), static_cast<const int32_t*>(h_mask),
      static_cast<const int32_t*>(T), static_cast<const int32_t*>(w_frozen),
      static_cast<int32_t*>(clause), static_cast<int32_t*>(sums),
      static_cast<int32_t*>(sel_lab), static_cast<int32_t*>(sel_neg),
      static_cast<int32_t*>(acc), static_cast<unsigned int*>(done),
      B, R, W, H, n_bits, rand_bits);
  return static_cast<int>(cudaGetLastError());
}
