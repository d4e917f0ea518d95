// Class sums on Hopper (sm_90a):
//
//   csum[k, b, h] = Σ_r clause[k, b, r] · w[k, h, r]       (int32)
//
// Replaces repro/kernels/class_sum.py: class_sum (the Pallas MXU block
// product with an int32 accumulator carried across the clause grid axis).
// k is the program axis of a bank (blockIdx.y, one stride per operand).
// Weights reach ±2047 and R <= 4224 at the paper's models, so int32
// cannot overflow.  PyTorch has no int32 matmul on the card, and the sums
// must be exact.
//
// Bound: device-memory bytes.  Each clause value meets at most H <= 16
// weights, far below the card's operations-per-byte balance.  Design: one
// block per (program, 4 batch rows); its threads stride over the clause
// axis with coalesced loads of the clause rows and the weight rows, keep
// 4 × 16 partial sums in registers, and reduce them with warp shuffles
// and one pass through shared memory.  The weights of a program are read
// once per group of 4 batch rows (from L2 after the first).  H > 16 is
// handled in chunks of 16 classes.
#include "common.cuh"

namespace {

constexpr int kRows = 4;       // batch rows per block
constexpr int kClasses = 16;   // classes per pass
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
class_sum_kernel(const int32_t* __restrict__ cl, const int32_t* __restrict__ w,
                 int32_t* __restrict__ out, int B, int R, int H,
                 long long cl_sk, long long w_sk, long long out_sk) {
  __shared__ int32_t s_part[kWarps][kRows * kClasses];
  const int k = blockIdx.y;
  const int b0 = blockIdx.x * kRows;
  const int nb = min(kRows, B - b0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int32_t* cl_k = cl + k * cl_sk + static_cast<long long>(b0) * R;
  const int32_t* w_k = w + k * w_sk;
  int32_t* out_k = out + k * out_sk + static_cast<long long>(b0) * H;

  for (int h0 = 0; h0 < H; h0 += kClasses) {
    const int nh = min(kClasses, H - h0);
    int32_t acc[kRows][kClasses];
#pragma unroll
    for (int b = 0; b < kRows; ++b)
#pragma unroll
      for (int h = 0; h < kClasses; ++h) acc[b][h] = 0;

    for (int r = threadIdx.x; r < R; r += kThreads) {
      int32_t c[kRows];
#pragma unroll
      for (int b = 0; b < kRows; ++b)
        c[b] = (b < nb) ? __ldg(cl_k + static_cast<long long>(b) * R + r) : 0;
#pragma unroll
      for (int h = 0; h < kClasses; ++h) {
        if (h < nh) {
          const int32_t wv = __ldg(w_k + static_cast<long long>(h0 + h) * R + r);
#pragma unroll
          for (int b = 0; b < kRows; ++b) acc[b][h] += c[b] * wv;
        }
      }
    }

#pragma unroll
    for (int b = 0; b < kRows; ++b)
#pragma unroll
      for (int h = 0; h < kClasses; ++h) {
        const int32_t v = dtm_warp_sum(acc[b][h]);
        if (lane == 0) s_part[warp][b * kClasses + h] = v;
      }
    __syncthreads();
    if (threadIdx.x < kRows * kClasses) {
      const int b = threadIdx.x / kClasses, h = threadIdx.x % kClasses;
      int32_t s = 0;
#pragma unroll
      for (int i = 0; i < kWarps; ++i) s += s_part[i][threadIdx.x];
      if (b < nb && h < nh) out_k[static_cast<long long>(b) * H + h0 + h] = s;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int dtm_class_sum(const void* cl, const void* w, void* out,
                             int K, int B, int R, int H,
                             long long cl_sk, long long w_sk, long long out_sk,
                             void* stream) {
  const dim3 grid((B + kRows - 1) / kRows, K);
  class_sum_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cl), static_cast<const int32_t*>(w),
      static_cast<int32_t*>(out), B, R, H, cl_sk, w_sk, out_sk);
  return static_cast<int>(cudaGetLastError());
}
